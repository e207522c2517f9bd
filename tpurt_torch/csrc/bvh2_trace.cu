// Binary-BVH closest-hit and any-hit traversal (K6) written for Hopper, one
// thread per ray.
//
// Replaces both Pallas functions of tpurt/kernels/traverse_pallas.py:
// _packet_kernel (the smem and vmem table tiers) and _packet_kernel_hbm
// (the hbm tier), each in its closest-hit (trace_closest_packets) and
// any-hit (trace_any_packets) mode. On the card the three table tiers are
// one kernel, and the two modes are template variants. It computes what
// those kernels compute, not how: the TPU kernels push a 32x32 ray packet
// through the tree behind one scalar stack, order children by the packet's
// mean direction and prefetch node rows by DMA. Here each thread owns its
// ray and its stack.
//
// What bounds it on an H100: the node pops' instructions and divergent
// loads. The rebuild frame's LBVH has one triangle per leaf and a depth
// bound of 49, so a primary ray makes some 32 node pops and 2 triangle
// tests (PERF.md), each pop a dependent load and two slab tests. The
// design cuts the round trips and what each step costs besides its load:
//   * the compact child-pair table nodes2c (engine/convert.compact_bvh2):
//     an internal node's row holds both children's boxes and codes, 64
//     bytes read as four independent 16-byte loads, so a node pop is one
//     memory round trip (over the nodes2 rows it was two: the popped node's
//     meta row for the child ids, then the child rows), and a leaf's code
//     carries its first triangle and count, so a leaf pop loads its
//     triangle rows at once (it was meta row, then triangles);
//   * the entry popped next held in a register: of a node's hit children
//     the nearer is taken at once and only the farther is pushed (pushing
//     both and popping the nearer visits the same entries in the same
//     order); the stack holds 8-byte entries (code, entry distance bits)
//     for the closest hit, codes alone for the any hit, one local array of
//     STACK entries (the wrapper picks the least instantiation that holds
//     kernels/traverse_bvh2.stack_entries(depth2)); a closest-hit entry
//     whose entry distance lies beyond the current hit when popped is
//     dropped without a load;
//   * the slab test's twelve NaN-propagating min/max as one instruction
//     each (bvh8_common.cuh's nmin/nmax: min.NaN / max.NaN) instead of a
//     compare, a NaN test and a select: 0.69-0.75x the time with the
//     selects (PERF.md);
//   * leaves of one triangle (max_leaf 1, the LBVH) run a one-row leaf
//     step; wider leaves load LEAF_BATCH rows before the first test;
//   * when the rays are a frame's pixels (tile_w > 0, the frame's width) a
//     block covers a 16x8 pixel tile, each warp 8x4 pixels, so a warp's
//     rays share their path; rays and outputs stay in pixel order;
//   * min_blocks() blocks of 128 per SM for each instantiation: the most
//     that ptxas fits without spills (tools/ptxas_sweep.py, PERF.md).
//
// Traversal order, shared with the plain version (kernels/traverse_bvh2.py):
// the root's box (nodes2c's header row) is slab-tested and, if hit, taken.
// Taking an internal node slab-tests its two children against tfar (the
// current hit distance, or t_max for any-hit); the key is the child's slab
// entry distance, and on equal keys the left child (the row's first) is the
// nearer. Taking a leaf runs Moller-Trumbore on its first min(count,
// max_leaf) triangles in order with a strict t < tfar, so the first of
// equal distances wins. Any-hit stops at the first hit. A ray with t_max <=
// t_min is never occluded.
//
// Exactness: the slab test and Moller-Trumbore (bvh8_common.cuh)
// keep the operation order of tpurt's _Rays.slab / _Rays.mt
// (traverse_pallas.py:120-158); min/max propagate NaN like jnp.minimum;
// the library is built with --fmad=false. The plain version visits the
// same entries in the same order and gives bit-identical t/tri/u/v/occ.
//
// nodes2c rows (16 f32 lanes): lanes 0-5 the left child's box (min.xyz,
// max.xyz), 6-11 the right child's, 12-13 the two codes as int32 bits;
// row 0 holds the root's box in lanes 0-5 and its code in lane 12. A code
// is the child's row for an internal node, -(first * LEAF_CODE_BASE +
// count) - 1 for a leaf. Triangle rows (convert.pack_tris): v0, e1, e2,
// global id, 0, 0.
#include <type_traits>

#include "bvh8_common.cuh"

#define COMPACT2_FLOATS 16
#define K6_MAX_LEAF 32

namespace {

using namespace bvh8;

// blocks of 128 per SM that ptxas must fit (__launch_bounds__): the most it
// fits without spills, read from tools/ptxas_sweep.py on the H100 build
// (PERF.md): closest hit with one-triangle leaves 10 (47 registers), any
// hit 12 (40), wider leaves 6 (77 and 70). -DK6_MIN_BLOCKS=N sets them all,
// for the sweep.
template <bool ANY_HIT, int LEAF>
constexpr int min_blocks() {
#ifdef K6_MIN_BLOCKS
  return K6_MIN_BLOCKS;
#else
  return LEAF > 1 ? 6 : (ANY_HIT ? 12 : 10);
#endif
}

// the 16 lanes of nodes2c row `row` as four independent 16-byte loads
// through the read-only path
__device__ __forceinline__ void load_row2(const float* __restrict__ nodes2c,
                                          int row, float lanes[16]) {
  const float4* q = reinterpret_cast<const float4*>(
      nodes2c + (size_t)row * COMPACT2_FLOATS);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = __ldg(q + i);
    lanes[4 * i] = v.x;
    lanes[4 * i + 1] = v.y;
    lanes[4 * i + 2] = v.z;
    lanes[4 * i + 3] = v.w;
  }
}

template <bool ANY_HIT, int STACK, int LEAF>
__global__ void __launch_bounds__(TILE_THREADS, (min_blocks<ANY_HIT, LEAF>()))
bvh2_trace_kernel(const float* __restrict__ nodes2c,
                  const float* __restrict__ tris,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction, float t_min,
                  const float* __restrict__ t_max_arr, int n, int max_leaf,
                  int tile_w, float* __restrict__ t_out,
                  int* __restrict__ tri_out, float* __restrict__ u_out,
                  float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
  // closest hit: (code, entry distance bits); any hit: the code
  using Entry = std::conditional_t<ANY_HIT, int, int2>;
  Entry stack[STACK];

  const int ray = tile_ray_index(n, tile_w);
  if (ray < 0) return;
  const Ray r = make_ray(origin[3 * ray], origin[3 * ray + 1],
                         origin[3 * ray + 2], direction + 3 * ray);
  const float t_max0 = t_max_arr[ray];
  float t = t_max0, u = 0.0f, v = 0.0f;
  int tri = -1;
  bool occ = false;

  // the entry taken next (EMPTY_CODE: pop one)
  int code = EMPTY_CODE;
  {
    float lanes[16];
    load_row2(nodes2c, 0, lanes);
    float tn;
    if (slab(lanes, 0, r, t_min, t_max0, &tn))
      code = __float_as_int(lanes[12]);
  }
  int sp = 0;
  while (true) {
    if (code == EMPTY_CODE) {
      if (sp == 0) break;
      if constexpr (ANY_HIT) {
        code = stack[--sp];
      } else {
        const int2 e = stack[--sp];
        // the entry's box was entered at this distance; a closer hit found
        // since makes the parent's slab test fail for it now
        if (!(__int_as_float(e.y) <= t)) continue;
        code = e.x;
      }
    }
    if (code >= 0) {
      float lanes[16];
      load_row2(nodes2c, code, lanes);
      const float tfar = ANY_HIT ? t_max0 : t;
      float k0, k1;
      const bool h0 = slab(lanes, 0, r, t_min, tfar, &k0);
      const bool h1 = slab(lanes, 1, r, t_min, tfar, &k1);
      const int c0 = __float_as_int(lanes[12]);
      const int c1 = __float_as_int(lanes[13]);
      // left is the nearer on equal keys
      const bool left = k0 <= k1;
      const bool hn = left ? h0 : h1, hf = left ? h1 : h0;
      const int cn = left ? c0 : c1, cf = left ? c1 : c0;
      if (hn && hf) {
        if constexpr (ANY_HIT) {
          stack[sp++] = cf;
        } else {
          stack[sp++] = make_int2(cf, __float_as_int(left ? k1 : k0));
        }
      }
      code = hn ? cn : (hf ? cf : EMPTY_CODE);
      continue;
    }
    int first, count;
    leaf_range(code, &first, &count);
    code = EMPTY_CODE;
    const int last = first + min(count, max_leaf) - 1;
    for (int j = first; j <= last; j += LEAF) {
      Tri q[LEAF];
#pragma unroll
      for (int b = 0; b < LEAF; ++b) q[b] = load_tri(tris, min(j + b, last));
#pragma unroll
      for (int b = 0; b < LEAF; ++b) {
        float tk, uk, vk;
        if (j + b <= last &&
            moller_trumbore(q[b], r, t_min, ANY_HIT ? t_max0 : t, &tk, &uk,
                            &vk)) {
          if (ANY_HIT) {
            occ = true;
            break;
          }
          t = tk;
          u = uk;
          v = vk;
          tri = (int)q[b].id;
        }
      }
      if (ANY_HIT && occ) break;
    }
    if (ANY_HIT && occ) break;
  }
  if (ANY_HIT) {
    occ_out[ray] = occ ? 1 : 0;
  } else {
    t_out[ray] = t;
    tri_out[ray] = tri;
    u_out[ray] = u;
    v_out[ray] = v;
  }
}

template <bool ANY_HIT, int STACK, int LEAF>
int launch(const float* nodes2c, const float* tris, const float* origin,
           const float* direction, float t_min, const float* t_max, int n,
           int max_leaf, int tile_w, float* t_out, int* tri_out,
           float* u_out, float* v_out, uint8_t* occ_out, cudaStream_t s) {
  bvh2_trace_kernel<ANY_HIT, STACK, LEAF>
      <<<tile_blocks(n, tile_w), TILE_THREADS, 0, s>>>(
          nodes2c, tris, origin, direction, t_min, t_max, n, max_leaf,
          tile_w, t_out, tri_out, u_out, v_out, occ_out);
  return (int)cudaGetLastError();
}

// the instantiation for a stack size and leaf width (one triangle, or
// LEAF_BATCH rows at a time)
template <bool ANY_HIT, int STACK>
int launch_leaf(const float* nodes2c, const float* tris, const float* origin,
                const float* direction, float t_min, const float* t_max,
                int n, int max_leaf, int tile_w, float* t_out, int* tri_out,
                float* u_out, float* v_out, uint8_t* occ_out,
                cudaStream_t s) {
  if (max_leaf == 1)
    return launch<ANY_HIT, STACK, 1>(nodes2c, tris, origin, direction, t_min,
                                     t_max, n, max_leaf, tile_w, t_out,
                                     tri_out, u_out, v_out, occ_out, s);
  return launch<ANY_HIT, STACK, LEAF_BATCH>(
      nodes2c, tris, origin, direction, t_min, t_max, n, max_leaf, tile_w,
      t_out, tri_out, u_out, v_out, occ_out, s);
}

template <bool ANY_HIT>
int dispatch(const float* nodes2c, const float* tris, const float* origin,
             const float* direction, float t_min, const float* t_max, int n,
             int max_leaf, int stack, int tile_w, float* t_out, int* tri_out,
             float* u_out, float* v_out, uint8_t* occ_out, cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  if (tile_w < 0 || (tile_w > 0 && n % tile_w != 0) || max_leaf < 1 ||
      max_leaf > K6_MAX_LEAF)
    return (int)cudaErrorInvalidValue;
  if (stack == 64)
    return launch_leaf<ANY_HIT, 64>(nodes2c, tris, origin, direction, t_min,
                                    t_max, n, max_leaf, tile_w, t_out,
                                    tri_out, u_out, v_out, occ_out, s);
  if (stack == 192)
    return launch_leaf<ANY_HIT, 192>(nodes2c, tris, origin, direction, t_min,
                                     t_max, n, max_leaf, tile_w, t_out,
                                     tri_out, u_out, v_out, occ_out, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K6 over the compact table nodes2c (R, 16) f32 (codes bit-cast). stack:
// 64 or 192 entries (the wrapper picks it from the tree's depth bound);
// max_leaf 1..32; tile_w: 0 for consecutive rays, else the frame's width
// (n = tile_w * H).
int tpurt_bvh2_closest(const float* nodes2c, const float* tris,
                       const float* origin, const float* direction,
                       float t_min, const float* t_max, int n, int max_leaf,
                       int stack, int tile_w, float* t_out, int* tri_out,
                       float* u_out, float* v_out, cudaStream_t stream) {
  return dispatch<false>(nodes2c, tris, origin, direction, t_min, t_max, n,
                         max_leaf, stack, tile_w, t_out, tri_out, u_out,
                         v_out, nullptr, stream);
}

int tpurt_bvh2_any(const float* nodes2c, const float* tris,
                   const float* origin, const float* direction, float t_min,
                   const float* t_max, int n, int max_leaf, int stack,
                   int tile_w, uint8_t* occ_out, cudaStream_t stream) {
  return dispatch<true>(nodes2c, tris, origin, direction, t_min, t_max, n,
                        max_leaf, stack, tile_w, nullptr, nullptr, nullptr,
                        nullptr, occ_out, stream);
}

}  // extern "C"
