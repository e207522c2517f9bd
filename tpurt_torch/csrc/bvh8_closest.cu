// BVH8 closest-hit traversal written for Hopper, one thread per ray: K1,
// and K7c, the same traversal with the uv payload.
//
// Replaces tpurt/kernels/traverse_bvh8.py::_kernel_bvh8_single with
// any_hit=False (trace_closest_bvh8) at its push order "sort", without (K1)
// and with (K7c) uv_payload=True. It computes what that kernel computes (t,
// tri, u, v of the nearest hit; with the payload also texu, texv, img, texh
// and texw), not how: the TPU kernel walks a 32x32 ray packet behind one
// scalar stack with a Batcher sort on scalars and updates the payload at
// every closer hit; here each thread owns its ray and its stack, and K7c
// reads the payload once, after the traversal.
//
// What bounds it on an H100: divergent, latency-bound loads with little
// arithmetic between them (a node's 8 slab tests, a leaf's triangle tests).
// The design cuts what each step costs besides its loads:
//   * the compact node table nodes8c (bvh8_common.cuh): 224 bytes read as
//     14 16-byte loads, codes precomputed, in two halves (children 0-3,
//     then 4-7), against 288 bytes and 8 float-to-int conversions per pop
//     over the nodes8 rows;
//   * the hit children ordered by (entry distance, slot) with a rank count
//     over static indices: child i goes below every hit child j with a
//     smaller distance, or an equal one and j < i. That is the permutation
//     of a stable insertion sort, so equal distances keep slot order, but
//     keys and codes stay in registers (a sort that indexes them at run
//     time puts them in local memory). The children are pushed far to
//     near, the nearest on top; a miss is never pushed;
//   * a stack of 8-byte entries (code, entry distance bits), STACK of them
//     (the wrapper picks the least instantiation that holds
//     kernels/traverse_bvh8.stack_entries(depth8)), as a local array
//     (cached in L1; the few top entries a ray uses stay hot); an entry
//     whose entry distance lies beyond the current hit when popped is
//     dropped without a fetch;
//   * a leaf's triangles LEAF_BATCH at a time, their rows loaded before the
//     first test, then the strict-less updates in triangle order, so the
//     first of equal distances still wins.
// When the rays are a frame's pixels (tile_w > 0, the frame's width) a
// block covers a 16x8 pixel tile, each warp 8x4 pixels, so a warp's rays
// stay close together and share nodes; rays and outputs stay in pixel
// order.
//
// Bits: the slab test and Moller-Trumbore are bvh8_common.cuh's, tpurt's
// operation order, built with --fmad=false. The visit order is the plain
// version's (kernels/traverse_bvh8.py, compact=True), so t, tri, u and v
// equal it bit for bit, equal-t ties included.
//
// K7c is the PAYLOAD instantiation: the leaf loop also keeps the winner's
// row (its position in BVH leaf order), and after the traversal the kernel
// reads that row of the (T, 9) uvp table (three corner uvs, image slot,
// tex_h, tex_w; 36-byte rows, so scalar loads) and writes five planes:
// uv0 * w + uv1 * u + uv2 * v with w = 1 - u - v, the association of
// tpurt's per-update payload (traverse_bvh8.py:457-466) and of the shade
// pass's tex_coord, so all three are bit-equal; 0, 0, 0, 1, 1 on a miss.
// The payload costs 20 bytes written per ray and 36 read per hit; ptxas
// gives both instantiations 80 registers and no spills, and K7c takes
// 1.05x K1's time on the bench frame on an H100 (PERF.md).
#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

// at least 4 blocks per SM (<= 128 registers): 16 warps
template <int STACK, bool PAYLOAD>
__global__ void __launch_bounds__(TILE_THREADS, 4)
bvh8_closest_kernel(const float* __restrict__ nodes8c,
                    const float* __restrict__ tris,
                    const float* __restrict__ uvp,
                    const float* __restrict__ origin,
                    const float* __restrict__ direction, float t_min,
                    const float* __restrict__ t_max_arr, int n, int tile_w,
                    float* __restrict__ t_out, int* __restrict__ tri_out,
                    float* __restrict__ u_out, float* __restrict__ v_out,
                    float* __restrict__ pay_out) {
  int2 stack[STACK];

  const int ray = tile_ray_index(n, tile_w);
  if (ray < 0) return;
  const Ray r = make_ray(origin[3 * ray], origin[3 * ray + 1],
                         origin[3 * ray + 2], direction + 3 * ray);
  float t = t_max_arr[ray], u = 0.0f, v = 0.0f;
  int tri = -1, row = -1;

  stack[0] = make_int2(0, __float_as_int(-INFINITY));
  int sp = 1;
  while (sp > 0) {
    const int2 entry = stack[--sp];
    const int code = entry.x;
    // the entry's box was entered at this distance; a closer hit found
    // since makes the parent's slab test fail for it now
    if (!(__int_as_float(entry.y) <= t)) continue;
    if (code < 0) {
      int first, count;
      leaf_range(code, &first, &count);
      const int last = first + count - 1;
      for (int j = first; j <= last; j += LEAF_BATCH) {
        Tri q[LEAF_BATCH];
#pragma unroll
        for (int b = 0; b < LEAF_BATCH; ++b)
          q[b] = load_tri(tris, min(j + b, last));
#pragma unroll
        for (int b = 0; b < LEAF_BATCH; ++b) {
          float tk, uk, vk;
          if (j + b <= last &&
              moller_trumbore(q[b], r, t_min, t, &tk, &uk, &vk)) {
            t = tk;
            u = uk;
            v = vk;
            tri = (int)q[b].id;
            if (PAYLOAD) row = j + b;
          }
        }
      }
      continue;
    }
    float key[8];
    int child[8];
    bool hit[8];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float b[24];
      int codes[4];
      load_half(nodes8c, code, half, b, codes);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * half + j;
        hit[k] = slab_soa(b, j, r, t_min, t, &key[k]) &&
                 codes[j] != EMPTY_CODE;
        child[k] = codes[j];
      }
    }
    int nh = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) nh += hit[k];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      int rank = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j != i)
          rank += hit[j] && (j < i ? key[j] <= key[i] : key[j] < key[i]);
      }
      if (hit[i])
        stack[sp + nh - 1 - rank] =
            make_int2(child[i], __float_as_int(key[i]));
    }
    sp += nh;
  }
  t_out[ray] = t;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
  if (PAYLOAD) {
    float tu = 0.0f, tv = 0.0f, im = 0.0f, th = 1.0f, tw = 1.0f;
    if (tri >= 0) {
      const float* p = uvp + (size_t)row * 9;
      const float w = 1.0f - u - v;
      tu = __ldg(p) * w + __ldg(p + 2) * u + __ldg(p + 4) * v;
      tv = __ldg(p + 1) * w + __ldg(p + 3) * u + __ldg(p + 5) * v;
      im = __ldg(p + 6);
      th = __ldg(p + 7);
      tw = __ldg(p + 8);
    }
    pay_out[ray] = tu;
    pay_out[n + ray] = tv;
    pay_out[2 * n + ray] = im;
    pay_out[3 * n + ray] = th;
    pay_out[4 * n + ray] = tw;
  }
}

template <bool PAYLOAD>
int launch(int stack_size, const float* nodes8c, const float* tris,
           const float* uvp, const float* origin, const float* direction,
           float t_min, const float* t_max, int n, int tile_w, float* t_out,
           int* tri_out, float* u_out, float* v_out, float* pay_out,
           cudaStream_t stream) {
  if (stack_size != 48 && stack_size != 192)
    return (int)cudaErrorInvalidValue;
  const auto kernel = stack_size == 48 ? bvh8_closest_kernel<48, PAYLOAD>
                                       : bvh8_closest_kernel<192, PAYLOAD>;
  kernel<<<tile_blocks(n, tile_w), TILE_THREADS, 0, stream>>>(
      nodes8c, tris, uvp, origin, direction, t_min, t_max, n, tile_w, t_out,
      tri_out, u_out, v_out, pay_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K1 (uvp null) or K7c: the closest hit of n rays over the compact node
// table (M, 56) f32 (codes bit-cast); K7c also reads the (T, 9) uvp table
// and writes pay_out (5, n) f32: texu, texv, img, texh, texw. stack_size:
// 48 or 192 entries (the wrapper picks it from the tree's depth); tile_w: 0
// for consecutive rays, else the frame's width (n = tile_w * H).
int tpurt_bvh8_closest_compact(const float* nodes8c, const float* tris,
                               const float* uvp, const float* origin,
                               const float* direction, float t_min,
                               const float* t_max, int n, int stack_size,
                               int tile_w, float* t_out, int* tri_out,
                               float* u_out, float* v_out, float* pay_out,
                               cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (tile_w < 0 || (tile_w > 0 && n % tile_w != 0) ||
      (uvp == nullptr) != (pay_out == nullptr))
    return (int)cudaErrorInvalidValue;
  return (uvp ? launch<true> : launch<false>)(
      stack_size, nodes8c, tris, uvp, origin, direction, t_min, t_max, n,
      tile_w, t_out, tri_out, u_out, v_out, pay_out, stream);
}

}  // extern "C"
