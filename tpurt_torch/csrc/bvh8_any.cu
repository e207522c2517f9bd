// BVH8 any-hit traversal (K2) written for Hopper, one thread per ray.
//
// Replaces tpurt/kernels/traverse_bvh8.py::_kernel_bvh8_single with
// any_hit=True (trace_any_bvh8) at tpurt's default push order, "none". It
// computes what that kernel computes (the occlusion mask), not how: the TPU
// kernel walks a 32x32 ray packet behind one scalar stack; here each thread
// owns its ray and its stack.
//
// What bounds it on an H100: divergent, latency-bound loads with little
// arithmetic between them (a node's 8 slab tests, a leaf's triangle tests).
// The design cuts what each step costs besides its loads:
//   * the compact node table nodes8c (engine/convert.py, bvh/wide.py
//     compact_bvh8): per node the 8 child boxes as structure of arrays
//     (lo x/y/z, hi x/y/z, 8 floats each, the bits of the nodes8 row's box
//     lanes) and 8 int32 stack codes precomputed (a node's index, a leaf's
//     -(first * 128 + count) - 1, EMPTY_CODE for an empty slot): 224
//     bytes read as 14 16-byte loads, against 288 bytes and 8
//     float-to-int conversions per pop before, in two halves (children
//     0-3, then 4-7) to hold fewer registers;
//   * pushes in slot order straight from the slab test (tpurt's "none"),
//     slot 7 on top: no keys, no sort, no entry distances on the stack (an
//     any hit never reads them);
//   * a stack of codes only, STACK entries (the wrapper picks the smallest
//     instantiation >= kernels/traverse_bvh8.stack_entries(depth)), as a
//     local array (cached in L1; the few top entries a ray uses stay hot);
//     a stack in shared memory, strided by thread, measured slower: its
//     24 KB per block come out of the L1 that caches the node and triangle
//     rows (PERF.md);
//   * a leaf's triangles LEAF_BATCH at a time, their rows in flight
//     together.
// When the rays are a frame's pixels (tile_w > 0, the frame's width: the
// shade pass's shadow rays) a block covers a 16x8 pixel tile, each warp
// 8x4 pixels, so a warp's shadow rays start close together and share
// nodes; rays and the mask stay in pixel order.
//
// Bits: the slab test and Moller-Trumbore are bvh8_common.cuh's, tpurt's
// operation order; a ray with t_max <= t_min retires at once; the first hit
// ends the ray. Occlusion does not depend on the visit order, so the mask
// equals K7a's and the plain version's bit for bit.
#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

// at least 6 blocks per SM (<= 85 registers; ptxas takes 80 without
// spills): 24 warps, each with up to LEAF_BATCH triangle rows in flight
template <int STACK>
__global__ void __launch_bounds__(TILE_THREADS, 6)
bvh8_any_kernel(const float* __restrict__ nodes8c,
                const float* __restrict__ tris,
                const float* __restrict__ origin,
                const float* __restrict__ direction, float t_min,
                const float* __restrict__ t_max_arr, int n, int tile_w,
                uint8_t* __restrict__ occ_out) {
  int stack[STACK];

  const int ray = tile_ray_index(n, tile_w);
  if (ray < 0) return;
  const float t_max0 = t_max_arr[ray];
  bool occ = false;
  // a ray with t_max <= t_min can hit nothing: it retires at once
  if (t_max0 > t_min) {
    const Ray r = make_ray(origin[3 * ray], origin[3 * ray + 1],
                           origin[3 * ray + 2], direction + 3 * ray);
    stack[0] = 0;
    int sp = 1;
    while (sp > 0) {
      --sp;
      const int code = stack[sp];
      if (code < 0) {
        // LEAF_BATCH triangles per step, every row loaded before the first
        // test (past the leaf's end the last row again): occlusion does not
        // depend on the order of the tests or on tests past the first hit
        int first, count;
        leaf_range(code, &first, &count);
        const int last = first + count - 1;
        for (int j = first; j <= last; j += LEAF_BATCH) {
          Tri q[LEAF_BATCH];
#pragma unroll
          for (int b = 0; b < LEAF_BATCH; ++b)
            q[b] = load_tri(tris, min(j + b, last));
          bool hit = false;
#pragma unroll
          for (int b = 0; b < LEAF_BATCH; ++b) {
            float tk, uk, vk;
            hit = hit ||
                  moller_trumbore(q[b], r, t_min, t_max0, &tk, &uk, &vk);
          }
          if (hit) {
            occ = true;
            break;
          }
        }
        if (occ) break;
        continue;
      }
      // children 0-3, then 4-7
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float b[24];
        int codes[4];
        load_half(nodes8c, code, half, b, codes);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float tn;
          if (codes[j] != EMPTY_CODE &&
              slab_soa(b, j, r, t_min, t_max0, &tn)) {
            stack[sp] = codes[j];
            ++sp;
          }
        }
      }
    }
  }
  occ_out[ray] = occ ? 1 : 0;
}

template <int STACK>
int launch(const float* nodes8c, const float* tris, const float* origin,
           const float* direction, float t_min, const float* t_max, int n,
           int tile_w, uint8_t* occ_out, cudaStream_t stream) {
  bvh8_any_kernel<STACK><<<tile_blocks(n, tile_w), TILE_THREADS, 0,
                           stream>>>(
      nodes8c, tris, origin, direction, t_min, t_max, n, tile_w, occ_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2: occlusion of n rays over the compact node table (M, 56) f32 (codes
// bit-cast). stack_size: 48 or 192 entries (the wrapper picks it from the
// tree's depth); tile_w: 0 for consecutive rays, else the frame's width
// (n = tile_w * H).
int tpurt_bvh8_any(const float* nodes8c, const float* tris,
                   const float* origin, const float* direction, float t_min,
                   const float* t_max, int n, int stack_size, int tile_w,
                   uint8_t* occ_out, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (tile_w < 0 || (tile_w > 0 && n % tile_w != 0))
    return (int)cudaErrorInvalidValue;
  if (stack_size == 48)
    return launch<48>(nodes8c, tris, origin, direction, t_min, t_max, n,
                      tile_w, occ_out, stream);
  if (stack_size == 192)
    return launch<192>(nodes8c, tris, origin, direction, t_min, t_max, n,
                       tile_w, occ_out, stream);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
