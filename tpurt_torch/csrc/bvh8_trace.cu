// BVH8 closest hit with the uv payload (K7c) over the nodes8 rows, one
// thread per ray.
//
// Replaces the uv-payload outputs of tpurt/kernels/traverse_bvh8.py::
// _kernel_bvh8_single (uv_payload=True): the closest hit plus texture uv,
// image slot and extents. It computes what that kernel computes, not how:
// the TPU kernel traverses a 32x32 ray packet behind one scalar stack
// (Mosaic has no per-lane gather), with a Batcher sort on scalars and
// speculative DMAs. Here each thread owns its ray and its stack. K7c is the
// last kernel that reads the nodes8 rows; the other BVH8 traversals read
// the compact table nodes8c (bvh8_closest.cu: K1, bvh8_any.cu: K2,
// bvh8_variants.cu: K7a and K7b, bvh8_multi.cu: K5 and K5p).
//
// What bounds it on an H100: divergent, latency-bound loads. Every step
// reads one 512-byte node row (72 of its floats) or up to 32 triangle rows
// of 48 bytes from global memory, with little arithmetic between them. The
// design keeps the step simple so many warps are resident to hide that
// latency: rows are read with 16-byte vector loads through the read-only
// path, the stack (code + entry distance) lives in local memory, popped
// entries whose entry distance lies beyond the current hit are skipped
// without a fetch, and children are pushed far-to-near so the nearest pops
// first and the shrinking hit distance culls the rest.
//
// Traversal order, shared with the plain version (kernels/traverse_bvh8.py):
// the root is pushed first; popping a node tests its 8 child boxes with the
// slab test (tfar = the current hit distance) and pushes the hit children
// sorted by (entry distance, slot), far first. Popping a leaf runs
// Moller-Trumbore on its triangles in order (strict t < tfar, so the first
// of equal distances wins). An entry whose entry distance exceeds the
// current hit when popped is dropped.
//
// The payload is read once, at the end, from the winner's row of the
// (T, 9) uvp table (three corner uvs, image slot, tex_h, tex_w, in BVH
// leaf order): uv0 * w + uv1 * u + uv2 * v with w = 1 - u - v, the
// association of tpurt's per-update payload (:458-463) and of the shade
// pass's tex_coord, so all three are bit-equal. Miss lanes get 0, 0, 0, 1, 1.
#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

// slab-test the 8 children of node `code`; the hit ones in (entry
// distance, slot) order (stable insertion); returns how many
__device__ __forceinline__ int node_children(const float* __restrict__ nodes,
                                             int code, const Ray& r,
                                             float t_min, float tfar,
                                             float keys[8], int codes[8]) {
  float lanes[NODE_LANES];
  load_node(nodes, code, lanes);
  int nh = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    float tnear;
    if (slab(lanes, k, r, t_min, tfar, &tnear) && child_valid(lanes, k)) {
      const int c = child_code(lanes, k);
      int j = nh;
      while (j > 0 && keys[j - 1] > tnear) {
        keys[j] = keys[j - 1];
        codes[j] = codes[j - 1];
        --j;
      }
      keys[j] = tnear;
      codes[j] = c;
      ++nh;
    }
  }
  return nh;
}

// push the hit children far-to-near (keys sorted, the nearest child ends
// on top)
__device__ __forceinline__ int push_children(int* code_stack,
                                             float* near_stack, int sp,
                                             const float keys[8],
                                             const int codes[8], int nh) {
  for (int j = nh - 1; j >= 0; --j) {
    code_stack[sp] = codes[j];
    near_stack[sp] = keys[j];
    ++sp;
  }
  return sp;
}

// closest-hit leaf: sequential strict-less updates of t/u/v/tri/row
__device__ __forceinline__ void leaf_closest(const float* __restrict__ tris,
                                             int code, const Ray& r,
                                             float t_min, float* t, float* u,
                                             float* v, int* tri, int* row) {
  int first, count;
  leaf_range(code, &first, &count);
  for (int j = first; j < first + count; ++j) {
    const Tri q = load_tri(tris, j);
    float tk, uk, vk;
    if (moller_trumbore(q, r, t_min, *t, &tk, &uk, &vk)) {
      *t = tk;
      *u = uk;
      *v = vk;
      *tri = (int)q.id;
      *row = j;
    }
  }
}

__global__ void __launch_bounds__(128)
bvh8_uvp_kernel(const float* __restrict__ nodes,
                const float* __restrict__ tris,
                const float* __restrict__ uvp,
                const float* __restrict__ origin,
                const float* __restrict__ direction, float t_min,
                const float* __restrict__ t_max_arr, int n,
                float* __restrict__ t_out, int* __restrict__ tri_out,
                float* __restrict__ u_out, float* __restrict__ v_out,
                float* __restrict__ pay_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const Ray r = make_ray(origin[3 * ray], origin[3 * ray + 1],
                         origin[3 * ray + 2], direction + 3 * ray);

  float t = t_max_arr[ray], u = 0.0f, v = 0.0f;
  int tri = -1, row = -1;

  int code_stack[STACK_SIZE];
  float near_stack[STACK_SIZE];
  code_stack[0] = 0;
  near_stack[0] = -INFINITY;
  int sp = 1;

  while (sp > 0) {
    const int c0 = code_stack[sp - 1];
    const float n0 = near_stack[sp - 1];
    sp -= 1;
    // an entry's box was entered at its near distance; a closer hit found
    // since makes the parent's slab test fail for it now
    const bool live0 = n0 <= t;
    if (live0 && c0 < 0)
      leaf_closest(tris, c0, r, t_min, &t, &u, &v, &tri, &row);
    float keys0[8];
    int codes0[8];
    int nh0 = 0;
    if (live0 && c0 >= 0)
      nh0 = node_children(nodes, c0, r, t_min, t, keys0, codes0);
    sp = push_children(code_stack, near_stack, sp, keys0, codes0, nh0);
  }
  t_out[ray] = t;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
  float tu = 0.0f, tv = 0.0f, im = 0.0f, th = 1.0f, tw = 1.0f;
  if (tri >= 0) {
    const float* p = uvp + (size_t)row * 9;
    const float w = 1.0f - u - v;
    tu = p[0] * w + p[2] * u + p[4] * v;
    tv = p[1] * w + p[3] * u + p[5] * v;
    im = p[6];
    th = p[7];
    tw = p[8];
  }
  pay_out[ray] = tu;
  pay_out[n + ray] = tv;
  pay_out[2 * n + ray] = im;
  pay_out[3 * n + ray] = th;
  pay_out[4 * n + ray] = tw;
}

}  // namespace

extern "C" {

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// K7c: the closest hit of n rays over the nodes8 rows (M, 128) f32 with
// the payload pay_out (5, n) f32: texu, texv, img, texh, texw
int tpurt_bvh8_closest_uvp(const float* nodes, const float* tris,
                           const float* uvp, const float* origin,
                           const float* direction, float t_min,
                           const float* t_max, int n, float* t_out,
                           int* tri_out, float* u_out, float* v_out,
                           float* pay_out, cudaStream_t stream) {
  if (n > 0)
    bvh8_uvp_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
        nodes, tris, uvp, origin, direction, t_min, t_max, n, t_out, tri_out,
        u_out, v_out, pay_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
