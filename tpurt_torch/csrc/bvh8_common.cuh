// Device code shared by the BVH8 traversal kernels (bvh8_trace.cu: K1, K7a,
// K7b, K7c; bvh8_any.cu: K2; bvh8_multi.cu: K5, K5p).
//
// Exactness: the slab test and Moller-Trumbore use the operation order of
// tpurt's _Rays.slab / _Rays.mt; min/max propagate NaN like jnp.minimum;
// the library is built with --fmad=false, so nothing contracts into an FMA.
// The plain PyTorch versions (kernels/traverse_bvh8.py) repeat every
// operation in the same order.
//
// Node row layout (bvh/wide.py): lanes k*6..k*6+5 child box, 48+k internal
// child index (-1 if none), 56+k leaf first triangle, 64+k leaf count.
// Triangle rows (engine/convert.pack_tris): v0, e1, e2, global id, 0, 0.
// Stack codes: node id >= 0, leaf -(first * 128 + count) - 1.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// the per-thread stack; kernels/traverse_bvh8.stack_entries gives what a
// tree needs (one pop: 7 * depth + 1, two pops: 14 * depth - 6) and the
// wrappers refuse deeper trees
#define STACK_SIZE 192
#define LEAF_CODE_BASE 128
#define NODE_FLOATS 128
#define NODE_LANES 72
#define TRI_FLOATS 12

namespace bvh8 {

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

__device__ __forceinline__ Ray make_ray(float ox, float oy, float oz,
                                        const float* __restrict__ d) {
  Ray r;
  r.ox = ox;
  r.oy = oy;
  r.oz = oz;
  r.dx = d[0];
  r.dy = d[1];
  r.dz = d[2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  return r;
}

// the 72 lanes of a node row that traversal reads, as 16-byte loads
// through the read-only path
__device__ __forceinline__ void load_node(const float* __restrict__ nodes,
                                          int code, float lanes[NODE_LANES]) {
  const float4* row =
      reinterpret_cast<const float4*>(nodes + (size_t)code * NODE_FLOATS);
#pragma unroll
  for (int i = 0; i < NODE_LANES / 4; ++i) {
    const float4 q = __ldg(row + i);
    lanes[4 * i] = q.x;
    lanes[4 * i + 1] = q.y;
    lanes[4 * i + 2] = q.z;
    lanes[4 * i + 3] = q.w;
  }
}

// slab test of child k's box: hit, and its entry distance in *tnear
__device__ __forceinline__ bool slab(const float* lanes, int k, const Ray& r,
                                     float t_min, float tfar, float* tnear) {
  const float* b = lanes + 6 * k;
  const float tx0 = (b[0] - r.ox) * r.ix;
  const float tx1 = (b[3] - r.ox) * r.ix;
  const float ty0 = (b[1] - r.oy) * r.iy;
  const float ty1 = (b[4] - r.oy) * r.iy;
  const float tz0 = (b[2] - r.oz) * r.iz;
  const float tz1 = (b[5] - r.oz) * r.iz;
  const float tn = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                        nmax(nmin(tz0, tz1), t_min));
  const float tf = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                        nmin(nmax(tz0, tz1), tfar));
  *tnear = tn;
  return tn <= tf;
}

// a slot holds an internal child or a non-empty leaf
__device__ __forceinline__ bool child_valid(const float* lanes, int k) {
  return lanes[48 + k] >= 0.0f || lanes[64 + k] > 0.0f;
}

__device__ __forceinline__ int child_code(const float* lanes, int k) {
  const float child = lanes[48 + k];
  return child >= 0.0f
             ? (int)child
             : -((int)lanes[56 + k] * LEAF_CODE_BASE + (int)lanes[64 + k]) - 1;
}

__device__ __forceinline__ void leaf_range(int code, int* first, int* count) {
  const int dec = -(code + 1);
  *first = dec / LEAF_CODE_BASE;
  *count = dec - *first * LEAF_CODE_BASE;
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, id;
};

__device__ __forceinline__ Tri load_tri(const float* __restrict__ tris,
                                        int j) {
  const float4* q =
      reinterpret_cast<const float4*>(tris + (size_t)j * TRI_FLOATS);
  const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
  Tri t;
  t.v0x = a.x;
  t.v0y = a.y;
  t.v0z = a.z;
  t.e1x = a.w;
  t.e1y = b.x;
  t.e1z = b.y;
  t.e2x = b.z;
  t.e2y = b.w;
  t.e2z = c.x;
  t.id = c.y;
  return t;
}

// Moller-Trumbore with the strict t < lim of tpurt: hit, and t/u/v
__device__ __forceinline__ bool moller_trumbore(const Tri& q, const Ray& r,
                                                float t_min, float lim,
                                                float* t, float* u, float* v) {
  const float px = r.dy * q.e2z - r.dz * q.e2y;
  const float py = r.dz * q.e2x - r.dx * q.e2z;
  const float pz = r.dx * q.e2y - r.dy * q.e2x;
  const float det = q.e1x * px + q.e1y * py + q.e1z * pz;
  const bool valid = fabsf(det) > 1e-12f;
  const float inv_det = 1.0f / (valid ? det : 1.0f);
  const float tx = r.ox - q.v0x, ty = r.oy - q.v0y, tz = r.oz - q.v0z;
  const float uk = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * q.e1z - tz * q.e1y;
  const float qy = tz * q.e1x - tx * q.e1z;
  const float qz = tx * q.e1y - ty * q.e1x;
  const float vk = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float tk = (q.e2x * qx + q.e2y * qy + q.e2z * qz) * inv_det;
  *t = tk;
  *u = uk;
  *v = vk;
  return valid && uk >= 0.0f && vk >= 0.0f && uk + vk <= 1.0f &&
         tk > t_min && tk < lim;
}

}  // namespace bvh8
