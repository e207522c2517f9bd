// Device code shared by the traversal kernels (bvh8_closest.cu: K1, K7c;
// bvh8_any.cu: K2; bvh8_variants.cu: K7a, K7b; bvh8_multi.cu: K5, K5p;
// bvh2_trace.cu: K6).
//
// Exactness: the slab test and Moller-Trumbore use the operation order of
// tpurt's _Rays.slab / _Rays.mt; min/max propagate NaN like jnp.minimum;
// the library is built with --fmad=false, so nothing contracts into an FMA.
// The plain PyTorch versions (kernels/traverse_bvh8.py) repeat every
// operation in the same order.
//
// Compact node (nodes8c, bvh/wide.py compact_bvh8; every BVH8 kernel): the
// 8 child boxes as structure of arrays (lo x, y, z, hi x, y, z, 8 floats
// each, the bits of the nodes8 row's box lanes), then 8 int32 child codes
// (EMPTY_CODE for an empty slot): 224 bytes, 14 16-byte loads, no
// conversion. No kernel reads the (M, 128) nodes8 rows.
// Triangle rows (engine/convert.pack_tris): v0, e1, e2, global id, 0, 0.
// Stack codes: node id >= 0, leaf -(first * 128 + count) - 1.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define LEAF_CODE_BASE 128
#define TRI_FLOATS 12
#define COMPACT_FLOATS 56
#define EMPTY_CODE (-1)
// threads of a pixel-tile block (16x8 pixels, 8x4 per warp)
#define TILE_THREADS 128
// triangles of a leaf whose rows are loaded together (measured against 1
// and 2 on the bench frame's shadow rays for K2 and primary rays for K1,
// PERF.md)
#define LEAF_BATCH 4

namespace bvh8 {

// NaN-propagating min and max (jnp.minimum / torch.minimum semantics) as
// one instruction each (min.NaN / max.NaN, sm_80 on; FMNMX in the SASS).
// A compare, a NaN test and a select give the same value unless an input
// is NaN (both give a NaN, this one the canonical NaN) or the inputs are
// zeros of both signs (either zero). A slab value only meets comparisons,
// which neither difference changes, so no output bit moves; on K6 the
// selects took 1.33-1.45x the time (PERF.md).
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
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

// the slab test's reduction (tpurt's order) over the six plane distances
// (box plane - origin) * inverse direction: hit, and the entry distance
// in *tnear
__device__ __forceinline__ bool slab_t(float tx0, float tx1, float ty0,
                                       float ty1, float tz0, float tz1,
                                       float t_min, float tfar,
                                       float* tnear) {
  const float tn = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                        nmax(nmin(tz0, tz1), t_min));
  const float tf = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                        nmin(nmax(tz0, tz1), tfar));
  *tnear = tn;
  return tn <= tf;
}

// slab test of the box at lanes 6k..6k+5 (min x, y, z, max x, y, z) of a
// nodes2c row (bvh2_trace.cu): hit, and its entry distance in *tnear
__device__ __forceinline__ bool slab(const float* lanes, int k, const Ray& r,
                                     float t_min, float tfar, float* tnear) {
  const float* b = lanes + 6 * k;
  return slab_t((b[0] - r.ox) * r.ix, (b[3] - r.ox) * r.ix,
                (b[1] - r.oy) * r.iy, (b[4] - r.oy) * r.iy,
                (b[2] - r.oz) * r.iz, (b[5] - r.oz) * r.iz, t_min, tfar,
                tnear);
}

__device__ __forceinline__ void leaf_range(int code, int* first, int* count) {
  const int dec = -(code + 1);
  *first = dec / LEAF_CODE_BASE;
  *count = dec - *first * LEAF_CODE_BASE;
}

// slab test of child j of a half compact node, b its six planes of 4 (lo
// x, y, z, hi x, y, z): slab's operations in slab's order, the entry
// distance in *tnear
__device__ __forceinline__ bool slab_soa(const float b[24], int j,
                                         const Ray& r, float t_min,
                                         float tfar, float* tnear) {
  return slab_t((b[j] - r.ox) * r.ix, (b[12 + j] - r.ox) * r.ix,
                (b[4 + j] - r.oy) * r.iy, (b[16 + j] - r.oy) * r.iy,
                (b[8 + j] - r.oz) * r.iz, (b[20 + j] - r.oz) * r.iz, t_min,
                tfar, tnear);
}

// the six planes of half `half` of compact node `code` (children 4 * half
// .. 4 * half + 3): one 16-byte load each (float4 2a + half of plane a)
__device__ __forceinline__ void load_planes(const float* __restrict__ nodes8c,
                                            int code, int half,
                                            float b[24]) {
  const float4* row =
      reinterpret_cast<const float4*>(nodes8c + (size_t)code * COMPACT_FLOATS);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    const float4 q = __ldg(row + 2 * a + half);
    b[4 * a] = q.x;
    b[4 * a + 1] = q.y;
    b[4 * a + 2] = q.z;
    b[4 * a + 3] = q.w;
  }
}

// the 4 child codes of that half: one 16-byte load
__device__ __forceinline__ void load_codes(const float* __restrict__ nodes8c,
                                           int code, int half, int codes[4]) {
  const int4 c = __ldg(reinterpret_cast<const int4*>(
                           nodes8c + (size_t)code * COMPACT_FLOATS + 48) +
                       half);
  codes[0] = c.x;
  codes[1] = c.y;
  codes[2] = c.z;
  codes[3] = c.w;
}

// whether the 4 codes of a half are all EMPTY_CODE (-1, every bit set);
// slots fill in order, so an empty second half means a node of at most 4
// children
__device__ __forceinline__ bool all_empty(const int codes[4]) {
  return (codes[0] & codes[1] & codes[2] & codes[3]) == EMPTY_CODE;
}

// half `half` of compact node `code`: its planes and its codes
__device__ __forceinline__ void load_half(const float* __restrict__ nodes8c,
                                          int code, int half, float b[24],
                                          int codes[4]) {
  load_planes(nodes8c, code, half, b);
  load_codes(nodes8c, code, half, codes);
}

// the ray of this thread in a TILE_THREADS block: consecutive rays, or,
// when tile_w > 0 (the frame's width), pixel tiles of 16x8 per block and
// 8x4 per warp, row-major over the frame (kernels/traverse_bvh8.py
// tile_pixels mirrors it); -1 past the end
__device__ __forceinline__ int tile_ray_index(int n, int tile_w) {
  if (tile_w <= 0) {
    const int ray = blockIdx.x * TILE_THREADS + threadIdx.x;
    return ray < n ? ray : -1;
  }
  const int tiles_x = (tile_w + 15) / 16;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x = (blockIdx.x % tiles_x) * 16 + (warp & 1) * 8 + (lane & 7);
  const int y = (blockIdx.x / tiles_x) * 8 + (warp >> 1) * 4 + (lane >> 3);
  const int ray = y * tile_w + x;
  return x < tile_w && ray < n ? ray : -1;
}

// blocks of a TILE_THREADS launch over n rays (tile_w as above)
inline int tile_blocks(int n, int tile_w) {
  return tile_w > 0 ? ((tile_w + 15) / 16) * ((n / tile_w + 7) / 8)
                    : (n + TILE_THREADS - 1) / TILE_THREADS;
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
