// BVH8 closest-hit and any-hit traversal, one thread per ray.
//
// Replaces tpurt/kernels/traverse_bvh8.py::_kernel_bvh8_single, both modes:
// any_hit=False (K1, trace_closest_bvh8) and any_hit=True (K2,
// trace_any_bvh8). It computes what that kernel computes, not how: the TPU
// kernel traverses a 32x32 ray packet behind one scalar stack (Mosaic has no
// per-lane gather), with a Batcher sort on scalars and speculative DMAs.
// Here each thread owns its ray and its stack.
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
// Exactness: the slab test and Moller-Trumbore use the operation order of
// tpurt's _Rays.slab / _Rays.mt; min/max propagate NaN like jnp.minimum;
// the library is built with --fmad=false, so nothing contracts into an FMA.
// The plain PyTorch version (kernels/traverse_bvh8.py) visits entries in the
// same order and gives bit-identical t/tri/u/v/occ.
//
// Node row layout (bvh/wide.py): lanes k*6..k*6+5 child box, 48+k internal
// child index (-1 if none), 56+k leaf first triangle, 64+k leaf count.
// Triangle rows (engine/convert.pack_tris): v0, e1, e2, global id, 0, 0.
// Stack codes: node id >= 0, leaf -(first * 128 + count) - 1.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define STACK_SIZE 192
#define LEAF_CODE_BASE 128
#define NODE_FLOATS 128
#define TRI_FLOATS 12

// NaN-propagating min/max (jnp.minimum / torch.minimum semantics)
__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <bool ANY_HIT>
__global__ void __launch_bounds__(128)
bvh8_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  float t_min, const float* __restrict__ t_max_arr, int n,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  uint8_t* __restrict__ occ_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = origin[3 * ray], oy = origin[3 * ray + 1],
              oz = origin[3 * ray + 2];
  const float dx = direction[3 * ray], dy = direction[3 * ray + 1],
              dz = direction[3 * ray + 2];
  const float inv_x = 1.0f / dx, inv_y = 1.0f / dy, inv_z = 1.0f / dz;
  const float t_max0 = t_max_arr[ray];

  float t = t_max0, u = 0.0f, v = 0.0f;
  int tri = -1;
  bool occ = false;

  int code_stack[STACK_SIZE];
  float near_stack[STACK_SIZE];
  int sp = 0;
  // a ray with t_max <= t_min can hit nothing: it retires at once
  if (!ANY_HIT || t_max0 > t_min) {
    code_stack[0] = 0;
    near_stack[0] = -INFINITY;
    sp = 1;
  }

  while (sp > 0) {
    --sp;
    const int code = code_stack[sp];
    // the entry's box was entered at near_stack[sp]; a closer hit found
    // since makes the parent's slab test fail for it now
    if (!ANY_HIT && near_stack[sp] > t) continue;
    const float tfar = ANY_HIT ? t_max0 : t;
    if (code >= 0) {
      const float4* row =
          reinterpret_cast<const float4*>(nodes + (size_t)code * NODE_FLOATS);
      float lanes[72];
#pragma unroll
      for (int i = 0; i < 18; ++i) {
        const float4 q = __ldg(row + i);
        lanes[4 * i] = q.x;
        lanes[4 * i + 1] = q.y;
        lanes[4 * i + 2] = q.z;
        lanes[4 * i + 3] = q.w;
      }
      // hit children in (entry distance, slot) order: stable insertion
      float keys[8];
      int codes[8];
      int nh = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float* b = lanes + 6 * k;
        const float tx0 = (b[0] - ox) * inv_x;
        const float tx1 = (b[3] - ox) * inv_x;
        const float ty0 = (b[1] - oy) * inv_y;
        const float ty1 = (b[4] - oy) * inv_y;
        const float tz0 = (b[2] - oz) * inv_z;
        const float tz1 = (b[5] - oz) * inv_z;
        const float tnear = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                                 nmax(nmin(tz0, tz1), t_min));
        const float tfar_ = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                                 nmin(nmax(tz0, tz1), tfar));
        const float child = lanes[48 + k];
        const float count = lanes[64 + k];
        if (tnear <= tfar_ && (child >= 0.0f || count > 0.0f)) {
          const int c = child >= 0.0f
              ? (int)child
              : -((int)lanes[56 + k] * LEAF_CODE_BASE + (int)count) - 1;
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
      // far-to-near pushes: the nearest child ends on top
      for (int j = nh - 1; j >= 0; --j) {
        code_stack[sp] = codes[j];
        near_stack[sp] = keys[j];
        ++sp;
      }
    } else {
      const int dec = -(code + 1);
      const int first = dec / LEAF_CODE_BASE;
      const int count = dec - first * LEAF_CODE_BASE;
      for (int j = first; j < first + count; ++j) {
        const float4* r =
            reinterpret_cast<const float4*>(tris + (size_t)j * TRI_FLOATS);
        const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
        const float v0x = a.x, v0y = a.y, v0z = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float px = dy * e2z - dz * e2y;
        const float py = dz * e2x - dx * e2z;
        const float pz = dx * e2y - dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool valid = fabsf(det) > 1e-12f;
        const float inv_det = 1.0f / (valid ? det : 1.0f);
        const float tx = ox - v0x, ty = oy - v0y, tz = oz - v0z;
        const float uk = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vk = (dx * qx + dy * qy + dz * qz) * inv_det;
        const float tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const float lim = ANY_HIT ? t_max0 : t;
        const bool hit = valid && uk >= 0.0f && vk >= 0.0f &&
                         uk + vk <= 1.0f && tk > t_min && tk < lim;
        if (hit) {
          if (ANY_HIT) {
            occ = true;
            break;
          }
          t = tk;
          u = uk;
          v = vk;
          tri = (int)c.y;
        }
      }
      if (ANY_HIT && occ) break;
    }
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

extern "C" {

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int tpurt_bvh8_closest(const float* nodes, const float* tris,
                       const float* origin, const float* direction,
                       float t_min, const float* t_max, int n, float* t_out,
                       int* tri_out, float* u_out, float* v_out,
                       cudaStream_t stream) {
  if (n > 0) {
    bvh8_trace_kernel<false><<<(n + 127) / 128, 128, 0, stream>>>(
        nodes, tris, origin, direction, t_min, t_max, n, t_out, tri_out,
        u_out, v_out, nullptr);
  }
  return (int)cudaGetLastError();
}

int tpurt_bvh8_any(const float* nodes, const float* tris,
                   const float* origin, const float* direction, float t_min,
                   const float* t_max, int n, uint8_t* occ_out,
                   cudaStream_t stream) {
  if (n > 0) {
    bvh8_trace_kernel<true><<<(n + 127) / 128, 128, 0, stream>>>(
        nodes, tris, origin, direction, t_min, t_max, n, nullptr, nullptr,
        nullptr, nullptr, occ_out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
