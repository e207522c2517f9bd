// Binary-BVH closest-hit and any-hit traversal (K6), one thread per ray.
//
// Replaces both Pallas functions of tpurt/kernels/traverse_pallas.py:
// _packet_kernel (the smem and vmem table tiers) and _packet_kernel_hbm
// (the hbm tier), each in its closest-hit (trace_closest_packets) and
// any-hit (trace_any_packets) mode. On the card the three table tiers are
// one kernel, and the two modes are template variants. It computes what
// those kernels compute, not how: the TPU kernels push a 32x32 ray packet
// through the tree behind one scalar stack, order children by the packet's
// mean direction and prefetch node rows by DMA. Here each thread owns its
// ray and its stack, and there is no packet, no DMA pipeline and no image
// swizzle.
//
// What bounds it on an H100: divergent, latency-bound loads. Every step
// reads two 32-byte child rows (or up to max_leaf 48-byte triangle rows)
// from global memory, with some 40 flops between them. The design keeps
// the step short so many warps are resident to hide that latency: a node
// is 32 bytes (two 16-byte loads through the read-only path), the children
// of a popped node are slab-tested together so the nearer is visited first
// and the far one is skipped without a fetch once a closer hit is found.
//
// Traversal order, shared with the plain version (kernels/traverse_bvh2.py):
// the root's box is slab-tested and, if hit, pushed. Popping an internal
// node slab-tests its two children against tfar (the current hit distance,
// or t_max for any-hit) and pushes the hit ones far first, so the nearer
// pops first. The per-ray key is the child's slab entry distance tnear;
// on equal keys the left child is the nearer. A closest-hit entry whose
// tnear exceeds the current hit is dropped when popped (its slab test at
// the current hit distance would fail). Popping a leaf runs Moller-Trumbore
// on its first min(count, max_leaf) triangles in order with a strict
// t < tfar, so the first of equal distances wins. Any-hit stops at the
// first hit. A ray with t_max <= t_min is never occluded.
//
// Exactness: slab and Moller-Trumbore use the operation order of tpurt's
// _Rays.slab / _Rays.mt (traverse_pallas.py:120-158); min/max propagate NaN
// like jnp.minimum; the library is built with --fmad=false. The plain
// version visits the same entries in the same order and gives
// bit-identical t/tri/u/v/occ.
//
// Node rows (engine/convert.pack_bvh2, 8 f32 lanes): min.xyz, max.xyz, then
// for an internal node (left child, right child) and for a leaf
// (first triangle, -count); indices are exact small floats (< 2^24).
// Triangle rows (convert.pack_tris): v0, e1, e2, global id, 0, 0.
// Stack codes: internal node id >= 0, leaf -(node id) - 1.
// The stack holds depth + 1 entries for a tree of depth `depth` (root = 0):
// at most one deferred sibling per level plus the two children just pushed.
// The wrapper picks STACK from the tree's depth bound and refuses deeper
// trees; nothing is clamped.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NODE2_FLOATS 8
#define TRI_FLOATS 12

namespace {

__device__ __forceinline__ float nmin(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {
  return (a > b || a != a) ? a : b;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// slab test of one box (lanes lo.xyz, hi.xyz): entry distance and hit
__device__ __forceinline__ bool slab(const Ray& r, float4 a, float4 b,
                                     float t_min, float tfar, float* tnear) {
  const float tx0 = (a.x - r.ox) * r.ix;
  const float tx1 = (a.w - r.ox) * r.ix;
  const float ty0 = (a.y - r.oy) * r.iy;
  const float ty1 = (b.x - r.oy) * r.iy;
  const float tz0 = (a.z - r.oz) * r.iz;
  const float tz1 = (b.y - r.oz) * r.iz;
  const float tn = nmax(nmax(nmin(tx0, tx1), nmin(ty0, ty1)),
                        nmax(nmin(tz0, tz1), t_min));
  const float tf = nmin(nmin(nmax(tx0, tx1), nmax(ty0, ty1)),
                        nmin(nmax(tz0, tz1), tfar));
  *tnear = tn;
  return tn <= tf;
}

template <bool ANY_HIT, int STACK>
__global__ void __launch_bounds__(128)
bvh2_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction, float t_min,
                  const float* __restrict__ t_max_arr, int n, int max_leaf,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  uint8_t* __restrict__ occ_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  Ray r;
  r.ox = origin[3 * ray];
  r.oy = origin[3 * ray + 1];
  r.oz = origin[3 * ray + 2];
  r.dx = direction[3 * ray];
  r.dy = direction[3 * ray + 1];
  r.dz = direction[3 * ray + 2];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  const float t_max0 = t_max_arr[ray];
  const float4* rows = reinterpret_cast<const float4*>(nodes);

  float t = t_max0, u = 0.0f, v = 0.0f;
  int tri = -1;
  bool occ = false;

  int code_stack[STACK];
  float near_stack[STACK];
  int sp = 0;
  {
    const float4 a = __ldg(rows), b = __ldg(rows + 1);
    float tn;
    if (slab(r, a, b, t_min, t_max0, &tn)) {
      code_stack[0] = b.w < 0.0f ? -1 : 0;
      if (!ANY_HIT) near_stack[0] = tn;
      sp = 1;
    }
  }

  while (sp > 0) {
    --sp;
    const int code = code_stack[sp];
    if (!ANY_HIT && near_stack[sp] > t) continue;
    const float tfar = ANY_HIT ? t_max0 : t;
    if (code >= 0) {
      const float4 meta = __ldg(rows + 2 * code + 1);
      const int kid[2] = {(int)meta.z, (int)meta.w};
      float key[2];
      bool hit[2];
      int kc[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float4 a = __ldg(rows + 2 * kid[k]);
        const float4 b = __ldg(rows + 2 * kid[k] + 1);
        hit[k] = slab(r, a, b, t_min, tfar, &key[k]);
        kc[k] = b.w < 0.0f ? -kid[k] - 1 : kid[k];
      }
      // left is the nearer on equal keys; push the far one first
      const int nr = key[0] <= key[1] ? 0 : 1;
      const int fr = 1 - nr;
      if (hit[fr]) {
        code_stack[sp] = kc[fr];
        if (!ANY_HIT) near_stack[sp] = key[fr];
        ++sp;
      }
      if (hit[nr]) {
        code_stack[sp] = kc[nr];
        if (!ANY_HIT) near_stack[sp] = key[nr];
        ++sp;
      }
    } else {
      const float4 meta = __ldg(rows + 2 * (-code - 1) + 1);
      const int first = (int)meta.z;
      const int count = min((int)(-meta.w), max_leaf);
      for (int j = first; j < first + count; ++j) {
        const float4* q =
            reinterpret_cast<const float4*>(tris + (size_t)j * TRI_FLOATS);
        const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
        const float v0x = a.x, v0y = a.y, v0z = a.z;
        const float e1x = a.w, e1y = b.x, e1z = b.y;
        const float e2x = b.z, e2y = b.w, e2z = c.x;
        const float px = r.dy * e2z - r.dz * e2y;
        const float py = r.dz * e2x - r.dx * e2z;
        const float pz = r.dx * e2y - r.dy * e2x;
        const float det = e1x * px + e1y * py + e1z * pz;
        const bool valid = fabsf(det) > 1e-12f;
        const float inv_det = 1.0f / (valid ? det : 1.0f);
        const float tx = r.ox - v0x, ty = r.oy - v0y, tz = r.oz - v0z;
        const float uk = (tx * px + ty * py + tz * pz) * inv_det;
        const float qx = ty * e1z - tz * e1y;
        const float qy = tz * e1x - tx * e1z;
        const float qz = tx * e1y - ty * e1x;
        const float vk = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
        const float tk = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
        const float lim = ANY_HIT ? t_max0 : t;
        const bool h = valid && uk >= 0.0f && vk >= 0.0f &&
                       uk + vk <= 1.0f && tk > t_min && tk < lim;
        if (h) {
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

template <bool ANY_HIT>
int launch(const float* nodes, const float* tris, const float* origin,
           const float* direction, float t_min, const float* t_max, int n,
           int max_leaf, int stack, float* t_out, int* tri_out, float* u_out,
           float* v_out, uint8_t* occ_out, cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  const int grid = (n + 127) / 128;
  if (stack <= 64) {
    bvh2_trace_kernel<ANY_HIT, 64><<<grid, 128, 0, s>>>(
        nodes, tris, origin, direction, t_min, t_max, n, max_leaf, t_out,
        tri_out, u_out, v_out, occ_out);
  } else if (stack <= 192) {
    bvh2_trace_kernel<ANY_HIT, 192><<<grid, 128, 0, s>>>(
        nodes, tris, origin, direction, t_min, t_max, n, max_leaf, t_out,
        tri_out, u_out, v_out, occ_out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int tpurt_bvh2_closest(const float* nodes, const float* tris,
                       const float* origin, const float* direction,
                       float t_min, const float* t_max, int n, int max_leaf,
                       int stack, float* t_out, int* tri_out, float* u_out,
                       float* v_out, cudaStream_t stream) {
  return launch<false>(nodes, tris, origin, direction, t_min, t_max, n,
                       max_leaf, stack, t_out, tri_out, u_out, v_out, nullptr,
                       stream);
}

int tpurt_bvh2_any(const float* nodes, const float* tris, const float* origin,
                   const float* direction, float t_min, const float* t_max,
                   int n, int max_leaf, int stack, uint8_t* occ_out,
                   cudaStream_t stream) {
  return launch<true>(nodes, tris, origin, direction, t_min, t_max, n,
                      max_leaf, stack, nullptr, nullptr, nullptr, nullptr,
                      occ_out, stream);
}

}  // extern "C"
