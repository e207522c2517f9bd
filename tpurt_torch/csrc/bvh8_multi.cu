// Fused multi-set BVH8 any-hit traversal (K5, and K5p with two pops per
// iteration), one thread per pixel.
//
// Replaces tpurt/kernels/traverse_bvh8.py::_kernel_bvh8_any_multi and
// ::_kernel_bvh8_any_multi_pop2 (trace_any_bvh8_multi): S shadow-ray sets
// that share their origins (one set per light, one ray per pixel in each)
// traverse one tree with one stack, so the walk covers the union of the S
// footprints, which coincide near the common origin, instead of their sum.
// The TPU kernels do this for a 32x32 pixel packet behind one scalar stack;
// here each thread owns one pixel: the origin once, and S directions,
// reciprocals and t_max in registers (NS is a template parameter, so the
// per-set loops unroll and nothing spills to a per-set array).
//
// Each stack entry carries the bit mask of the sets whose own slab tests
// reached it. A popped node slab-tests its children for the sets of its mask
// that are still live (not occluded, t_max > t_min) and pushes a child with
// the mask of the sets that hit it; a popped leaf runs Moller-Trumbore for
// the live sets of its mask, each set stopping at its first hit. So every
// set visits exactly the nodes and leaves it would visit alone, and its
// occlusion is bit-equal to K2 run once per set (bvh8_trace.cu) - also on
// grazing rays, where a triangle test accepts a hit whose enclosing box the
// ray's own slab test rejects by a rounding: there a mask-free union would
// find an occluder that K2 cannot reach. The thread retires when every set
// is occluded or dead, or the stack is empty. Pushes are unsorted (slot 0
// on top): occlusion does not depend on the visit order.
//
// The two-pop variant (K5p) pops up to two entries per iteration: leaf work
// for both, the top entry first, then both node rows, the lower entry's
// children pushed first (tpurt's order, traverse_bvh8.py:949-1102). Its
// stack needs 14 * depth - 6 entries, checked by the wrapper.
//
// What bounds it on an H100: the same divergent, latency-bound row loads as
// K2, now shared by the S sets, plus S slab tests per child and S triangle
// tests per triangle row in registers.
//
// The wrapper launches at most MULTI_SETS_MAX sets at a time and splits a
// larger S into launches of at most that many sets (occlusion per set does
// not depend on the other sets).
#include "bvh8_common.cuh"

#define MULTI_SETS_MAX 4

namespace {

using namespace bvh8;

// Moller-Trumbore over the leaf's triangles for the sets in `mask`, each
// set stopping at its first hit; returns the mask of sets that hit
template <int NS>
__device__ __forceinline__ unsigned leaf_multi(const float* __restrict__ tris,
                                               int code, const Ray* rays,
                                               float t_min,
                                               const float* t_max,
                                               unsigned mask) {
  int first, count;
  leaf_range(code, &first, &count);
  unsigned hit = 0;
  for (int j = first; j < first + count && mask; ++j) {
    const Tri q = load_tri(tris, j);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      float tk, uk, vk;
      if ((mask >> s) & 1u &&
          moller_trumbore(q, rays[s], t_min, t_max[s], &tk, &uk, &vk)) {
        hit |= 1u << s;
        mask &= ~(1u << s);
      }
    }
  }
  return hit;
}

// slab-test node `code`'s children for the sets in `mask` and push the hit
// ones with their set masks, slot 0 on top; returns the new stack pointer
template <int NS>
__device__ __forceinline__ int push_multi(const float* __restrict__ nodes,
                                          int code, const Ray* rays,
                                          float t_min, const float* t_max,
                                          unsigned mask, int* code_stack,
                                          uint8_t* mask_stack, int sp) {
  float lanes[NODE_LANES];
  load_node(nodes, code, lanes);
  unsigned hits[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    hits[k] = 0;
    if (child_valid(lanes, k)) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        float tnear;
        if ((mask >> s) & 1u &&
            slab(lanes, k, rays[s], t_min, t_max[s], &tnear))
          hits[k] |= 1u << s;
      }
    }
  }
#pragma unroll
  for (int k = 7; k >= 0; --k) {
    if (hits[k]) {
      code_stack[sp] = child_code(lanes, k);
      mask_stack[sp] = (uint8_t)hits[k];
      ++sp;
    }
  }
  return sp;
}

template <int NS, bool POP2>
__global__ void __launch_bounds__(128)
bvh8_any_multi_kernel(const float* __restrict__ nodes,
                      const float* __restrict__ tris,
                      const float* __restrict__ origin,
                      const float* __restrict__ dirs, float t_min,
                      const float* __restrict__ t_maxs, int n,
                      uint8_t* __restrict__ occ_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const float ox = origin[3 * ray], oy = origin[3 * ray + 1],
              oz = origin[3 * ray + 2];
  Ray rays[NS];
  float t_max[NS];
  unsigned live = 0;  // sets not yet occluded with t_max > t_min
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    rays[s] = make_ray(ox, oy, oz, dirs + (size_t)s * 3 * n + 3 * ray);
    t_max[s] = t_maxs[(size_t)s * n + ray];
    if (t_max[s] > t_min) live |= 1u << s;
  }
  unsigned occ = 0;

  int code_stack[STACK_SIZE];
  uint8_t mask_stack[STACK_SIZE];
  int sp = 0;
  if (live) {
    code_stack[0] = 0;
    mask_stack[0] = (uint8_t)live;
    sp = 1;
  }

  while (sp > 0) {
    const int c0 = code_stack[sp - 1];
    unsigned m0 = mask_stack[sp - 1] & live;
    int c1 = 0;
    unsigned m1 = 0;
    if (POP2 && sp >= 2) {
      c1 = code_stack[sp - 2];
      m1 = mask_stack[sp - 2];
      sp -= 2;
    } else {
      sp -= 1;
    }

    // leaf phase: the top entry first
    if (m0 && c0 < 0) {
      const unsigned h = leaf_multi<NS>(tris, c0, rays, t_min, t_max, m0);
      occ |= h;
      live &= ~h;
    }
    if (POP2) {
      m1 &= live;
      if (m1 && c1 < 0) {
        const unsigned h = leaf_multi<NS>(tris, c1, rays, t_min, t_max, m1);
        occ |= h;
        live &= ~h;
      }
    }
    if (!live) break;

    // node phase: the lower entry's children first
    m0 &= live;
    if (POP2) {
      m1 &= live;
      if (m1 && c1 >= 0)
        sp = push_multi<NS>(nodes, c1, rays, t_min, t_max, m1, code_stack,
                            mask_stack, sp);
    }
    if (m0 && c0 >= 0)
      sp = push_multi<NS>(nodes, c0, rays, t_min, t_max, m0, code_stack,
                          mask_stack, sp);
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    occ_out[(size_t)s * n + ray] = (occ >> s) & 1u;
}

template <int NS>
void launch(bool pop2, const float* nodes, const float* tris,
            const float* origin, const float* dirs, float t_min,
            const float* t_maxs, int n, uint8_t* occ_out,
            cudaStream_t stream) {
  const int blocks = (n + 127) / 128;
  if (pop2)
    bvh8_any_multi_kernel<NS, true><<<blocks, 128, 0, stream>>>(
        nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out);
  else
    bvh8_any_multi_kernel<NS, false><<<blocks, 128, 0, stream>>>(
        nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out);
}

}  // namespace

extern "C" {

// occlusion of n_sets ray sets: dirs (n_sets, n, 3), t_maxs and occ_out
// (n_sets, n), all contiguous; 1 <= n_sets <= MULTI_SETS_MAX
int tpurt_bvh8_any_multi(const float* nodes, const float* tris,
                         const float* origin, const float* dirs, float t_min,
                         const float* t_maxs, int n, int n_sets, int pop2,
                         uint8_t* occ_out, cudaStream_t stream) {
  if (n_sets < 1 || n_sets > MULTI_SETS_MAX) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    switch (n_sets) {
      case 1:
        launch<1>(pop2, nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out,
                  stream);
        break;
      case 2:
        launch<2>(pop2, nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out,
                  stream);
        break;
      case 3:
        launch<3>(pop2, nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out,
                  stream);
        break;
      default:
        launch<4>(pop2, nodes, tris, origin, dirs, t_min, t_maxs, n, occ_out,
                  stream);
        break;
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
