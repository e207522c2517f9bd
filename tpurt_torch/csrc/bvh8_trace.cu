// BVH8 closest-hit and any-hit traversal, one thread per ray.
//
// Replaces tpurt/kernels/traverse_bvh8.py in three forms, each a template
// variant of one kernel over the nodes8 rows (K1, _kernel_bvh8_single with
// any_hit=False at its default order, is bvh8_closest.cu; K2, its
// any_hit=True form at the default push order, is bvh8_any.cu):
//   K7a    _kernel_bvh8 (and _kernel_bvh8_single) with count_steps and
//          push_order: COUNT_STEPS counts the node and leaf entries a ray
//          visits, ORDER picks the push order of a node's hit children
//          (any hit: every order, counted or not, over the nodes8 rows);
//   K7b    _kernel_bvh8_pop2 (pop2=True), closest and any: two stack
//          entries per iteration;
//   K7c    the uv-payload outputs of _kernel_bvh8_single (uv_payload=True):
//          the closest hit plus texture uv, image slot and extents.
// It computes what those kernels compute, not how: the TPU kernels traverse
// a 32x32 ray packet behind one scalar stack (Mosaic has no per-lane
// gather), with a Batcher sort on scalars and speculative DMAs. Here each
// thread owns its ray and its stack.
//
// What bounds it on an H100: divergent, latency-bound loads. Every step
// reads one 512-byte node row (72 of its floats) or up to 32 triangle rows
// of 48 bytes from global memory, with little arithmetic between them. The
// design keeps the step simple so many warps are resident to hide that
// latency: rows are read with 16-byte vector loads through the read-only
// path, the stack (code + entry distance) lives in local memory, popped
// entries whose entry distance lies beyond the current hit are skipped
// without a fetch, and children are pushed far-to-near so the nearest pops
// first and the shrinking hit distance culls the rest. The two-pop variant
// gives each thread two independent entries per iteration: their leaf work
// runs first, nearer entry first, then both node rows are read and
// slab-tested together (two independent row loads in flight), and the far
// entry's children are pushed first, tpurt's order (traverse_bvh8.py:
// 502-519). That doubles the stack growth per iteration (+14 against +7):
// stack_entries(depth, pops=2) = 14 * depth - 6, checked by the wrapper.
//
// Traversal order, shared with the plain version (kernels/traverse_bvh8.py):
// the root is pushed first; popping a node tests its 8 child boxes with the
// slab test (tfar = the current hit distance, or t_max for any-hit) and
// pushes the hit children sorted by (entry distance, slot), far first.
// Popping a leaf runs Moller-Trumbore on its triangles in order (strict
// t < tfar, so the first of equal distances wins). A closest-hit entry
// whose entry distance exceeds the current hit when popped is dropped.
// Any-hit stops at the first hit; a ray with t_max <= t_min retires at once.
//
// Step counts (K7a): tpurt counts per 32x32 (x fat) packet, replicated over
// the packet's lanes, because its packet shares one stack. Here a thread
// owns its ray, so the counts are per ray: the node entries whose row the
// thread reads and the leaf entries whose triangles it tests. A popped
// entry dropped by the entry-distance test reads nothing and counts
// nothing. The warp (32 consecutive pixels of a row) plays the packet's
// part: it runs as long as its busiest lane, which is what the steps probe
// (tools/steps_probe.py) reads from these counts. They leave as f32 in u/v
// (closest hit, tpurt's contract) or in two extra planes (any hit);
// counting composes with one pop only.
//
// Push orders (K7a): ORDER_SORT is the order above; ORDER_NEARLAST pushes
// the hit children in slot order but holds the nearest one (the first slot
// of least entry distance) back and pushes it last, so it pops first;
// ORDER_NONE pushes in slot order, slot 7 on top. The closest hit's t and
// the occlusion do not depend on the order; tri may change on equal-t ties.
//
// The payload (K7c) is read once, at the end, from the winner's row of the
// (T, 9) uvp table (three corner uvs, image slot, tex_h, tex_w, in BVH
// leaf order): uv0 * w + uv1 * u + uv2 * v with w = 1 - u - v, the
// association of tpurt's per-update payload (:458-463) and of the shade
// pass's tex_coord, so all three are bit-equal. Miss lanes get 0, 0, 0, 1, 1.
#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

enum { ORDER_SORT = 0, ORDER_NEARLAST = 1, ORDER_NONE = 2 };

// slab-test the 8 children of node `code`; the hit ones in (entry
// distance, slot) order (stable insertion), or in slot order when not
// SORTED; returns how many
template <bool SORTED>
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
      while (SORTED && j > 0 && keys[j - 1] > tnear) {
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

// push the hit children in ORDER: SORT far-to-near (keys sorted, the
// nearest child ends on top); NONE in slot order (the last slot on top);
// NEARLAST in slot order with the first nearest child held back and pushed
// last
template <int ORDER>
__device__ __forceinline__ int push_children(int* code_stack,
                                             float* near_stack, int sp,
                                             const float keys[8],
                                             const int codes[8], int nh) {
  if (ORDER == ORDER_SORT) {
    for (int j = nh - 1; j >= 0; --j) {
      code_stack[sp] = codes[j];
      near_stack[sp] = keys[j];
      ++sp;
    }
    return sp;
  }
  int best = nh;
  if (ORDER == ORDER_NEARLAST && nh > 0) {
    best = 0;
    for (int j = 1; j < nh; ++j)
      if (keys[j] < keys[best]) best = j;
  }
  for (int j = 0; j < nh; ++j) {
    if (j == best) continue;
    code_stack[sp] = codes[j];
    near_stack[sp] = keys[j];
    ++sp;
  }
  if (best < nh) {
    code_stack[sp] = codes[best];
    near_stack[sp] = keys[best];
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

// any-hit leaf: true at the first hit
__device__ __forceinline__ bool leaf_any(const float* __restrict__ tris,
                                         int code, const Ray& r, float t_min,
                                         float t_max0) {
  int first, count;
  leaf_range(code, &first, &count);
  for (int j = first; j < first + count; ++j) {
    float tk, uk, vk;
    if (moller_trumbore(load_tri(tris, j), r, t_min, t_max0, &tk, &uk, &vk))
      return true;
  }
  return false;
}

template <bool ANY_HIT, bool POP2, bool UVP, bool COUNT_STEPS, int ORDER>
__global__ void __launch_bounds__(128)
bvh8_trace_kernel(const float* __restrict__ nodes,
                  const float* __restrict__ tris,
                  const float* __restrict__ uvp,
                  const float* __restrict__ origin,
                  const float* __restrict__ direction,
                  float t_min, const float* __restrict__ t_max_arr, int n,
                  float* __restrict__ t_out, int* __restrict__ tri_out,
                  float* __restrict__ u_out, float* __restrict__ v_out,
                  float* __restrict__ pay_out, uint8_t* __restrict__ occ_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const Ray r = make_ray(origin[3 * ray], origin[3 * ray + 1],
                         origin[3 * ray + 2], direction + 3 * ray);
  const float t_max0 = t_max_arr[ray];

  float t = t_max0, u = 0.0f, v = 0.0f;
  int tri = -1, row = -1;
  bool occ = false;
  int node_pops = 0, leaf_pops = 0;

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
    // pop the top entry (near) and, two-pop, the one below it (far)
    const int c0 = code_stack[sp - 1];
    const float n0 = near_stack[sp - 1];
    int c1 = 0;
    float n1 = 0.0f;
    bool has1 = false;
    if (POP2 && sp >= 2) {
      c1 = code_stack[sp - 2];
      n1 = near_stack[sp - 2];
      has1 = true;
    }
    sp -= has1 ? 2 : 1;
    // an entry's box was entered at its near distance; a closer hit found
    // since makes the parent's slab test fail for it now
    const bool live0 = ANY_HIT || n0 <= t;
    const bool live1 = has1 && (ANY_HIT || n1 <= t);
    if (COUNT_STEPS && live0) {
      if (c0 < 0) ++leaf_pops;
      else ++node_pops;
    }

    // leaf phase, the nearer entry first so its hit culls the other's tests
    if (live0 && c0 < 0) {
      if (ANY_HIT) {
        if (leaf_any(tris, c0, r, t_min, t_max0)) {
          occ = true;
          break;
        }
      } else {
        leaf_closest(tris, c0, r, t_min, &t, &u, &v, &tri, &row);
      }
    }
    if (POP2 && live1 && c1 < 0) {
      if (ANY_HIT) {
        if (leaf_any(tris, c1, r, t_min, t_max0)) {
          occ = true;
          break;
        }
      } else {
        leaf_closest(tris, c1, r, t_min, &t, &u, &v, &tri, &row);
      }
    }

    // node phase: both rows tested against the hit distance after the
    // leaf phase; the far entry's children go below the near entry's
    const float tfar = ANY_HIT ? t_max0 : t;
    float keys1[8], keys0[8];
    int codes1[8], codes0[8];
    int nh1 = 0, nh0 = 0;
    constexpr bool SORTED = ORDER == ORDER_SORT;
    if (POP2 && live1 && c1 >= 0)
      nh1 = node_children<SORTED>(nodes, c1, r, t_min, tfar, keys1, codes1);
    if (live0 && c0 >= 0)
      nh0 = node_children<SORTED>(nodes, c0, r, t_min, tfar, keys0, codes0);
    if (POP2)
      sp = push_children<ORDER>(code_stack, near_stack, sp, keys1, codes1,
                                nh1);
    sp = push_children<ORDER>(code_stack, near_stack, sp, keys0, codes0, nh0);
  }
  if (COUNT_STEPS) {
    u = (float)node_pops;
    v = (float)leaf_pops;
  }
  if (ANY_HIT) {
    occ_out[ray] = occ ? 1 : 0;
    if (COUNT_STEPS) {
      u_out[ray] = u;
      v_out[ray] = v;
    }
    return;
  }
  t_out[ray] = t;
  tri_out[ray] = tri;
  u_out[ray] = u;
  v_out[ray] = v;
  if (UVP) {
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
}

template <bool ANY_HIT, bool POP2, bool UVP, bool COUNT_STEPS = false,
          int ORDER = ORDER_SORT>
void launch(const float* nodes, const float* tris, const float* uvp,
            const float* origin, const float* direction, float t_min,
            const float* t_max, int n, float* t_out, int* tri_out,
            float* u_out, float* v_out, float* pay_out, uint8_t* occ_out,
            cudaStream_t stream) {
  bvh8_trace_kernel<ANY_HIT, POP2, UVP, COUNT_STEPS, ORDER>
      <<<(n + 127) / 128, 128, 0, stream>>>(nodes, tris, uvp, origin,
                                            direction, t_min, t_max, n,
                                            t_out, tri_out, u_out, v_out,
                                            pay_out, occ_out);
}

// K7a: one-pop traversal with step counts and/or another push order; an
// uncounted "sort" closest hit is K1 (bvh8_closest.cu)
template <bool ANY_HIT, bool COUNT_STEPS>
void launch_k7a(int order, const float* nodes, const float* tris,
                const float* origin, const float* direction, float t_min,
                const float* t_max, int n, float* t_out, int* tri_out,
                float* u_out, float* v_out, uint8_t* occ_out,
                cudaStream_t stream) {
  if (order == ORDER_NEARLAST)
    launch<ANY_HIT, false, false, COUNT_STEPS, ORDER_NEARLAST>(
        nodes, tris, nullptr, origin, direction, t_min, t_max, n, t_out,
        tri_out, u_out, v_out, nullptr, occ_out, stream);
  else if (order == ORDER_NONE)
    launch<ANY_HIT, false, false, COUNT_STEPS, ORDER_NONE>(
        nodes, tris, nullptr, origin, direction, t_min, t_max, n, t_out,
        tri_out, u_out, v_out, nullptr, occ_out, stream);
  else if constexpr (COUNT_STEPS || ANY_HIT)
    launch<ANY_HIT, false, false, COUNT_STEPS, ORDER_SORT>(
        nodes, tris, nullptr, origin, direction, t_min, t_max, n, t_out,
        tri_out, u_out, v_out, nullptr, occ_out, stream);
}

// the orders K7a takes: any with counting, "nearlast" / "none" without
// (an uncounted "sort" closest hit is K1, bvh8_closest.cu); an any hit
// takes every order
bool k7a_valid(int count_steps, int order, bool any_hit) {
  return order >= ORDER_SORT && order <= ORDER_NONE &&
         (count_steps || any_hit || order != ORDER_SORT);
}

}  // namespace

extern "C" {

const char* tpurt_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// closest hit over the rows: pop2 selects K7b, payload (with pay_out
// (5, n) f32: texu, texv, img, texh, texw) K7c; exactly one of the two (the
// closest hit with neither is K1, bvh8_closest.cu)
int tpurt_bvh8_closest(const float* nodes, const float* tris,
                       const float* uvp, const float* origin,
                       const float* direction, float t_min,
                       const float* t_max, int n, int pop2, int payload,
                       float* t_out, int* tri_out, float* u_out,
                       float* v_out, float* pay_out, cudaStream_t stream) {
  if (!pop2 == !payload) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (pop2)
      launch<false, true, false>(nodes, tris, uvp, origin, direction, t_min,
                                 t_max, n, t_out, tri_out, u_out, v_out,
                                 pay_out, nullptr, stream);
    else
      launch<false, false, true>(nodes, tris, uvp, origin, direction, t_min,
                                 t_max, n, t_out, tri_out, u_out, v_out,
                                 pay_out, nullptr, stream);
  }
  return (int)cudaGetLastError();
}

// K7b any hit: two pops per iteration, sorted pushes
int tpurt_bvh8_any_pop2(const float* nodes, const float* tris,
                        const float* origin, const float* direction,
                        float t_min, const float* t_max, int n,
                        uint8_t* occ_out, cudaStream_t stream) {
  if (n > 0)
    launch<true, true, false>(nodes, tris, nullptr, origin, direction, t_min,
                              t_max, n, nullptr, nullptr, nullptr, nullptr,
                              nullptr, occ_out, stream);
  return (int)cudaGetLastError();
}

// K7a, one pop: order 0 sort, 1 nearlast, 2 none; with count_steps the
// node and leaf pops land in u_out / v_out (f32), for any hit beside occ.
// An uncounted "sort" closest hit is refused: it is tpurt_bvh8_closest.
int tpurt_bvh8_closest_k7a(const float* nodes, const float* tris,
                           const float* origin, const float* direction,
                           float t_min, const float* t_max, int n,
                           int count_steps, int order, float* t_out,
                           int* tri_out, float* u_out, float* v_out,
                           cudaStream_t stream) {
  if (!k7a_valid(count_steps, order, false))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (count_steps)
      launch_k7a<false, true>(order, nodes, tris, origin, direction, t_min,
                              t_max, n, t_out, tri_out, u_out, v_out,
                              nullptr, stream);
    else
      launch_k7a<false, false>(order, nodes, tris, origin, direction, t_min,
                               t_max, n, t_out, tri_out, u_out, v_out,
                               nullptr, stream);
  }
  return (int)cudaGetLastError();
}

int tpurt_bvh8_any_k7a(const float* nodes, const float* tris,
                       const float* origin, const float* direction,
                       float t_min, const float* t_max, int n,
                       int count_steps, int order, uint8_t* occ_out,
                       float* node_out, float* leaf_out,
                       cudaStream_t stream) {
  if (!k7a_valid(count_steps, order, true))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    if (count_steps)
      launch_k7a<true, true>(order, nodes, tris, origin, direction, t_min,
                             t_max, n, nullptr, nullptr, node_out, leaf_out,
                             occ_out, stream);
    else
      launch_k7a<true, false>(order, nodes, tris, origin, direction, t_min,
                              t_max, n, nullptr, nullptr, nullptr, nullptr,
                              occ_out, stream);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
