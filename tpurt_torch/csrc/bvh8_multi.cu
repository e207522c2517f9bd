// Fused multi-set BVH8 any-hit traversal (K5, and K5p with two pops per
// iteration) written for Hopper, one thread per pixel.
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
// that are still live (not occluded, t_max > t_min) and pushes a hit child
// once, with the mask of the sets that hit it; a popped leaf runs
// Moller-Trumbore for the live sets of its mask, each set stopping at its
// first hit. So every set visits exactly the nodes and leaves it would visit
// alone, and its occlusion is bit-equal to K2 run once per set (bvh8_any.cu)
// - also on grazing rays, where a triangle test accepts a hit whose
// enclosing box the ray's own slab test rejects by a rounding: there a
// mask-free union would find an occluder that K2 cannot reach. The thread
// retires when every set is occluded or dead, or the stack is empty.
//
// What bounds it on an H100: K2's divergent, latency-bound row loads, now
// shared by the S sets, and the sets' slab and triangle tests, as many as
// K2 runs for them one set at a time (it takes about K2's time for the S
// launches, PERF.md). The design takes K2's answers and adds the sets':
//   * the compact node table nodes8c (bvh/wide.py compact_bvh8), read in
//     two halves of 4 children (six plane loads and one code load each),
//     codes precomputed, the second half's planes only when it holds a
//     child (slots fill in order): at most 224 bytes per node pop, against
//     the nodes8 row's 288 bytes and 8 float-to-int conversions before;
//   * a child's six plane - origin differences computed once for all sets
//     (they share the origin), then each set's products and its slab
//     reduction (bvh8_common.cuh slab_t: tpurt's order, bits unchanged),
//     set by set over a half node's 4 children (and a leaf batch's rows),
//     so that a warp skips a set that none of its lanes needs there;
//   * one 8-byte stack entry (code, set mask): one store per push and one
//     load per pop; STACK entries, the least instantiation that holds
//     kernels/traverse_bvh8.stack_entries(depth8, pops); a popped entry
//     whose sets were all occluded since its push is skipped in a tight
//     loop (one pop);
//   * pushes in slot order straight from the slab tests, slot 7 on top (K2's
//     order "none"): occlusion does not depend on the visit order;
//   * a leaf's triangle rows MULTI_LEAF_BATCH at a time, every row of a
//     batch loaded before the first test;
//   * when the rays are a frame's pixels (tile_w > 0, the frame's width) a
//     block covers a 16x8 pixel tile, each warp 8x4 pixels, so a warp's
//     shadow rays start close together and share nodes; rays and the mask
//     stay in pixel order;
//   * min_blocks() blocks of 128 per SM for each instantiation: the most
//     that ptxas fits without spills (tools/ptxas_sweep.py, PERF.md).
//
// The two-pop variant (K5p) pops up to two entries per iteration: leaf
// work for both first (the top entry's rows, then the lower one's, batched
// across the two leaves, so both leaves' rows are in flight before the
// first test), then node work, the lower entry's children pushed first
// (tpurt's order, traverse_bvh8.py:949-1102), both nodes' first halves
// loaded before either is tested. Its stack needs 14 * depth - 6 entries.
//
// The wrapper launches at most MULTI_SETS_MAX sets at a time and splits a
// larger S into launches of at most that many sets (occlusion per set does
// not depend on the other sets).
#include "bvh8_common.cuh"

#define MULTI_SETS_MAX 4
// triangle rows of a leaf step loaded together: 2, measured against
// bvh8_common.cuh's LEAF_BATCH of 4 (PERF.md): with S sets each row is
// tested S times, and the smaller batch leaves room for more blocks per SM
#define MULTI_LEAF_BATCH 2

namespace {

using namespace bvh8;

// blocks of 128 per SM that ptxas must fit (__launch_bounds__): the most it
// fits without spills per instantiation, read from tools/ptxas_sweep.py on
// the H100 build (PERF.md; the stack size changes nothing but the frame).
// One pop, 1-4 sets: 8 (60 registers), 7 (72), 6 (80), 5 (96); two pops:
// 5 (93), 4 (128), 4 (128), 4 (128). -DK5_MIN_BLOCKS=N sets them all, for
// the sweep.
template <int NS, bool POP2>
constexpr int min_blocks() {
#ifdef K5_MIN_BLOCKS
  return K5_MIN_BLOCKS;
#else
  constexpr int one_pop[4] = {8, 7, 6, 5}, two_pops[4] = {5, 4, 4, 4};
  return POP2 ? two_pops[NS - 1] : one_pop[NS - 1];
#endif
}

struct Args {
  const float* nodes8c;
  const float* tris;
  const float* origin;
  const float* dirs;  // (S, n, 3)
  float t_min;
  const float* t_maxs;  // (S, n)
  int n;
  int tile_w;
  uint8_t* occ_out;  // (S, n)
};

// slab-test the 4 children of a half node (b: six planes of 4) for the
// sets of `mask` and push each hit child once with the sets that hit it, in
// slot order (the last on top); one 8-byte store per push. The plane -
// origin differences are common to all sets (they share the origin); each
// set then takes its products and its slab reduction, set by set, so that
// a warp skips a set that none of its lanes needs here.
template <int NS>
__device__ __forceinline__ void push_half(float b[24], const int codes[4],
                                          const Ray* rays, float t_min,
                                          const float* t_max, unsigned mask,
                                          int2* stack, int& sp) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j] -= rays[0].ox;
    b[12 + j] -= rays[0].ox;
    b[4 + j] -= rays[0].oy;
    b[16 + j] -= rays[0].oy;
    b[8 + j] -= rays[0].oz;
    b[20 + j] -= rays[0].oz;
  }
  unsigned h[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    if (!((mask >> s) & 1u)) continue;
    const Ray& r = rays[s];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float tn;
      if (slab_t(b[j] * r.ix, b[12 + j] * r.ix, b[4 + j] * r.iy,
                 b[16 + j] * r.iy, b[8 + j] * r.iz, b[20 + j] * r.iz, t_min,
                 t_max[s], &tn))
        h[j] |= 1u << s;
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (codes[j] != EMPTY_CODE && h[j])
      stack[sp++] = make_int2(codes[j], (int)h[j]);
}

// both halves of node `code` for the sets of `mask`: the 8 codes and the
// first half's planes loaded together, the second half's planes only when
// it holds a child (slots fill in order, so about half of the bench tree's
// nodes have an empty second half)
template <int NS>
__device__ __forceinline__ void push_node(const float* __restrict__ nodes8c,
                                          int code, const Ray* rays,
                                          float t_min, const float* t_max,
                                          unsigned mask, int2* stack,
                                          int& sp) {
  float b[24];
  int c0[4], c1[4];
  load_codes(nodes8c, code, 0, c0);
  load_codes(nodes8c, code, 1, c1);
  load_planes(nodes8c, code, 0, b);
  push_half<NS>(b, c0, rays, t_min, t_max, mask, stack, sp);
  if (all_empty(c1)) return;
  load_planes(nodes8c, code, 1, b);
  push_half<NS>(b, c1, rays, t_min, t_max, mask, stack, sp);
}

// Moller-Trumbore over up to two leaves' rows (count0 rows from first0 for
// the sets of m0, then count1 from first1 for m1), MULTI_LEAF_BATCH rows
// at a time across the two, every row of a batch loaded before the first
// test; a set stops at its first hit. Returns the sets that hit.
template <int NS>
__device__ __forceinline__ unsigned leaf_sets(const float* __restrict__ tris,
                                              int first0, int count0,
                                              unsigned m0, int first1,
                                              int count1, unsigned m1,
                                              const Ray* rays, float t_min,
                                              const float* t_max) {
  unsigned hit = 0;
  const int end = m1 ? count0 + count1 : count0;
  int i = m0 ? 0 : count0;
  while (i < end) {
    // past the end, the last row again (untested)
    Tri q[MULTI_LEAF_BATCH];
    unsigned qm[MULTI_LEAF_BATCH];
#pragma unroll
    for (int b = 0; b < MULTI_LEAF_BATCH; ++b) {
      const int k = min(i + b, end - 1);
      q[b] = load_tri(tris, k < count0 ? first0 + k : first1 + k - count0);
      qm[b] = i + b < end ? (k < count0 ? m0 : m1) : 0u;
    }
    // set by set, so that a warp skips a set that none of its lanes needs
    unsigned want = 0, h = 0;
#pragma unroll
    for (int b = 0; b < MULTI_LEAF_BATCH; ++b) want |= qm[b];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      if (!((want >> s) & 1u)) continue;
#pragma unroll
      for (int b = 0; b < MULTI_LEAF_BATCH; ++b) {
        float tk, uk, vk;
        if (moller_trumbore(q[b], rays[s], t_min, t_max[s], &tk, &uk, &vk) &&
            (qm[b] >> s) & 1u)
          h |= 1u << s;
      }
    }
    hit |= h;
    m0 &= ~h;
    m1 &= ~h;
    i += MULTI_LEAF_BATCH;
    if (i < count0 && !m0) i = count0;
    if (i >= count0 && !m1) break;
  }
  return hit;
}

template <int NS, bool POP2, int STACK>
__global__ void __launch_bounds__(TILE_THREADS, (min_blocks<NS, POP2>()))
bvh8_any_multi_kernel(const Args a) {
  int2 stack[STACK];  // (code, set mask)

  const int ray = tile_ray_index(a.n, a.tile_w);
  if (ray < 0) return;
  const float ox = a.origin[3 * ray], oy = a.origin[3 * ray + 1],
              oz = a.origin[3 * ray + 2];
  Ray rays[NS];
  float t_max[NS];
  unsigned live = 0;  // sets not yet occluded with t_max > t_min
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    rays[s] = make_ray(ox, oy, oz, a.dirs + (size_t)s * 3 * a.n + 3 * ray);
    t_max[s] = a.t_maxs[(size_t)s * a.n + ray];
    if (t_max[s] > a.t_min) live |= 1u << s;
  }
  unsigned occ = 0;
  int sp = 0;
  if (live) stack[sp++] = make_int2(0, (int)live);

  while (sp > 0) {
    int2 e0 = stack[--sp];
    // one pop: entries whose sets have all been occluded since their push
    // are skipped here (the live entries keep their order)
    if (!POP2)
      while (!((unsigned)e0.y & live) && sp > 0) e0 = stack[--sp];
    int2 e1 = make_int2(0, 0);
    if (POP2 && sp > 0) e1 = stack[--sp];
    unsigned m0 = (unsigned)e0.y & live, m1 = (unsigned)e1.y & live;

    // leaf phase: the top entry first
    const bool leaf0 = m0 && e0.x < 0, leaf1 = POP2 && m1 && e1.x < 0;
    if (leaf0 || leaf1) {
      int f0 = 0, n0 = 0, f1 = 0, n1 = 0;
      if (leaf0) leaf_range(e0.x, &f0, &n0);
      if (leaf1) leaf_range(e1.x, &f1, &n1);
      const unsigned h = leaf_sets<NS>(a.tris, f0, n0, leaf0 ? m0 : 0u, f1,
                                       n1, leaf1 ? m1 : 0u, rays, a.t_min,
                                       t_max);
      occ |= h;
      live &= ~h;
      if (!live) break;
      m0 &= live;
      m1 &= live;
    }

    // node phase: the lower entry's children pushed first
    const bool node0 = m0 && e0.x >= 0, node1 = POP2 && m1 && e1.x >= 0;
    if (POP2 && node0 && node1) {
      float b0[24], b1[24];
      int c0[4], d0[4], c1[4], d1[4];
      load_codes(a.nodes8c, e1.x, 0, c1);
      load_codes(a.nodes8c, e1.x, 1, d1);
      load_codes(a.nodes8c, e0.x, 0, c0);
      load_codes(a.nodes8c, e0.x, 1, d0);
      load_planes(a.nodes8c, e1.x, 0, b1);
      load_planes(a.nodes8c, e0.x, 0, b0);
      push_half<NS>(b1, c1, rays, a.t_min, t_max, m1, stack, sp);
      if (!all_empty(d1)) {
        load_planes(a.nodes8c, e1.x, 1, b1);
        push_half<NS>(b1, d1, rays, a.t_min, t_max, m1, stack, sp);
      }
      push_half<NS>(b0, c0, rays, a.t_min, t_max, m0, stack, sp);
      if (!all_empty(d0)) {
        load_planes(a.nodes8c, e0.x, 1, b0);
        push_half<NS>(b0, d0, rays, a.t_min, t_max, m0, stack, sp);
      }
    } else if (node0 || node1) {
      push_node<NS>(a.nodes8c, node0 ? e0.x : e1.x, rays, a.t_min, t_max,
                    node0 ? m0 : m1, stack, sp);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s)
    a.occ_out[(size_t)s * a.n + ray] = (occ >> s) & 1u;
}

template <int NS, bool POP2, int STACK>
int launch(const Args& a, cudaStream_t stream) {
  bvh8_any_multi_kernel<NS, POP2, STACK>
      <<<tile_blocks(a.n, a.tile_w), TILE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation for a stack size: 48 (one pop) or 64 (two pops) entries,
// or 192
template <int NS, bool POP2>
int launch_stack(const Args& a, int stack, cudaStream_t s) {
  constexpr int SMALL = POP2 ? 64 : 48;
  if (stack == SMALL) return launch<NS, POP2, SMALL>(a, s);
  if (stack == 192) return launch<NS, POP2, 192>(a, s);
  return (int)cudaErrorInvalidValue;
}

template <int NS>
int launch_sets(const Args& a, bool pop2, int stack, cudaStream_t s) {
  return pop2 ? launch_stack<NS, true>(a, stack, s)
              : launch_stack<NS, false>(a, stack, s);
}

}  // namespace

extern "C" {

// K5 / K5p: occlusion of n_sets ray sets over the compact node table (M, 56)
// f32 (codes bit-cast): dirs (n_sets, n, 3), t_maxs and occ_out (n_sets,
// n), all contiguous; 1 <= n_sets <= MULTI_SETS_MAX. stack_size: 48 (one
// pop), 64 (two pops) or 192 entries (the wrapper picks it from the tree's
// depth); tile_w: 0 for consecutive rays, else the frame's width (n =
// tile_w * H).
int tpurt_bvh8_any_multi(const float* nodes8c, const float* tris,
                         const float* origin, const float* dirs, float t_min,
                         const float* t_maxs, int n, int n_sets, int pop2,
                         int stack_size, int tile_w, uint8_t* occ_out,
                         cudaStream_t stream) {
  if (n_sets < 1 || n_sets > MULTI_SETS_MAX || tile_w < 0 ||
      (tile_w > 0 && n % tile_w != 0))
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const Args a{nodes8c, tris, origin, dirs, t_min, t_maxs, n, tile_w,
               occ_out};
  switch (n_sets) {
    case 1:
      return launch_sets<1>(a, pop2, stack_size, stream);
    case 2:
      return launch_sets<2>(a, pop2, stack_size, stream);
    case 3:
      return launch_sets<3>(a, pop2, stack_size, stream);
    default:
      return launch_sets<4>(a, pop2, stack_size, stream);
  }
}

}  // extern "C"
