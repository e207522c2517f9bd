// BVH8 traversal variants written for Hopper over the compact node table,
// one thread per ray: K7a (step counts and push orders) and K7b (two pops
// per iteration), each as a closest hit and as an any hit.
//
// Replaces tpurt/kernels/traverse_bvh8.py::_kernel_bvh8 (K7a:
// count_steps, push_order) and ::_kernel_bvh8_pop2 (K7b: pop2=True, push
// order "sort"). It computes what those kernels compute (t, tri, u, v or
// the occlusion mask, and per-ray node and leaf pops), not how: the TPU
// kernels walk a 32x32 ray packet behind one scalar stack with a Batcher
// sort on scalars and count per packet; here each thread owns its ray, its
// stack and its counts. K1 (bvh8_closest.cu) and K2 (bvh8_any.cu) are the
// same traversals at their default orders, uncounted, one pop; this file
// takes their design and adds the variants' template parameters:
//   POP2         two stack entries per iteration (K7b);
//   COUNT_STEPS  the node and leaf entries a ray visits (K7a);
//   ORDER        the push order of a node's hit children (K7a).
//
// What bounds it on an H100: K1's and K2's divergent, latency-bound loads
// of node halves and triangle rows with little arithmetic between them.
// The design is theirs:
//   * the compact node table nodes8c (bvh8_common.cuh), read in halves of
//     4 children: both halves' codes and the first half's planes together,
//     the second half's planes only when it holds a child (slots fill in
//     order; 312 of the bench tree's 540 nodes have an empty second half);
//     at most 224 bytes and no conversion per node pop;
//   * the push orders in registers, over static slot indices: "sort" is
//     K1's rank count (child i goes below every hit child j with a smaller
//     entry distance, or an equal one and j < i: the permutation of a
//     stable insertion sort, the nearest on top); "nearlast" pushes in slot
//     order and holds back the first slot of least entry distance (a strict
//     < over ascending slots), pushed last so that it pops first; "none"
//     pushes in slot order, slot 7 on top, straight from the slab tests;
//   * one stack entry per push: the closest hit's (code, entry distance
//     bits) as one 8-byte store, the any hit's code alone (an any hit reads
//     its entry distances only to order its pushes); STACK entries, the
//     least instantiation that holds kernels/traverse_bvh8.stack_entries(
//     depth8, pops) (48 or 192 with one pop, 64 or 192 with two); a
//     closest-hit entry whose entry distance lies beyond the current hit
//     when popped is dropped without a fetch and counts nothing;
//   * a leaf's triangle rows LEAF_BATCH at a time, every row of a batch
//     loaded before the first test, then the strict-less updates in
//     triangle order (so the first of equal distances wins);
//   * min_blocks() blocks of 128 per SM for each kernel: the most that
//     ptxas fits without spills (tools/ptxas_sweep.py, PERF.md);
//   * when the rays are a frame's pixels (tile_w > 0, the frame's width) a
//     block covers a 16x8 pixel tile, each warp 8x4 pixels, so a warp's
//     rays stay close together and share nodes; rays and outputs stay in
//     pixel order.
//
// Two pops (K7b) keep tpurt's iteration (traverse_bvh8.py:497-769; the
// plain _trace_plain): the top entry and the one below it are popped, and
// both are taken live or dropped against the hit distance before any leaf
// work; the leaf work runs on the top entry first, then on the lower one
// (both leaves' rows in one batch sequence, so both are in flight before
// the first test); both nodes are slab-tested against the hit distance
// left after the leaf work, and the lower entry's children are pushed
// first. The nodes go through one inlined node test, a loop of at most two
// turns: holding both nodes' halves in flight measured no faster, and one
// copy of the node test instead of three takes 11-19 fewer registers and
// 2-7% less time (PERF.md). Its stack needs 14 * depth - 6 entries.
// Counting composes with one pop only, and the two-pop order is "sort"
// (tpurt's rules, kernels/traverse_bvh8.py).
//
// Step counts (K7a): per ray, the node entries whose halves the thread
// reads and the leaf entries whose rows it tests; they leave as f32 in u/v
// (closest hit, tpurt's contract) or in two extra planes (any hit).
//
// Bits: the slab test and Moller-Trumbore are bvh8_common.cuh's, tpurt's
// operation order, built with --fmad=false. The visit order is the plain
// version's (kernels/traverse_bvh8.py, over nodes8c), so every output
// equals it bit for bit; the closest hit's t and the occlusion do not
// depend on the order or the pops, tri may differ from K1's on equal-t
// ties.
#include "bvh8_common.cuh"

namespace {

using namespace bvh8;

enum { ORDER_SORT = 0, ORDER_NEARLAST = 1, ORDER_NONE = 2 };

// blocks of 128 per SM that ptxas must fit (__launch_bounds__): the most it
// fits without spills in every instantiation of a kernel, read from
// tools/ptxas_sweep.py on the H100 build (PERF.md; the stack size, the
// order, counting and the pops change nothing but the frame and a few
// registers). Closest hit: 6
// (76-80 registers); any hit: 7 (67-72); each spills at one block more.
// -DK7_MIN_BLOCKS=N sets them all, for the sweep.
template <bool ANY>
constexpr int min_blocks() {
#ifdef K7_MIN_BLOCKS
  return K7_MIN_BLOCKS;
#else
  return ANY ? 7 : 6;
#endif
}

// a stack entry: the closest hit's (code, entry distance bits), the any
// hit's code
template <bool ANY>
struct Entry {
  using T = int2;
  static __device__ __forceinline__ T make(int code, float near) {
    return make_int2(code, __float_as_int(near));
  }
};
template <>
struct Entry<true> {
  using T = int;
  static __device__ __forceinline__ T make(int code, float) { return code; }
};

struct Args {
  const float* nodes8c;
  const float* tris;
  const float* origin;
  const float* direction;
  float t_min;
  const float* t_max;
  int n;
  int tile_w;
  float* t_out;     // closest hit
  int* tri_out;     // closest hit
  float* u_out;     // closest hit: u, or node pops when counting
  float* v_out;     // closest hit: v, or leaf pops when counting
  uint8_t* occ_out; // any hit
  float* node_out;  // any hit, counting
  float* leaf_out;  // any hit, counting
};

// slab-test the 4 children of half `half` (planes b, codes c): hit, entry
// distance and code of slots 4 * half .. 4 * half + 3
__device__ __forceinline__ void test_half(const float b[24], const int c[4],
                                          int half, const Ray& r,
                                          float t_min, float tfar,
                                          bool hit[8], float key[8],
                                          int child[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * half + j;
    hit[k] = slab_soa(b, j, r, t_min, tfar, &key[k]) && c[j] != EMPTY_CODE;
    child[k] = c[j];
  }
}

// push the hit slots lo .. hi - 1 in slot order, the last on top
template <bool ANY, int LO, int HI>
__device__ __forceinline__ void push_slots(typename Entry<ANY>::T* stack,
                                           int& sp, const bool hit[8],
                                           const float key[8],
                                           const int child[8]) {
#pragma unroll
  for (int k = LO; k < HI; ++k)
    if (hit[k]) stack[sp++] = Entry<ANY>::make(child[k], key[k]);
}

// push the hit children of a node in ORDER "sort" (far to near, equal
// distances in slot order, the nearest on top) or "nearlast" (slot order,
// the first slot of least distance held back and pushed last); every index
// into hit/key/child is static
template <bool ANY, int ORDER>
__device__ __forceinline__ void push_ordered(typename Entry<ANY>::T* stack,
                                             int& sp, const bool hit[8],
                                             const float key[8],
                                             const int child[8]) {
  if (ORDER == ORDER_SORT) {
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
        stack[sp + nh - 1 - rank] = Entry<ANY>::make(child[i], key[i]);
    }
    sp += nh;
    return;
  }
  // nearlast: a hit child's distance is never NaN (its slab test passed)
  bool found = false;
  int best = 0, best_code = 0;
  float best_key = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (hit[k] && (!found || key[k] < best_key)) {
      found = true;
      best = k;
      best_key = key[k];
      best_code = child[k];
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if (hit[k] && k != best) stack[sp++] = Entry<ANY>::make(child[k], key[k]);
  if (found) stack[sp++] = Entry<ANY>::make(best_code, best_key);
}

// one node pop: test node `code`'s children and push the hit ones in
// ORDER. Both halves' codes and the first half's planes are loaded
// together, the second half's planes only when that half holds a child.
template <bool ANY, int ORDER>
__device__ __forceinline__ void visit_node(const float* __restrict__ nodes8c,
                                           int code, const Ray& r,
                                           float t_min, float tfar,
                                           typename Entry<ANY>::T* stack,
                                           int& sp) {
  float b[24];
  int c0[4], c1[4];
  load_codes(nodes8c, code, 0, c0);
  load_codes(nodes8c, code, 1, c1);
  load_planes(nodes8c, code, 0, b);
  bool hit[8];
  float key[8];
  int child[8];
  test_half(b, c0, 0, r, t_min, tfar, hit, key, child);
  if (ORDER == ORDER_NONE) push_slots<ANY, 0, 4>(stack, sp, hit, key, child);
  if (all_empty(c1)) {
#pragma unroll
    for (int k = 4; k < 8; ++k) {
      hit[k] = false;
      key[k] = 0.0f;
      child[k] = EMPTY_CODE;
    }
  } else {
    load_planes(nodes8c, code, 1, b);
    test_half(b, c1, 1, r, t_min, tfar, hit, key, child);
  }
  if (ORDER == ORDER_NONE)
    push_slots<ANY, 4, 8>(stack, sp, hit, key, child);
  else
    push_ordered<ANY, ORDER>(stack, sp, hit, key, child);
}

// the triangle row of position k in the sequence of up to two leaves
// (count0 rows from first0, then the rows from first1)
template <bool TWO>
__device__ __forceinline__ int leaf_row(int k, int first0, int count0,
                                        int first1) {
  return !TWO || k < count0 ? first0 + k : first1 + (k - count0);
}

// closest-hit leaf work over count0 rows from first0, then count1 rows
// from first1 (TWO: two pops), LEAF_BATCH rows at a time, every row of a
// batch loaded before the first test (past the end, the last row again,
// untested); then the strict-less updates in row order
template <bool TWO>
__device__ __forceinline__ void leaf_closest(const float* __restrict__ tris,
                                             int first0, int count0,
                                             int first1, int count1,
                                             const Ray& r, float t_min,
                                             float& t, float& u, float& v,
                                             int& tri) {
  const int end = count0 + count1;
  for (int i = 0; i < end; i += LEAF_BATCH) {
    Tri q[LEAF_BATCH];
#pragma unroll
    for (int b = 0; b < LEAF_BATCH; ++b)
      q[b] = load_tri(tris, leaf_row<TWO>(min(i + b, end - 1), first0,
                                          count0, first1));
#pragma unroll
    for (int b = 0; b < LEAF_BATCH; ++b) {
      float tk, uk, vk;
      if (i + b < end && moller_trumbore(q[b], r, t_min, t, &tk, &uk, &vk)) {
        t = tk;
        u = uk;
        v = vk;
        tri = (int)q[b].id;
      }
    }
  }
}

// any-hit leaf work over the same row sequence: true at the first batch
// that hits (past the end, the last row again: occlusion does not depend
// on the order of the tests or on tests past the first hit)
template <bool TWO>
__device__ __forceinline__ bool leaf_any(const float* __restrict__ tris,
                                         int first0, int count0, int first1,
                                         int count1, const Ray& r,
                                         float t_min, float t_max0) {
  const int end = count0 + count1;
  for (int i = 0; i < end; i += LEAF_BATCH) {
    Tri q[LEAF_BATCH];
#pragma unroll
    for (int b = 0; b < LEAF_BATCH; ++b)
      q[b] = load_tri(tris, leaf_row<TWO>(min(i + b, end - 1), first0,
                                          count0, first1));
    bool hit = false;
#pragma unroll
    for (int b = 0; b < LEAF_BATCH; ++b) {
      float tk, uk, vk;
      hit = hit || moller_trumbore(q[b], r, t_min, t_max0, &tk, &uk, &vk);
    }
    if (hit) return true;
  }
  return false;
}

template <int STACK, bool POP2, bool COUNT_STEPS, int ORDER>
__global__ void __launch_bounds__(TILE_THREADS, (min_blocks<false>()))
bvh8_closest_variant_kernel(const Args a) {
  int2 stack[STACK];

  const int ray = tile_ray_index(a.n, a.tile_w);
  if (ray < 0) return;
  const Ray r = make_ray(a.origin[3 * ray], a.origin[3 * ray + 1],
                         a.origin[3 * ray + 2], a.direction + 3 * ray);
  float t = a.t_max[ray], u = 0.0f, v = 0.0f;
  int tri = -1;
  int node_pops = 0, leaf_pops = 0;

  stack[0] = make_int2(0, __float_as_int(-INFINITY));
  int sp = 1;
  while (sp > 0) {
    const int2 e0 = stack[--sp];
    // an entry's box was entered at its distance; a closer hit found since
    // makes the parent's slab test fail for it now
    const bool live0 = __int_as_float(e0.y) <= t;
    if (!POP2) {
      if (!live0) continue;
      if (COUNT_STEPS) ++(e0.x < 0 ? leaf_pops : node_pops);
      if (e0.x < 0) {
        int first, count;
        leaf_range(e0.x, &first, &count);
        leaf_closest<false>(a.tris, first, count, 0, 0, r, a.t_min, t, u, v,
                            tri);
      } else {
        visit_node<false, ORDER>(a.nodes8c, e0.x, r, a.t_min, t, stack, sp);
      }
      continue;
    }
    // two pops: both entries taken live or dropped before any leaf work
    int2 e1 = make_int2(0, 0);
    bool live1 = false;
    if (sp > 0) {
      e1 = stack[--sp];
      live1 = __int_as_float(e1.y) <= t;
    }
    const bool leaf0 = live0 && e0.x < 0, leaf1 = live1 && e1.x < 0;
    if (leaf0 || leaf1) {
      int f0 = 0, n0 = 0, f1 = 0, n1 = 0;
      if (leaf0) leaf_range(e0.x, &f0, &n0);
      if (leaf1) leaf_range(e1.x, &f1, &n1);
      leaf_closest<true>(a.tris, f0, n0, f1, n1, r, a.t_min, t, u, v, tri);
    }
    // both nodes against the hit distance left after the leaf work, the
    // lower entry's first, through one copy of the node test
    const bool node0 = live0 && e0.x >= 0, node1 = live1 && e1.x >= 0;
    const int lower = node1 ? e1.x : e0.x;
#pragma unroll 1
    for (int i = 0; i < (int)node0 + (int)node1; ++i)
      visit_node<false, ORDER_SORT>(a.nodes8c, i == 0 ? lower : e0.x, r,
                                    a.t_min, t, stack, sp);
  }
  if (COUNT_STEPS) {
    u = (float)node_pops;
    v = (float)leaf_pops;
  }
  a.t_out[ray] = t;
  a.tri_out[ray] = tri;
  a.u_out[ray] = u;
  a.v_out[ray] = v;
}

template <int STACK, bool POP2, bool COUNT_STEPS, int ORDER>
__global__ void __launch_bounds__(TILE_THREADS, (min_blocks<true>()))
bvh8_any_variant_kernel(const Args a) {
  int stack[STACK];

  const int ray = tile_ray_index(a.n, a.tile_w);
  if (ray < 0) return;
  const float t_max0 = a.t_max[ray];
  bool occ = false;
  int node_pops = 0, leaf_pops = 0;
  // a ray with t_max <= t_min can hit nothing: it retires at once
  if (t_max0 > a.t_min) {
    const Ray r = make_ray(a.origin[3 * ray], a.origin[3 * ray + 1],
                           a.origin[3 * ray + 2], a.direction + 3 * ray);
    stack[0] = 0;
    int sp = 1;
    while (sp > 0) {
      const int c0 = stack[--sp];
      int c1 = 0;
      bool has1 = false;
      if (POP2 && sp > 0) {
        c1 = stack[--sp];
        has1 = true;
      }
      if (COUNT_STEPS) ++(c0 < 0 ? leaf_pops : node_pops);
      // leaf work, the top entry first; the first hit ends the ray
      const bool leaf1 = has1 && c1 < 0;
      if (c0 < 0 || leaf1) {
        int f0 = 0, n0 = 0, f1 = 0, n1 = 0;
        if (c0 < 0) leaf_range(c0, &f0, &n0);
        if (leaf1) leaf_range(c1, &f1, &n1);
        if (leaf_any<POP2>(a.tris, f0, n0, f1, n1, r, a.t_min, t_max0)) {
          occ = true;
          break;
        }
      }
      if (!POP2) {
        if (c0 >= 0)
          visit_node<true, ORDER>(a.nodes8c, c0, r, a.t_min, t_max0, stack,
                                  sp);
        continue;
      }
      // two pops: the lower entry's node first, through one copy of the
      // node test
      const bool node1 = has1 && c1 >= 0;
      const int lower = node1 ? c1 : c0;
#pragma unroll 1
      for (int i = 0; i < (int)(c0 >= 0) + (int)node1; ++i)
        visit_node<true, ORDER>(a.nodes8c, i == 0 ? lower : c0, r, a.t_min,
                                t_max0, stack, sp);
    }
  }
  a.occ_out[ray] = occ ? 1 : 0;
  if (COUNT_STEPS) {
    a.node_out[ray] = (float)node_pops;
    a.leaf_out[ray] = (float)leaf_pops;
  }
}

template <bool ANY, int STACK, bool POP2, bool COUNT_STEPS, int ORDER>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = tile_blocks(a.n, a.tile_w);
  if constexpr (ANY)
    bvh8_any_variant_kernel<STACK, POP2, COUNT_STEPS, ORDER>
        <<<blocks, TILE_THREADS, 0, stream>>>(a);
  else
    bvh8_closest_variant_kernel<STACK, POP2, COUNT_STEPS, ORDER>
        <<<blocks, TILE_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// the instantiation for a stack size: 48 (one pop) or 64 (two pops)
// entries, or 192
template <bool ANY, bool POP2, bool COUNT_STEPS, int ORDER>
int launch_stack(const Args& a, int stack, cudaStream_t s) {
  constexpr int SMALL = POP2 ? 64 : 48;
  if (stack == SMALL) return launch<ANY, SMALL, POP2, COUNT_STEPS, ORDER>(a, s);
  if (stack == 192) return launch<ANY, 192, POP2, COUNT_STEPS, ORDER>(a, s);
  return (int)cudaErrorInvalidValue;
}

// one pop: every order, counted or not, except an uncounted trace at K1's
// order ("sort", closest hit) or K2's ("none", any hit): those are
// bvh8_closest.cu's and bvh8_any.cu's and are not instantiated here
template <bool ANY, bool COUNT_STEPS>
int launch_order(const Args& a, int order, int stack, cudaStream_t s) {
  if (order == ORDER_NEARLAST)
    return launch_stack<ANY, false, COUNT_STEPS, ORDER_NEARLAST>(a, stack, s);
  if constexpr (COUNT_STEPS || ANY)
    if (order == ORDER_SORT)
      return launch_stack<ANY, false, COUNT_STEPS, ORDER_SORT>(a, stack, s);
  if constexpr (COUNT_STEPS || !ANY)
    if (order == ORDER_NONE)
      return launch_stack<ANY, false, COUNT_STEPS, ORDER_NONE>(a, stack, s);
  return (int)cudaErrorInvalidValue;
}

// the traces this file takes: two pops uncounted at "sort"; one pop
// counted, or at another order than K1's / K2's
bool valid(int pop2, int count_steps, int order, bool any_hit) {
  if (order < ORDER_SORT || order > ORDER_NONE) return false;
  if (pop2) return !count_steps && order == ORDER_SORT;
  return count_steps || order != (any_hit ? ORDER_NONE : ORDER_SORT);
}

template <bool ANY>
int dispatch(const Args& a, int pop2, int count_steps, int order,
             int stack, cudaStream_t s) {
  if (!valid(pop2, count_steps, order, ANY) || a.tile_w < 0 ||
      (a.tile_w > 0 && a.n % a.tile_w != 0))
    return (int)cudaErrorInvalidValue;
  if (a.n <= 0) return (int)cudaGetLastError();
  if (pop2) return launch_stack<ANY, true, false, ORDER_SORT>(a, stack, s);
  return count_steps ? launch_order<ANY, true>(a, order, stack, s)
                     : launch_order<ANY, false>(a, order, stack, s);
}

}  // namespace

extern "C" {

// K7a / K7b closest hit of n rays over the compact node table (M, 56) f32
// (codes bit-cast). pop2: two pops per iteration (K7b; uncounted, order
// 0); count_steps: node and leaf pops in u_out / v_out (f32); order: 0
// sort, 1 nearlast, 2 none (an uncounted one-pop "sort" trace is K1's,
// bvh8_closest.cu, and is refused). stack_size: 48 or 192 entries with one
// pop, 64 or 192 with two (the wrapper picks it from the tree's depth);
// tile_w: 0 for consecutive rays, else the frame's width (n = tile_w * H).
int tpurt_bvh8_closest_variant(const float* nodes8c, const float* tris,
                               const float* origin, const float* direction,
                               float t_min, const float* t_max, int n,
                               int pop2, int count_steps, int order,
                               int stack_size, int tile_w, float* t_out,
                               int* tri_out, float* u_out, float* v_out,
                               cudaStream_t stream) {
  const Args a{nodes8c, tris,  origin, direction, t_min,   t_max,
               n,       tile_w, t_out, tri_out,   u_out,   v_out,
               nullptr, nullptr, nullptr};
  return dispatch<false>(a, pop2, count_steps, order, stack_size, stream);
}

// K7a / K7b any hit: occlusion in occ_out; with count_steps (one pop) the
// node and leaf pops in node_out / leaf_out (f32). An uncounted one-pop
// "none" trace is K2's (bvh8_any.cu) and is refused; arguments as above.
int tpurt_bvh8_any_variant(const float* nodes8c, const float* tris,
                           const float* origin, const float* direction,
                           float t_min, const float* t_max, int n, int pop2,
                           int count_steps, int order, int stack_size,
                           int tile_w, uint8_t* occ_out, float* node_out,
                           float* leaf_out, cudaStream_t stream) {
  const Args a{nodes8c, tris,    origin,  direction, t_min,
               t_max,   n,       tile_w,  nullptr,   nullptr,
               nullptr, nullptr, occ_out, node_out,  leaf_out};
  return dispatch<true>(a, pop2, count_steps, order, stack_size, stream);
}

}  // extern "C"
