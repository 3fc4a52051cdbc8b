// Topology-aware scheduling: the device helpers of the three TAS kernels.
//
// Replaces the jitted programs of kueue_tpu/ops/tas_kernel.py
// (fill_counts :78, best_fit_descend :196, split_across_roots :219,
// with _best_at_level :104 and _allocate_level :138).  One query is one
// block of TAS_THREADS threads: the domain tree of an accelerator
// cluster is a few thousand domains, so the whole query (fill, pick,
// descent) fits one block and never crosses a block boundary.  The
// descent kernels keep the query's states, the inner levels' counts and
// each parent's child run in shared memory (global scratch only past the
// launcher's shared-memory budget).
//
// - fill: a thread per leaf takes the minimum over requested resources
//   of floor(free / per_pod) (I32_MAX for a resource not requested, 0 when
//   nothing is requested), then level by level bottom-up the children
//   are summed into their parents, one barrier per level: a warp holds
//   32 consecutive children, an inclusive segmented warp scan over the
//   runs of equal parent (wrapping unsigned adds: XLA's int32
//   scatter-add wraps, and modular addition is order-free, so the sums
//   are exact whatever the order) leaves each run's sum in its last
//   lane, which adds it into the parent.  One add per run and warp
//   instead of one contended atomic per child; parents in any order.
// - routes: a walked level d takes the warp route when parents[d - 1]
//   is nondecreasing, within the parent level, and no parent has more
//   than 32 children (pack_tas's trees: domains sorted by id tuple, so
//   each parent's children are one ascending run; tas-4k's runs hold 16
//   and 32).  One pass before the fill's first barrier checks every
//   level (a run longer than 32 shows as parents[k - 32] == parents[k]);
//   each warp ORs its violations into its own word, so no word needs
//   clearing first.  After the barrier, each run's first and last child
//   give the parent's [begin, end).
// - warp route (tas_warp_walk): a warp per parent's run.  Lane i holds
//   child b + i; its rank in the profile order (key -state with
//   ascending id, or state with descending id under LeastFree) counts
//   the run's (key, tie) words below its own, 16 broadcast reads of two
//   words from the warp's shared slot; a scatter through the same slot
//   puts the run in sorted order; an exclusive wrapping warp scan of
//   the states gives each child's remaining count and the greedy take
//   min(state, max(0, remaining)); under BestFit, j = the first lane
//   with state >= remaining > 0 (ballot), rem_j by shuffle, the last
//   lane from j on with state >= rem_j (ballot) gives the tight state,
//   and the first lane from j on with that state (ballot) takes rem_j,
//   the others from j on 0.  No block barrier inside the level.
// - sort route (kept for a level whose parents are not nondecreasing or
//   whose runs exceed 32, and for a root split of more than 32 roots):
//   the level is sorted block-wide by (parent, key, tie) with a bitonic
//   sort of a 64-bit key (parent in the high word, the profile's int32
//   key with its sign bit flipped in the low word) and the tie index (id
//   order, or reversed under LeastFree); every element's (key, tie) is
//   distinct, so the order is total and the sort stable by construction.
//   Then a thread per parent walks its run of sorted positions with the
//   same arithmetic (tas_walk_segment).  In shared memory when it fits,
//   else in global scratch.
// Both routes walk every parent, also one with count 0: with wrapped
// sums its remaining can be positive, as in the JAX formula; a child
// whose parent lies outside the level gets 0.
//
// Bound: latency.  A query moves ~N_leaf x (R + 3) int32 (80 KB for a
// 4,096-host cluster: ~2.5e-5 ms at 3.35 TB/s) and does a few operations
// per domain; what it waits on is the launch and its dependent steps:
// the route check's barrier and L - 1 fill barriers, 2 for the pick, and
// one per level on the warp route (7 for tas-4k's level-0 query, against
// 259 for the sort route everywhere); a sort-route level costs
// log2(P) (log2(P) + 1) / 2 + 3 barriers of P (padded) domains and its
// longest serial child walk.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "quota.cuh"

#define TAS_MAX_LEVELS 8
#define TAS_THREADS 1024
#define TAS_WARPS (TAS_THREADS / 32)
#define TAS_WARP_RUN 32
#define TAS_I32_MAX 2147483647
#define TAS_FULL 0xffffffffu

enum TasProfile { TAS_BESTFIT = 0, TAS_MOSTFREE = 1, TAS_LEASTFREE = 2 };
enum TasRoute { TAS_NOT_WALKED = 0, TAS_WARP = 1, TAS_SORT = 2 };

// One query: the tree's static planes, the query's inputs and the
// level sizes (top -> bottom); level l's domains sit at offset[l] in the
// flat per-level buffers.
struct TasTree {
  const int* leaf_free;                    // [N_leaf, R]
  const int* per_pod;                      // [R]
  const int* parents[TAS_MAX_LEVELS];      // l < L-1: [size[l+1]]
  int size[TAS_MAX_LEVELS];
  int offset[TAS_MAX_LEVELS];
  int L;
  int R;
};

// Builds the tree from the launchers' pointer and dimension arrays:
// ptrs = leaf_free, per_pod, parents[8];
// dims = L, R, size[8].
inline TasTree tas_tree(void* const* ptrs, const int* dims) {
  TasTree t;
  t.leaf_free = static_cast<const int*>(ptrs[0]);
  t.per_pod = static_cast<const int*>(ptrs[1]);
  t.L = dims[0];
  t.R = dims[1];
  int off = 0;
  for (int l = 0; l < TAS_MAX_LEVELS; ++l) {
    t.parents[l] = static_cast<const int*>(ptrs[2 + l]);
    t.size[l] = l < t.L ? dims[2 + l] : 0;
    t.offset[l] = off;
    off += t.size[l];
  }
  return t;
}

// Fill, part 1: the leaf states, and zero inner states.  No barrier.
static __device__ void tas_fill_leaves(const TasTree& t, int* states) {
  const int leaf = t.L - 1;
  const int NL = t.size[leaf];
  bool any = false;
  for (int r = 0; r < t.R; ++r) any |= t.per_pod[r] > 0;
  int* leaf_state = states + t.offset[leaf];
  for (int i = threadIdx.x; i < NL; i += blockDim.x) {
    int m = TAS_I32_MAX;
    for (int r = 0; r < t.R; ++r) {
      const int p = t.per_pod[r];
      if (p > 0) {
        m = min(m, kq_floordiv(t.leaf_free[static_cast<size_t>(i) * t.R + r],
                               p));
      }
    }
    leaf_state[i] = any ? m : 0;
  }
  for (int i = threadIdx.x; i < t.offset[leaf]; i += blockDim.x) {
    states[i] = 0;
  }
}

// Adds the n children's states into their parents (np of them): a warp
// holds 32 consecutive children and the last lane of each run of equal
// parent adds the run's wrapping sum.  Parents outside [0, np) take
// nothing.  No barrier.
static __device__ void tas_sum_runs(const int* par, const int* child, int n,
                                    unsigned* parent, int np) {
  const int lane = threadIdx.x & 31;
  for (int base = threadIdx.x & ~31; base < n; base += blockDim.x) {
    const int c = base + lane;
    const bool in = c < n;
    const int p = in ? par[c] : -1;
    unsigned v = in ? static_cast<unsigned>(child[c]) : 0u;
    const int prev = __shfl_up_sync(TAS_FULL, p, 1);
    const unsigned heads = __ballot_sync(TAS_FULL, lane == 0 || prev != p);
    // the run's first lane: the highest head at or below this lane
    const int start = 31 - __clz(heads & (TAS_FULL >> (31 - lane)));
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned u = __shfl_up_sync(TAS_FULL, v, off);
      if (lane - off >= start) v += u;
    }
    const int next = __shfl_down_sync(TAS_FULL, p, 1);
    if (in && (lane == 31 || next != p) && p >= 0 && p < np) {
      atomicAdd(parent + p, v);
    }
  }
}

// Fill, part 2: level by level bottom-up, one barrier each.  Call after
// tas_fill_leaves and a barrier.
static __device__ void tas_fill_levels(const TasTree& t, int* states) {
  for (int l = t.L - 2; l >= 0; --l) {
    tas_sum_runs(t.parents[l], states + t.offset[l + 1], t.size[l + 1],
                 reinterpret_cast<unsigned*>(states + t.offset[l]),
                 t.size[l]);
    __syncthreads();
  }
}

// The working set of a descent query: states [sum of sizes], the inner
// levels' counts and each inner domain's child run [begin, end) (each
// [offset[L-1]], indexed like states).
struct TasWork {
  int* states;
  int* counts;
  int* begin;
  int* end;
};

__device__ __forceinline__ TasWork tas_work(const TasTree& t, int* base) {
  const int total = t.offset[t.L - 1] + t.size[t.L - 1];
  const int inner = t.offset[t.L - 1];
  return TasWork{base, base + total, base + total + inner,
                 base + total + 2 * inner};
}

// Route check, before the fill's first barrier: bit d of the warp's word
// set when level d (from `first` on) cannot take the warp route.  Also
// clears the run bounds.  No barrier.
static __device__ void tas_check_routes(const TasTree& t, int first,
                                        const TasWork& w, int* viol) {
  for (int i = threadIdx.x; i < t.offset[t.L - 1]; i += blockDim.x) {
    w.begin[i] = 0;
    w.end[i] = 0;
  }
  unsigned bad = 0u;
  for (int d = max(first, 1); d < t.L; ++d) {
    const int* par = t.parents[d - 1];
    const int np = t.size[d - 1];
    for (int k = threadIdx.x; k < t.size[d]; k += blockDim.x) {
      const int p = par[k];
      const bool ok = p >= 0 && p < np && (k == 0 || par[k - 1] <= p) &&
                      (k < TAS_WARP_RUN || par[k - TAS_WARP_RUN] != p);
      if (!ok) bad |= 1u << d;
    }
  }
  bad = __reduce_or_sync(TAS_FULL, bad);
  if ((threadIdx.x & 31) == 0) viol[threadIdx.x >> 5] = static_cast<int>(bad);
}

// After the route check's barrier: the levels that cannot take the warp
// route (the same mask in every thread), and each run's bounds (levels
// on the warp route only; ready after the next barrier).
static __device__ unsigned tas_bad_levels(const int* viol) {
  const int lane = threadIdx.x & 31;
  return __reduce_or_sync(
      TAS_FULL, lane < static_cast<int>(blockDim.x >> 5)
                    ? static_cast<unsigned>(viol[lane]) : 0u);
}

static __device__ void tas_run_bounds(const TasTree& t, int first,
                                      unsigned bad, const TasWork& w) {
  for (int d = max(first, 1); d < t.L; ++d) {
    if (bad & (1u << d)) continue;
    const int* par = t.parents[d - 1];
    const int n = t.size[d];
    int* begin = w.begin + t.offset[d - 1];
    int* end = w.end + t.offset[d - 1];
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      const int p = par[k];
      if (k == 0 || par[k - 1] != p) begin[p] = k;
      if (k == n - 1 || par[k + 1] != p) end[p] = k + 1;
    }
  }
}

// _allocate_level for one run on one warp: children b .. b + m - 1
// (m <= 32) share a parent holding `cnt` pods; takes written to
// out[child].  slot: the warp's 32 shared 64-bit words (16-byte
// aligned).  Every lane calls it.
static __device__ void tas_warp_walk(const int* state, int b, int m, int cnt,
                                     int profile, unsigned long long* slot,
                                     int* out) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < m;
  const int c = b + lane;
  const int st = in ? state[c] : 0;
  const bool least = profile == TAS_LEASTFREE;
  const int key = least ? st : kq_sub(0, st);
  const int tie = least ? -c : c;
  // (key, tie) as one unsigned 64-bit word in signed order; the lanes
  // past the run hold the largest word, which ranks no child
  const unsigned long long mine =
      (static_cast<unsigned long long>(static_cast<unsigned>(key) ^
                                       0x80000000u) << 32) |
      (static_cast<unsigned>(tie) ^ 0x80000000u);
  slot[lane] = in ? mine : ~0ull;
  __syncwarp();
  int rank = 0;
  const ulonglong2* pairs = reinterpret_cast<const ulonglong2*>(slot);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const ulonglong2 v = pairs[j];     // one broadcast read of two words
    rank += (v.x < mine) + (v.y < mine);
  }
  __syncwarp();
  int* sorted = reinterpret_cast<int*>(slot);
  if (in) {
    sorted[rank] = st;
    sorted[32 + rank] = c;
  }
  __syncwarp();
  // lane r now holds sorted position r
  const int s = in ? sorted[lane] : 0;
  const int child = in ? sorted[32 + lane] : 0;
  __syncwarp();
  unsigned inc = static_cast<unsigned>(s);
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned u = __shfl_up_sync(TAS_FULL, inc, off);
    if (lane >= off) inc += u;
  }
  const int rem = kq_sub(cnt, static_cast<int>(inc - static_cast<unsigned>(s)));
  int take = min(s, max(0, rem));               // greedy: jnp.clip
  if (profile == TAS_BESTFIT) {
    const unsigned ab = __ballot_sync(TAS_FULL, in && rem > 0 && s >= rem);
    if (ab != 0u) {                             // uniform in the warp
      const int j = __ffs(ab) - 1;
      const int rem_j = __shfl_sync(TAS_FULL, rem, j);
      const bool cand = in && lane >= j && s >= rem_j;
      const int last = 31 - __clz(__ballot_sync(TAS_FULL, cand));
      const int tight = __shfl_sync(TAS_FULL, s, last);
      const int pick = __ffs(__ballot_sync(TAS_FULL, cand && s == tight)) - 1;
      if (lane >= j) take = lane == pick ? rem_j : 0;
    }
  }
  if (in) out[child] = take;
}

// Level d's counts on the warp route: a warp per parent's run.  Ends
// with a barrier.
static __device__ void tas_warp_level(const TasTree& t, int d,
                                      const TasWork& w,
                                      const int* parent_counts, int profile,
                                      unsigned long long* slot, int* out) {
  const int np = t.size[d - 1];
  const int* begin = w.begin + t.offset[d - 1];
  const int* end = w.end + t.offset[d - 1];
  const int* state = w.states + t.offset[d];
  const int warp = threadIdx.x >> 5;
  for (int p = warp; p < np; p += blockDim.x >> 5) {
    const int b = begin[p];
    tas_warp_walk(state, b, end[p] - b, parent_counts[p], profile, slot,
                  out);
  }
  __syncthreads();
}

// Sort scratch: P 64-bit keys, P tie indices, and the segment bounds
// (begins, then ends) of the parent level being walked.
struct TasSort {
  unsigned long long* key;
  int* tie;
  int* seg;
};

// The parent of the domain at sorted position k (pads: 0xffffffff).
__device__ __forceinline__ unsigned tas_parent(const TasSort& s, int k) {
  return static_cast<unsigned>(s.key[k] >> 32);
}

__device__ __forceinline__ bool tas_after(const TasSort& s, int a, int b) {
  return s.key[a] > s.key[b] || (s.key[a] == s.key[b] && s.tie[a] > s.tie[b]);
}

// Sorts the n domains of one level by (parent, profile key, tie) into
// positions [0, n) of `s`, padded to the next power of two (pads sort
// last).  `parent` null: every domain has parent 0 (the root split).
// The child at sorted position k is tas_child(s, k, n, profile).  Ends
// with a barrier.
static __device__ void tas_sort_level(const int* parent, const int* state,
                                      int n, int profile, TasSort s) {
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (i < n) {
      const int st = state[i];
      const int k = profile == TAS_LEASTFREE ? st : kq_sub(0, st);
      const unsigned p = parent != nullptr ? static_cast<unsigned>(parent[i])
                                           : 0u;
      s.key[i] = (static_cast<unsigned long long>(p) << 32) |
                 (static_cast<unsigned>(k) ^ 0x80000000u);
      s.tie[i] = profile == TAS_LEASTFREE ? n - 1 - i : i;
    } else {
      s.key[i] = ~0ull;
      s.tie[i] = i;
    }
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          if (tas_after(s, i, ixj) == up) {
            const unsigned long long tk = s.key[i];
            s.key[i] = s.key[ixj];
            s.key[ixj] = tk;
            const int tt = s.tie[i];
            s.tie[i] = s.tie[ixj];
            s.tie[ixj] = tt;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int tas_child(const TasSort& s, int k, int n,
                                         int profile) {
  return profile == TAS_LEASTFREE ? n - 1 - s.tie[k] : s.tie[k];
}

// _allocate_level for one parent on one thread: its children at sorted
// positions [b, e), `cnt` pods to place, takes written to out[child].
static __device__ void tas_walk_segment(const TasSort& s, const int* state,
                                        int n, int b, int e, int cnt,
                                        int profile, int* out) {
  unsigned exc = 0;
  int j = -1;
  int rem_j = 0;
  for (int k = b; k < e; ++k) {
    const int c = tas_child(s, k, n, profile);
    const int st = state[c];
    const int rem = kq_sub(cnt, static_cast<int>(exc));
    if (j < 0 && rem > 0 && st >= rem) {
      j = k;
      rem_j = rem;
    }
    out[c] = min(st, max(0, rem));             // greedy: jnp.clip
    exc += static_cast<unsigned>(st);
  }
  if (profile != TAS_BESTFIT || j < 0) return;
  // candidates: k >= j with state >= rem_j (j is one); the pick is the
  // first candidate whose state equals the last candidate's
  int last = j;
  for (int k = j + 1; k < e; ++k) {
    if (state[tas_child(s, k, n, profile)] >= rem_j) last = k;
  }
  const int tight = state[tas_child(s, last, n, profile)];
  bool picked = false;
  for (int k = j; k < e; ++k) {
    const int c = tas_child(s, k, n, profile);
    const int st = state[c];
    int take = 0;
    if (!picked && st >= rem_j && st == tight) {
      take = rem_j;
      picked = true;
    }
    out[c] = take;
  }
}

// Level d's counts from level d-1's (d >= 1) on the sort route.  Ends
// with a barrier.
static __device__ void tas_allocate_level(const TasTree& t, int d,
                                          const int* parent_counts,
                                          const int* state, int profile,
                                          TasSort s, int* out) {
  const int n = t.size[d];
  const int np = t.size[d - 1];
  int* begin = s.seg;
  int* end = s.seg + np;
  for (int p = threadIdx.x; p < np; p += blockDim.x) begin[p] = end[p] = 0;
  tas_sort_level(t.parents[d - 1], state, n, profile, s);
  // each parent's children: its run of sorted positions.  A child whose
  // parent lies outside the level (pack_tas's never do) gets 0.
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const unsigned p = tas_parent(s, k);
    if (p >= static_cast<unsigned>(np)) {
      out[tas_child(s, k, n, profile)] = 0;
      continue;
    }
    if (k == 0 || tas_parent(s, k - 1) != p) begin[p] = k;
    if (k == n - 1 || tas_parent(s, k + 1) != p) end[p] = k + 1;
  }
  __syncthreads();
  for (int p = threadIdx.x; p < np; p += blockDim.x) {
    tas_walk_segment(s, state, n, begin[p], end[p], parent_counts[p],
                     profile, out);
  }
  __syncthreads();
}

// The sort scratch at `base` (P keys, then P ints, then 2 Q ints; P a
// power of two at least as large as every level sorted, Q the largest
// parent level).
__device__ __forceinline__ TasSort tas_sort_at(void* base, int P) {
  unsigned long long* key = static_cast<unsigned long long*>(base);
  int* tie = reinterpret_cast<int*>(key + P);
  return TasSort{key, tie, tie + P};
}
