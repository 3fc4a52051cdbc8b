// Topology-aware scheduling: the device helpers of the three TAS kernels.
//
// Replaces the jitted programs of kueue_tpu/ops/tas_kernel.py
// (fill_counts :78, best_fit_descend :196, split_across_roots :219,
// with _best_at_level :104 and _allocate_level :138).  One query is one
// block of TAS_THREADS threads: the domain tree of an accelerator
// cluster is a few thousand domains, so the whole query (fill, pick,
// descent) fits one block and never crosses a block boundary.
//
// - fill: a thread per leaf takes the minimum over requested resources
//   of floor(free / per_pod) (I32_MAX for a resource not requested, 0 when
//   nothing is requested), then level by level bottom-up each child adds
//   its state into its parent's with an unsigned atomicAdd (XLA's int32
//   scatter-add wraps; modular addition is order-free, so the sums are
//   exact whatever the order), one __syncthreads() per level.
// - sort: a level is sorted block-wide by (parent, key, tie) with a
//   bitonic sort of a 64-bit key (parent in the high word, the profile's
//   int32 key with its sign bit flipped in the low word) and the tie
//   index (id order, or reversed under LeastFree); every element's
//   (key, tie) is distinct, so the order is total and the sort stable by
//   construction.  In shared memory when it fits, else in global scratch.
// - walk: the sorted level's runs of one parent (the key's high word)
//   give each parent's children as a range of sorted positions, found in
//   one pass over the sorted keys; a thread per parent walks its range
//   and computes what _allocate_level computes: the greedy take
//   min(state, max(0, remaining)), and under BestFit, from the first
//   child j with state >= remaining > 0, the whole remainder given to the
//   first child at or after j whose state equals that of the last child
//   with state >= remaining (the tightest fit), zeros elsewhere.  Every
//   parent walks, also one with count 0: with wrapped sums its remaining
//   can be positive, as in the JAX formula.
//
// Bound: latency.  A query moves ~N_leaf x (R + 3) int32 (80 KB for a
// 4,096-host cluster: ~2.5e-5 ms at 3.35 TB/s) and does a few operations
// per domain; what it waits on is the launch and its dependent steps:
// L - 1 fill barriers, log2(P) (log2(P) + 1) / 2 + 3 barriers for each
// sorted level of P (padded) domains, and the longest child walk (a flat
// 4,096-root split walks 4,096 children in one thread).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "quota.cuh"

#define TAS_MAX_LEVELS 8
#define TAS_THREADS 1024
#define TAS_I32_MAX 2147483647

enum TasProfile { TAS_BESTFIT = 0, TAS_MOSTFREE = 1, TAS_LEASTFREE = 2 };

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

// Phase 1: states of every level into states[offset[l] ..].  Ends with a
// barrier.
static __device__ void tas_fill(const TasTree& t, int* states) {
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
  __syncthreads();
  for (int l = leaf - 1; l >= 0; --l) {
    const int* child = states + t.offset[l + 1];
    unsigned* parent = reinterpret_cast<unsigned*>(states + t.offset[l]);
    for (int c = threadIdx.x; c < t.size[l + 1]; c += blockDim.x) {
      const int p = t.parents[l][c];
      if (p >= 0 && p < t.size[l]) {   // pack_tas's always are
        atomicAdd(parent + p, static_cast<unsigned>(child[c]));
      }
    }
    __syncthreads();
  }
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

// _allocate_level for one parent: its children at sorted positions
// [b, e), `cnt` pods to place, takes written to out[child].
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

// Level d's counts from level d-1's (d >= 1).  Ends with a barrier.
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

// The sort scratch: `global` when given, else the block's dynamic
// shared memory (P keys, then P ints, then 2 Q ints; P a power of two at
// least as large as every level sorted, Q the largest parent level).
__device__ __forceinline__ TasSort tas_sort_scratch(void* global, int P) {
  extern __shared__ unsigned long long tas_smem[];
  unsigned long long* base =
      global != nullptr ? static_cast<unsigned long long*>(global) : tas_smem;
  int* tie = reinterpret_cast<int*>(base + P);
  return TasSort{base, tie, tie + P};
}
