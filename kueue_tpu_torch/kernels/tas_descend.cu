// best_fit_descend and split_across_roots: a TAS query's placement.
//
// Replaces kueue_tpu/ops/tas_kernel.py best_fit_descend (:196: the one
// best domain at the requested level by _best_at_level :104, then
// _allocate_level :138 down to the leaves) and split_across_roots (:219:
// _allocate_level of the count over all roots, then down).  One block
// per query (tas.cuh): the fill, a block argmin over (key, index) packed
// into 64 bits with a shared-memory atomicMin (or the wrapping root total
// with an unsigned atomicAdd), then per level a block-wide bitonic sort
// of the level by (parent, key, tie) and a thread per parent walking its
// children.  The states and the inner levels' counts stay in global
// scratch (L2-resident at these sizes); the sort runs in dynamic shared
// memory when the launcher finds that it fits, else in global scratch.
//
// Bound: latency.  A query moves ~80 KB at 4,096 hosts (~2.5e-5 ms at
// 3.35 TB/s); it waits on the launch and its dependent steps: the fill's
// L - 1 barriers, log2(P) (log2(P) + 1) / 2 + 3 barriers for each
// sorted level (padded to a power of two), and the longest child walk of
// each level.
#include <cuda_runtime.h>

#include "tas.cuh"

// Level d's counts: the output at the leaves, else the scratch.
__device__ __forceinline__ int* tas_level_counts(const TasTree& t,
                                                 int* counts, int* out,
                                                 int d) {
  return d == t.L - 1 ? out : counts + t.offset[d];
}

__global__ void __launch_bounds__(TAS_THREADS)
    kq_tas_best_fit_descend_kernel(TasTree t, int* states, int* counts,
                                   void* sort_global, uint8_t* ok_out,
                                   int* out, int count, int level,
                                   int profile, int P) {
  __shared__ unsigned long long best;
  if (threadIdx.x == 0) best = ~0ull;
  tas_fill(t, states);
  // _best_at_level: argmin of (fits ? key : I32_MAX), ties to the lowest
  // index, with key = state (BestFit, LeastFree) or -state (MostFree)
  const int* st = states + t.offset[level];
  unsigned long long mine = ~0ull;
  int fits = 0;
  for (int i = threadIdx.x; i < t.size[level]; i += blockDim.x) {
    const int s = st[i];
    const bool f = s >= count;
    fits |= f;
    const int key =
        f ? (profile == TAS_MOSTFREE ? kq_sub(0, s) : s) : TAS_I32_MAX;
    mine = min(mine, (static_cast<unsigned long long>(
                          static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
                         static_cast<unsigned>(i));
  }
  atomicMin(&best, mine);
  const bool ok = __syncthreads_or(fits) != 0;
  const int b = static_cast<int>(best & 0xffffffffull);
  int* c = tas_level_counts(t, counts, out, level);
  for (int i = threadIdx.x; i < t.size[level]; i += blockDim.x) {
    c[i] = (ok && i == b) ? count : 0;
  }
  __syncthreads();
  const TasSort s = tas_sort_scratch(sort_global, P);
  for (int d = level + 1; d < t.L; ++d) {
    tas_allocate_level(t, d, tas_level_counts(t, counts, out, d - 1),
                       states + t.offset[d], profile, s,
                       tas_level_counts(t, counts, out, d));
  }
  if (threadIdx.x == 0) ok_out[0] = ok;
}

__global__ void __launch_bounds__(TAS_THREADS)
    kq_tas_split_across_roots_kernel(TasTree t, int* states, int* counts,
                                     void* sort_global, uint8_t* ok_out,
                                     int* out, int count, int profile,
                                     int descend_profile, int P) {
  __shared__ unsigned total;
  if (threadIdx.x == 0) total = 0u;
  tas_fill(t, states);
  // jnp.sum(root_state): the wrapping int32 total
  unsigned mine = 0u;
  for (int i = threadIdx.x; i < t.size[0]; i += blockDim.x) {
    mine += static_cast<unsigned>(states[i]);
  }
  atomicAdd(&total, mine);
  __syncthreads();
  const bool ok = static_cast<int>(total) >= count;
  const TasSort s = tas_sort_scratch(sort_global, P);
  // the roots as one segment whose parent holds `count`
  int* c = tas_level_counts(t, counts, out, 0);
  tas_sort_level(nullptr, states, t.size[0], profile, s);
  if (threadIdx.x == 0) {
    tas_walk_segment(s, states, t.size[0], 0, t.size[0], count, profile, c);
  }
  __syncthreads();
  if (!ok) {      // uniform: every thread read the same total
    for (int i = threadIdx.x; i < t.size[0]; i += blockDim.x) c[i] = 0;
    __syncthreads();
  }
  for (int d = 1; d < t.L; ++d) {
    tas_allocate_level(t, d, tas_level_counts(t, counts, out, d - 1),
                       states + t.offset[d], descend_profile, s,
                       tas_level_counts(t, counts, out, d));
  }
  if (threadIdx.x == 0) ok_out[0] = ok;
}

// ptrs: the tree (tas_tree), then states [sum of sizes], counts [sum of
// sizes], the sort scratch (null: shared memory), ok [1], out [N_leaf];
// dims: the tree's, then count, level, profile, descend_profile, P and
// the dynamic shared memory bytes (P: the scratch's power of two; the
// scratch is 12 P + 8 Q bytes, Q the largest parent level walked).
struct TasQuery {
  TasTree t;
  int* states;
  int* counts;
  void* sort_global;
  uint8_t* ok;
  int* out;
  int count, level, profile, descend_profile, P, smem;
};

static TasQuery tas_query(void** ptrs, const int* dims) {
  const int k = 2 + TAS_MAX_LEVELS;
  const int m = k;
  return TasQuery{tas_tree(ptrs, dims),
                  static_cast<int*>(ptrs[k]),
                  static_cast<int*>(ptrs[k + 1]),
                  ptrs[k + 2],
                  static_cast<uint8_t*>(ptrs[k + 3]),
                  static_cast<int*>(ptrs[k + 4]),
                  dims[m], dims[m + 1], dims[m + 2], dims[m + 3],
                  dims[m + 4], dims[m + 5]};
}

// Dynamic shared memory past the default 48 KB (with the kernel's own
// static words) needs the opt-in; asked for whenever the sort is there.
template <typename Kernel>
static int tas_prepare(Kernel kernel, int smem) {
  if (smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

extern "C" int kq_tas_best_fit_descend(void** ptrs, const int* dims,
                                       cudaStream_t stream) {
  const TasQuery q = tas_query(ptrs, dims);
  const int e = tas_prepare(kq_tas_best_fit_descend_kernel, q.smem);
  if (e != 0) return e;
  kq_tas_best_fit_descend_kernel<<<1, TAS_THREADS, q.smem, stream>>>(
      q.t, q.states, q.counts, q.sort_global, q.ok, q.out, q.count, q.level,
      q.profile, q.P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kq_tas_split_across_roots(void** ptrs, const int* dims,
                                         cudaStream_t stream) {
  const TasQuery q = tas_query(ptrs, dims);
  const int e = tas_prepare(kq_tas_split_across_roots_kernel, q.smem);
  if (e != 0) return e;
  kq_tas_split_across_roots_kernel<<<1, TAS_THREADS, q.smem, stream>>>(
      q.t, q.states, q.counts, q.sort_global, q.ok, q.out, q.count,
      q.profile, q.descend_profile, q.P);
  return static_cast<int>(cudaGetLastError());
}
