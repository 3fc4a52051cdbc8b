// best_fit_descend and split_across_roots: a TAS query's placement.
//
// Replaces kueue_tpu/ops/tas_kernel.py best_fit_descend (:196: the one
// best domain at the requested level by _best_at_level :104, then
// _allocate_level :138 down to the leaves) and split_across_roots (:219:
// _allocate_level of the count over all roots, then down).  One block
// per query (tas.cuh): the fill with the route check, a block argmin
// over (key, index) packed into 64 bits with a shared-memory atomicMin
// (or the wrapping root total with an unsigned atomicAdd), then per
// level the warp route (a warp per parent's run of at most 32
// children: rank by packed-key reads, scan, ballots) or, for a level
// whose parents are not nondecreasing or whose runs are longer, the
// sort route kept from before (a block-wide bitonic sort of the level by
// (parent, key, tie) and a thread per parent walking its children).  The
// root split is one run: the warp route up to 32 roots, the sort route
// beyond (the flat topologies of thousands of roots).  The sort scratch
// and then the states, the inner levels' counts and the run bounds live
// in dynamic shared memory when the launcher finds that they fit; each
// in global scratch otherwise.  Thread 0 writes each
// level's route (TasRoute) into the launch's route bytes.
//
// Bound: latency.  A query moves ~80 KB at 4,096 hosts (~2.5e-5 ms at
// 3.35 TB/s); it waits on the launch and its dependent steps: the route
// check's barrier and the fill's L - 1, the pick's 2, and one per level
// on the warp route (tas-4k's level-0 query: 3 + 2 + 2 = 7, against
// 259 with the sort on every level); a sort-route level adds
// log2(P) (log2(P) + 1) / 2 + 3 barriers and its longest serial walk.
#include <cuda_runtime.h>

#include "tas.cuh"

// Level d's counts: the output at the leaves, else the working set.
__device__ __forceinline__ int* tas_level_counts(const TasTree& t,
                                                 const TasWork& w, int* out,
                                                 int d) {
  return d == t.L - 1 ? out : w.counts + t.offset[d];
}

// ptrs: the tree (tas_tree), then the working set's global scratch
// (null: shared memory), the sort's global scratch (null: shared
// memory), flags [1 + TAS_MAX_LEVELS] (ok, then each level's route),
// out [N_leaf]; dims: the tree's, then count, level, profile,
// descend_profile, P, sort_bytes (12 P + 8 Q, Q the largest parent
// level walked) and the dynamic shared memory bytes (the sort first
// when it is there, then the working set).
struct TasQuery {
  TasTree t;
  int* work_global;
  void* sort_global;
  uint8_t* flags;
  int* out;
  int count, level, profile, descend_profile, P, sort_bytes, smem;
};

struct TasShared {
  TasWork w;
  TasSort s;
};

// The query's working set and sort scratch: the dynamic shared memory
// holds the sort (when it is not global) and then the working set (when
// it is not global).
__device__ __forceinline__ TasShared tas_shared(const TasQuery& q) {
  extern __shared__ unsigned long long tas_smem[];
  char* dyn = reinterpret_cast<char*>(tas_smem);
  void* sort = q.sort_global;
  if (sort == nullptr) {
    sort = dyn;
    dyn += q.sort_bytes;
  }
  int* work = q.work_global != nullptr ? q.work_global
                                       : reinterpret_cast<int*>(dyn);
  return TasShared{tas_work(q.t, work), tas_sort_at(sort, q.P)};
}

// Fill and route check from level `first` on; returns the levels that
// cannot take the warp route.  Ends with a barrier.
static __device__ unsigned tas_prologue(const TasTree& t, int first,
                                        const TasWork& w, int* viol) {
  tas_fill_leaves(t, w.states);
  tas_check_routes(t, first, w, viol);
  __syncthreads();
  const unsigned bad = tas_bad_levels(viol);
  tas_run_bounds(t, first, bad, w);
  tas_fill_levels(t, w.states);
  return bad;
}

// Levels first .. L-1 of the descent, each on its route.
static __device__ void tas_descend(const TasQuery& q, const TasShared& sh,
                                   int first, unsigned bad, int profile,
                                   unsigned long long* slot) {
  const TasTree& t = q.t;
  for (int d = first; d < t.L; ++d) {
    const int* pc = tas_level_counts(t, sh.w, q.out, d - 1);
    int* c = tas_level_counts(t, sh.w, q.out, d);
    const bool warp = (bad & (1u << d)) == 0u;
    if (warp) {
      tas_warp_level(t, d, sh.w, pc, profile, slot, c);
    } else {
      tas_allocate_level(t, d, pc, sh.w.states + t.offset[d], profile,
                         sh.s, c);
    }
    if (threadIdx.x == 0) q.flags[1 + d] = warp ? TAS_WARP : TAS_SORT;
  }
}

__global__ void __launch_bounds__(TAS_THREADS)
    kq_tas_best_fit_descend_kernel(TasQuery q) {
  __shared__ unsigned long long best;
  __shared__ int viol[TAS_WARPS];
  __shared__ __align__(16) unsigned long long slots[TAS_WARPS][TAS_WARP_RUN];
  const TasTree& t = q.t;
  if (threadIdx.x == 0) best = ~0ull;
  if (threadIdx.x < TAS_MAX_LEVELS) q.flags[1 + threadIdx.x] = TAS_NOT_WALKED;
  const TasShared sh = tas_shared(q);
  const unsigned bad = tas_prologue(t, q.level + 1, sh.w, viol);
  // _best_at_level: argmin of (fits ? key : I32_MAX), ties to the lowest
  // index, with key = state (BestFit, LeastFree) or -state (MostFree)
  const int* st = sh.w.states + t.offset[q.level];
  unsigned long long mine = ~0ull;
  int fits = 0;
  for (int i = threadIdx.x; i < t.size[q.level]; i += blockDim.x) {
    const int s = st[i];
    const bool f = s >= q.count;
    fits |= f;
    const int key =
        f ? (q.profile == TAS_MOSTFREE ? kq_sub(0, s) : s) : TAS_I32_MAX;
    mine = min(mine, (static_cast<unsigned long long>(
                          static_cast<unsigned>(key) ^ 0x80000000u) << 32) |
                         static_cast<unsigned>(i));
  }
  atomicMin(&best, mine);
  const bool ok = __syncthreads_or(fits) != 0;
  const int b = static_cast<int>(best & 0xffffffffull);
  int* c = tas_level_counts(t, sh.w, q.out, q.level);
  for (int i = threadIdx.x; i < t.size[q.level]; i += blockDim.x) {
    c[i] = (ok && i == b) ? q.count : 0;
  }
  __syncthreads();
  tas_descend(q, sh, q.level + 1, bad, q.profile, slots[threadIdx.x >> 5]);
  if (threadIdx.x == 0) q.flags[0] = ok;
}

__global__ void __launch_bounds__(TAS_THREADS)
    kq_tas_split_across_roots_kernel(TasQuery q) {
  __shared__ unsigned total;
  __shared__ int viol[TAS_WARPS];
  __shared__ __align__(16) unsigned long long slots[TAS_WARPS][TAS_WARP_RUN];
  const TasTree& t = q.t;
  if (threadIdx.x == 0) total = 0u;
  if (threadIdx.x < TAS_MAX_LEVELS) q.flags[1 + threadIdx.x] = TAS_NOT_WALKED;
  const TasShared sh = tas_shared(q);
  const unsigned bad = tas_prologue(t, 1, sh.w, viol);
  // jnp.sum(root_state): the wrapping int32 total
  unsigned mine = 0u;
  for (int i = threadIdx.x; i < t.size[0]; i += blockDim.x) {
    mine += static_cast<unsigned>(sh.w.states[i]);
  }
  atomicAdd(&total, mine);
  __syncthreads();
  const bool ok = static_cast<int>(total) >= q.count;
  // the roots as one run whose parent holds `count`
  int* c = tas_level_counts(t, sh.w, q.out, 0);
  const int n0 = t.size[0];
  const bool warp = n0 <= TAS_WARP_RUN;
  if (warp) {
    if (threadIdx.x < 32) {
      tas_warp_walk(sh.w.states, 0, n0, q.count, q.profile, slots[0], c);
    }
  } else {
    tas_sort_level(nullptr, sh.w.states, n0, q.profile, sh.s);
    if (threadIdx.x == 0) {
      tas_walk_segment(sh.s, sh.w.states, n0, 0, n0, q.count, q.profile, c);
    }
  }
  __syncthreads();
  if (!ok) {      // uniform: every thread read the same total
    for (int i = threadIdx.x; i < n0; i += blockDim.x) c[i] = 0;
    __syncthreads();
  }
  if (threadIdx.x == 0) q.flags[1] = warp ? TAS_WARP : TAS_SORT;
  tas_descend(q, sh, 1, bad, q.descend_profile, slots[threadIdx.x >> 5]);
  if (threadIdx.x == 0) q.flags[0] = ok;
}

static TasQuery tas_query(void** ptrs, const int* dims) {
  const int k = 2 + TAS_MAX_LEVELS;
  const int m = k;
  return TasQuery{tas_tree(ptrs, dims),
                  static_cast<int*>(ptrs[k]),
                  ptrs[k + 1],
                  static_cast<uint8_t*>(ptrs[k + 2]),
                  static_cast<int*>(ptrs[k + 3]),
                  dims[m], dims[m + 1], dims[m + 2], dims[m + 3],
                  dims[m + 4], dims[m + 5], dims[m + 6]};
}

// Dynamic shared memory past the default 48 KB (with the kernel's own
// static words) needs the opt-in; asked for whenever there is any.
template <typename Kernel>
static int tas_launch(Kernel kernel, const TasQuery& q, cudaStream_t stream) {
  if (q.smem > 0) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, q.smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<1, TAS_THREADS, q.smem, stream>>>(q);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kq_tas_best_fit_descend(void** ptrs, const int* dims,
                                       cudaStream_t stream) {
  return tas_launch(kq_tas_best_fit_descend_kernel, tas_query(ptrs, dims),
                    stream);
}

extern "C" int kq_tas_split_across_roots(void** ptrs, const int* dims,
                                         cudaStream_t stream) {
  return tas_launch(kq_tas_split_across_roots_kernel, tas_query(ptrs, dims),
                    stream);
}
