// fill_counts: how many pods of one shape fit in every topology domain.
//
// Replaces kueue_tpu/ops/tas_kernel.py fill_counts (:78): leaf fits =
// min over requested resources of floor(free / per_pod), then a segment
// sum up each level.  One block (tas.cuh tas_fill_leaves and
// tas_fill_levels): a thread per leaf, then per level a warp per 32
// consecutive children summing each run of equal parent (a segmented
// warp scan) into the parent, one barrier per level.
//
// Bound: latency.  The call reads N_leaf x R int32 and writes one int32
// per domain (~65 KB for a 4,096-host, 3-resource cluster: ~2e-5 ms at
// 3.35 TB/s); it waits on the launch and L - 1 dependent barriers.
#include <cuda_runtime.h>

#include "tas.cuh"

__global__ void __launch_bounds__(TAS_THREADS)
    kq_tas_fill_counts_kernel(TasTree t, int* states) {
  tas_fill_leaves(t, states);
  __syncthreads();
  tas_fill_levels(t, states);
}

// ptrs: the tree (tas_tree), then states [sum of sizes];
// dims: the tree's.
extern "C" int kq_tas_fill_counts(void** ptrs, const int* dims,
                                  cudaStream_t stream) {
  const TasTree t = tas_tree(ptrs, dims);
  int* states = static_cast<int*>(ptrs[2 + TAS_MAX_LEVELS]);
  kq_tas_fill_counts_kernel<<<1, TAS_THREADS, 0, stream>>>(t, states);
  return static_cast<int>(cudaGetLastError());
}
