// admit_scan_forests: the flat admit loop with the forest schedule's
// rank cap, cohort forests in parallel.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan_forests (+ _forest_schedule
// and add_usage_chain_batched).  The flat scan of admit_scan.cu on the
// same layout (flat_forest.cuh: forests by the caller's forest_of_node
// dealt to blocks and warps, rows staged per block or kept in a global
// carry, each forest's entries decided by one warp) with one rule more:
// _forest_schedule keeps at most max_forest_wl heads of a forest, the
// first in cycle order, so a head whose rank within its forest is
// max_forest_wl or more is not admitted and never charged.  Each warp
// counts its forests' heads as it decides them (flat_forest.cuh
// RankCap).  Heads with wl_cq < 0, or whose forest lies outside
// [0, n_forests), are not admitted.
//
// Bound: latency, as admit_scan.
#include <cuda_runtime.h>

#include "flat_forest.cuh"

namespace {

__global__ void kq_admit_scan_forests_kernel(kq_flat::Flat a,
                                             uint8_t* admitted,
                                             kq_flat::RankCap cap) {
  kq_flat::flat_scan(a, admitted, cap);
}

}  // namespace

// ptrs and dims: kq_flat::flat_launch's, with the cap's.
extern "C" int kq_admit_scan_forests(void* const* ptrs, const int* dims,
                                     cudaStream_t stream) {
  return kq_flat::flat_launch(kq_admit_scan_forests_kernel, ptrs, dims, 13,
                              stream);
}
