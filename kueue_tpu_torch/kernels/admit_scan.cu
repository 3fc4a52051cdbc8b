// admit_scan: the flat admit loop of one cycle, cohort forests in
// parallel.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan (a jitted lax.scan over the
// cycle order).  Quota never flows between cohort forests, so the flat
// order only matters within a forest: the heads are grouped by forest
// (stably, in cycle order, no cap: every head is decided) and each
// forest's heads are decided by one warp.
//
// Layout (flat_forest.cuh, shared with admit_scan_forests and
// admit_scan_preempt; the decide loop with admit_scan_forests): forests are
// dealt to blocks and warps; a block stages its nodes' rows (one usage
// plane) in shared memory or keeps them in a global carry, and lists its
// heads in cycle order as (head, node, warp | flags, the decision
// pairs).  Then each warp walks the list and decides its own entries:
// the head's pairs on the lanes, each lane's pair checked against
// available() walked up the chain (in shared memory on that route), a
// warp vote for the fit, the charge walked up the chain by the pairs'
// lanes (pairs on distinct columns, no reserve) or summed per column in
// the warp's column row and walked by the lanes that own the columns.
// No block barrier per entry.
//
// Bound: latency.  Each forest's entries are sequential, each a chain of
// depth dependent shared-memory reads plus the head's pair loads; the
// forests run in parallel on the warps and blocks, after a prologue of a
// few passes over the nodes and heads.
#include <cuda_runtime.h>

#include "flat_forest.cuh"

namespace {

__global__ void kq_admit_scan_kernel(kq_flat::Flat a, uint8_t* admitted,
                                     kq_flat::RankCap cap) {
  kq_flat::flat_scan(a, admitted, cap);
}

}  // namespace

// ptrs and dims: kq_flat::flat_launch's, without the cap's.
extern "C" int kq_admit_scan(void* const* ptrs, const int* dims,
                             cudaStream_t stream) {
  return kq_flat::flat_launch(kq_admit_scan_kernel, ptrs, dims, 9, stream);
}
