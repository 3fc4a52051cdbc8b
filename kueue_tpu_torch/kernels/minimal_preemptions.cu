// minimal_preemptions_batch: every preemption search of a cycle in one
// launch, one thread block per search.
//
// Replaces kueue_tpu/ops/preemption_kernel.py minimal_preemptions_batch
// (a vmap of two lax.scans; minimal_preemptions is the batch with S = 1).
// Block s copies its forest-local [NL, F] usage plane into shared memory
// (global scratch when the plane does not fit); each thread owns the
// columns f = tid, tid + blockDim.x, ...
// The forward loop removes candidates in order (with the dynamic
// borrowing skip and the borrowWithinCohort threshold flip) until the
// preemptor fits, and stops there; the reverse loop
// re-adds each removed candidate but the last and keeps it when the
// preemptor still fits, undoing the chain otherwise (the undo recomputes
// the overwritten cells, so no chain is kept and any depth works).  The fit and the
// borrowing tests are block reductions (__syncthreads_and / _or).
//
// Bound: latency per search (K sequential steps of depth-long chain
// walks); searches run in parallel across SMs.
#include <cuda_runtime.h>

#include "quota.cuh"

// workloadFits (preemption.go:552) at the preemptor's CQ for the request
// row wu [F]; every thread of the block calls it.
__device__ __forceinline__ bool kq_fits(const KqTree& t, const int* usage,
                                        int pcq, const int* wu,
                                        bool allow_b) {
  bool ok_f = true;
  bool borrow_f = false;
  for (int f = threadIdx.x; f < t.F; f += blockDim.x) {
    const int w = wu[f];
    if (w <= 0) continue;
    const size_t o = static_cast<size_t>(pcq) * t.F + f;
    if (!(w <= kq_available_at(t, usage, pcq, f))) ok_f = false;
    if (kq_add(usage[o], w) > t.subtree[o]) borrow_f = true;
  }
  const bool ok = __syncthreads_and(ok_f) != 0;
  const bool borrowing = __syncthreads_or(borrow_f) != 0;
  return ok && (allow_b || !borrowing);
}

__global__ void kq_minimal_preemptions_kernel(
    const int* usage0, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* pre_cq, const int* wl_usage, const uint8_t* frs_mask,
    const int* cand_cq, const int* cand_delta, const uint8_t* cand_other,
    const uint8_t* cand_above, const uint8_t* allow_borrowing0,
    const uint8_t* threshold_enabled, int NL, int F, int K, int depth,
    int* scratch, uint8_t* fitted_out, uint8_t* mask_out, int use_smem) {
  extern __shared__ int smem[];
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const size_t plane = static_cast<size_t>(s) * NL * F;
  int* usage = use_smem ? smem : scratch + plane;   // [NL, F]
  const KqTree t{subtree + plane, guaranteed + plane, borrow_cap + plane,
                 has_blim + plane, parent + static_cast<size_t>(s) * NL, F,
                 depth};
  uint8_t* mask = mask_out + static_cast<size_t>(s) * K;
  const int* ccq = cand_cq + static_cast<size_t>(s) * K;

  for (int k = tid; k < K; k += T) mask[k] = 0;
  const int pcq = pre_cq[s];
  if (pcq < 0) {
    if (tid == 0) fitted_out[s] = 0;
    return;
  }
  for (int i = tid; i < NL * F; i += T) usage[i] = usage0[plane + i];
  __syncthreads();

  const int* wu = wl_usage + static_cast<size_t>(s) * F;
  const uint8_t* need = frs_mask + static_cast<size_t>(s) * F;
  bool allow_b = allow_borrowing0[s] != 0;
  const bool thr = threshold_enabled[s] != 0;
  bool fitted = false;
  int last_removed = -1;

  for (int k = 0; k < K && !fitted; ++k) {
    const int cq = ccq[k];
    if (cq < 0) continue;
    const size_t ko = static_cast<size_t>(s) * K + k;
    const bool other = cand_other[ko] != 0;
    // dynamic skip: an other-CQ candidate counts only while its CQ is
    // borrowing in a resource needing preemption
    bool cb_f = false;
    for (int f = tid; f < F; f += T) {
      const size_t o = static_cast<size_t>(cq) * F + f;
      if (need[f] && usage[o] > t.subtree[o]) cb_f = true;
    }
    const bool cand_borrowing = __syncthreads_or(cb_f) != 0;
    if (other && !cand_borrowing) continue;
    if (other && thr && cand_above[ko]) allow_b = false;
    for (int f = tid; f < F; f += T) {
      kq_remove_usage_chain(t, usage, cq, cand_delta[ko * F + f], f);
    }
    if (tid == 0) mask[k] = 1;
    last_removed = k;
    fitted = kq_fits(t, usage, pcq, wu, allow_b);
  }

  if (!fitted) {
    for (int k = tid; k < K; k += T) mask[k] = 0;
    if (tid == 0) fitted_out[s] = 0;
    return;
  }
  for (int k = last_removed - 1; k >= 0; --k) {
    if (!mask[k]) continue;
    const int cq = ccq[k];
    const size_t ko = static_cast<size_t>(s) * K + k;
    for (int f = tid; f < F; f += T) {
      kq_add_usage_chain(t, usage, cq, cand_delta[ko * F + f], f);
    }
    const bool still = kq_fits(t, usage, pcq, wu, allow_b);
    if (still) {
      if (tid == 0) mask[k] = 0;   // filled back: not a target
    } else {
      for (int f = tid; f < F; f += T) {
        kq_undo_add_usage_chain(t, usage, cq, cand_delta[ko * F + f], f);
      }
    }
  }
  if (tid == 0) fitted_out[s] = 1;
}

extern "C" int kq_minimal_preemptions(
    const int* usage0, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* pre_cq, const int* wl_usage, const uint8_t* frs_mask,
    const int* cand_cq, const int* cand_delta, const uint8_t* cand_other,
    const uint8_t* cand_above, const uint8_t* allow_borrowing0,
    const uint8_t* threshold_enabled, int* scratch, uint8_t* fitted,
    uint8_t* mask, int S, int NL, int F, int K, int depth, int threads,
    int smem_bytes, cudaStream_t stream) {
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_minimal_preemptions_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_minimal_preemptions_kernel<<<S, threads, smem_bytes, stream>>>(
      usage0, subtree, guaranteed, borrow_cap, has_blim, parent, pre_cq,
      wl_usage, frs_mask, cand_cq, cand_delta, cand_other, cand_above,
      allow_borrowing0, threshold_enabled, NL, F, K, depth, scratch, fitted,
      mask, smem_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}
