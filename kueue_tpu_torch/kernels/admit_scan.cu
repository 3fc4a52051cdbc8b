// admit_scan: the sequential admit loop of one cycle in one launch.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan (a jitted lax.scan over the
// cycle order).  One thread block; each thread owns the flavor-resource
// columns f = tid, tid + blockDim.x, ... of the [N, F] usage carry, which
// lives in shared memory when it fits and in global scratch otherwise.  Each entry costs one chain walk per
// column and one block reduction (__syncthreads_and) for the fit.
//
// Bound: latency, not bytes or operations.  The W entries are strictly
// sequential and each walks a depth-long dependent chain, so the floor is
// about W x depth dependent memory reads plus W block barriers; the
// kernel keeps the carry on chip to make each of those reads short.
#include <cuda_runtime.h>

#include "admit_entry.cuh"

__global__ void kq_admit_scan_kernel(KqTree t, KqCycle c, const int* usage0,
                                     int* scratch, int n_nodes,
                                     const int* order, int W,
                                     uint8_t* admitted, int use_smem) {
  extern __shared__ int smem[];
  int* usage = use_smem ? smem : scratch;
  const int nf = n_nodes * t.F;
  for (int i = threadIdx.x; i < nf; i += blockDim.x) usage[i] = usage0[i];
  __syncthreads();
  for (int i = 0; i < W; ++i) {
    const int wi = order[i];
    const bool admit = kq_admit_entry(t, c, usage, wi, c.wl_cq[wi] >= 0);
    if (threadIdx.x == 0) admitted[wi] = admit;
  }
}

extern "C" int kq_admit_scan(
    const int* usage0, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* nominal_cq, const int* npb_cq, const int* wl_cq,
    const int* dec_fr, const int* dec_amt, const uint8_t* fit_mask,
    const int* res_fr, const int* res_amt, const uint8_t* res_mask,
    const uint8_t* res_borrows, const int* order, int* scratch,
    uint8_t* admitted, int n_nodes, int F, int W, int rd, int rr, int depth,
    int threads, int smem_bytes, cudaStream_t stream) {
  KqTree t{subtree, guaranteed, borrow_cap, has_blim, parent, F, depth};
  KqCycle c{nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, rd, fit_mask,
            res_fr, res_amt, rr, res_mask, res_borrows};
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_kernel<<<1, threads, smem_bytes, stream>>>(
      t, c, usage0, scratch, n_nodes, order, W, admitted, smem_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}
