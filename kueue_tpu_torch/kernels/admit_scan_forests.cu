// admit_scan_forests: the admit loop with one thread block per cohort
// forest.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan_forests (+ _forest_schedule
// and add_usage_chain_batched).  Quota never crosses forests, so block b
// owns forest b's rows of the [N, F] usage carry (global scratch) and
// decides its entries alone.  It compacts its entries out of the cycle
// order with warp ballots, in order and up to max_forest_wl of them,
// into a list in shared memory (in a global [n_forests, max_forest_wl]
// scratch when the list would take more than the launcher's limit),
// which is _forest_schedule without a sort; entries past max_forest_wl
// are not admitted, as the JAX schedule drops them.  Heads with
// wl_cq < 0 belong to the padding bucket and are never admitted.
//
// Bound: latency.  Each block runs max_forest_wl sequential entries of
// depth-long dependent chain walks; blocks run in parallel, one per SM.
#include <cuda_runtime.h>

#include "admit_entry.cuh"

__global__ void kq_admit_scan_forests_kernel(
    KqTree t, KqCycle c, const int* usage0, int* usage, int n_nodes,
    const int* order, const int* forest_of_node, int W, int n_forests,
    int max_forest_wl, int* list_global, uint8_t* admitted) {
  extern __shared__ int smem[];
  const int b = blockIdx.x;
  // [max_forest_wl] head indices, then [blockDim / 32] warp counts
  int* list = list_global != nullptr
                  ? list_global + static_cast<size_t>(b) * max_forest_wl
                  : smem;
  int* warp_count = list_global != nullptr ? smem : smem + max_forest_wl;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;

  const int nf = n_nodes * t.F;
  for (int i = tid; i < nf; i += blockDim.x) {
    if (forest_of_node[i / t.F] == b) usage[i] = usage0[i];
  }

  int count = 0;
  for (int base = 0; base < W; base += blockDim.x) {
    const int i = base + tid;
    bool mine = false;
    int wi = -1;
    if (i < W) {
      wi = order[i];
      const int cq = c.wl_cq[wi];
      const int fo = cq >= 0 ? forest_of_node[cq] : n_forests;
      mine = fo == b;
      if (b == 0 && (fo < 0 || fo >= n_forests)) admitted[wi] = 0;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, mine);
    if (lane == 0) warp_count[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int total = 0;
    for (int w = 0; w < n_warps; ++w) {
      const int cnt = warp_count[w];
      if (w < warp) before += cnt;
      total += cnt;
    }
    if (mine) {
      const int pos = count + before + __popc(ballot & ((1u << lane) - 1u));
      if (pos < max_forest_wl) {
        list[pos] = wi;
      } else {
        admitted[wi] = 0;
      }
    }
    count += total;
    __syncthreads();
  }

  const int n = min(count, max_forest_wl);
  for (int j = 0; j < n; ++j) {
    const int wi = list[j];
    const bool admit = kq_admit_entry(t, c, usage, wi, true);
    if (tid == 0) admitted[wi] = admit;
  }
}

extern "C" int kq_admit_scan_forests(
    const int* usage0, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* nominal_cq, const int* npb_cq, const int* wl_cq,
    const int* dec_fr, const int* dec_amt, const uint8_t* fit_mask,
    const int* res_fr, const int* res_amt, const uint8_t* res_mask,
    const uint8_t* res_borrows, const int* order, const int* forest_of_node,
    int* scratch, int* list_global, uint8_t* admitted, int n_nodes, int F,
    int W, int rd, int rr, int depth, int n_forests, int max_forest_wl,
    int threads, cudaStream_t stream) {
  KqTree t{subtree, guaranteed, borrow_cap, has_blim, parent, F, depth};
  KqCycle c{nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, rd, fit_mask,
            res_fr, res_amt, rr, res_mask, res_borrows};
  const int list_ints = list_global != nullptr ? 0 : max_forest_wl;
  const int smem_bytes =
      static_cast<int>((list_ints + threads / 32) * sizeof(int));
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_forests_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_forests_kernel<<<n_forests, threads, smem_bytes, stream>>>(
      t, c, usage0, scratch, n_nodes, order, forest_of_node, W, n_forests,
      max_forest_wl, list_global, admitted);
  return static_cast<int>(cudaGetLastError());
}
