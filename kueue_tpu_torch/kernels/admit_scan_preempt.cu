// admit_scan_preempt: the admit loop with in-scan preemption.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan_preempt (+
// _preempt_entry_decision and _remove_usage_chain).  One thread block;
// each thread owns the columns f = tid, tid + blockDim.x, ... of three
// [N, F] planes: `usage` (the live
// snapshot: admits, reserves and preemptor charges, targets not removed),
// `check` (usage with every issued preemption's targets removed, what
// fits checks against) and `trial` (check with the current entry's
// targets removed).  An entry that preempts makes its trial plane the new
// check plane by swapping the two pointers.  `used` [T] marks targets
// already preempted this cycle; an entry whose targets overlap it is
// skipped.  The planes live in shared memory when they fit, else in
// global scratch.
//
// Bound: latency, as admit_scan, plus one N-row column copy and MT
// target chain walks per preempting entry.
#include <cuda_runtime.h>

#include "admit_entry.cuh"

__global__ void kq_admit_scan_preempt_kernel(
    KqTree t, KqCycle c, const uint8_t* preempt_mask, const int* pre_fr,
    const int* pre_amt, int rp, const int* tgt_mat, int mt,
    const int* tu_cq, const int* tu_delta, int n_targets, const int* usage0,
    int* scratch, uint8_t* used, int n_nodes, const int* order, int W,
    uint8_t* admitted, uint8_t* preempting_out, uint8_t* skip_out,
    int use_smem) {
  extern __shared__ int smem[];
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int F = t.F;
  const int nf = n_nodes * F;
  int* usage = use_smem ? smem : scratch;
  int* check = usage + nf;
  int* trial = usage + 2 * nf;
  for (int i = tid; i < nf; i += T) {
    usage[i] = usage0[i];
    check[i] = usage0[i];
  }
  for (int i = tid; i < n_targets; i += T) used[i] = 0;
  __syncthreads();

  for (int step = 0; step < W; ++step) {
    const int wi = order[step];
    const int wcq = c.wl_cq[wi];
    const bool valid = wcq >= 0;
    const int cq = max(wcq, 0);

    // fit entry: the fixed pairs against the check plane
    bool ok_f = true;
    for (int f = tid; f < F; f += T) {
      const int avail = kq_available_at(t, check, cq, f);
      if (!kq_pairs_fit(c.dec_fr, c.dec_amt, c.rd, wi, f, avail)) {
        ok_f = false;
      }
    }
    const bool fit_ok = __syncthreads_and(ok_f) != 0;
    const bool admit = c.fit_mask[wi] && valid && fit_ok;

    // preempt entry: overlap check, remove the targets, fit after removal
    const bool is_pre = preempt_mask[wi] && valid;
    const int* tg = tgt_mat + static_cast<size_t>(wi) * mt;
    bool overlap = false;
    if (is_pre) {
      for (int j = 0; j < mt; ++j) {
        if (tg[j] >= 0 && used[tg[j]]) overlap = true;
      }
    }
    const bool act_pre = is_pre && !overlap;
    bool preempting = false;
    if (act_pre) {
      bool pre_f = true;
      for (int f = tid; f < F; f += T) {
        for (int n = 0; n < n_nodes; ++n) trial[n * F + f] = check[n * F + f];
        for (int j = 0; j < mt; ++j) {
          const int tj = tg[j];
          if (tj < 0) continue;
          kq_remove_usage_chain(t, trial, tu_cq[tj],
                                tu_delta[static_cast<size_t>(tj) * F + f], f);
        }
        const int avail = kq_available_at(t, trial, cq, f);
        if (!kq_pairs_fit(pre_fr, pre_amt, rp, wi, f, avail)) pre_f = false;
      }
      preempting = __syncthreads_and(pre_f) != 0;
      if (preempting && tid == 0) {
        for (int j = 0; j < mt; ++j) {
          if (tg[j] >= 0) used[tg[j]] = 1;
        }
      }
    }

    const bool is_res = c.res_mask[wi] && valid;
    if (admit || preempting || is_res) {
      for (int f = tid; f < F; f += T) {
        int delta = 0;
        if (admit) delta = kq_pairs_sum(c.dec_fr, c.dec_amt, c.rd, wi, f);
        if (preempting) {
          delta = kq_add(delta, kq_pairs_sum(pre_fr, pre_amt, rp, wi, f));
        }
        if (is_res) {
          delta = kq_add(delta, kq_reserve_delta(c, usage, F, wi, cq, f));
        }
        kq_add_usage_chain(t, usage, wcq, delta, f);
        kq_add_usage_chain(t, preempting ? trial : check, wcq, delta, f);
      }
    }
    if (preempting) {
      int* tmp = check;
      check = trial;
      trial = tmp;
    }
    if (tid == 0) {
      admitted[wi] = admit;
      preempting_out[wi] = preempting;
      skip_out[wi] = is_pre && overlap;
    }
  }
}

extern "C" int kq_admit_scan_preempt(
    const int* usage0, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* nominal_cq, const int* npb_cq, const int* wl_cq,
    const int* dec_fr, const int* dec_amt, const uint8_t* fit_mask,
    const int* res_fr, const int* res_amt, const uint8_t* res_mask,
    const uint8_t* res_borrows, const uint8_t* preempt_mask,
    const int* pre_fr, const int* pre_amt, const int* tgt_mat,
    const int* tu_cq, const int* tu_delta, const int* order, int* scratch,
    uint8_t* used, uint8_t* admitted, uint8_t* preempting,
    uint8_t* overlap_skip, int n_nodes, int F, int W, int rd, int rr, int rp,
    int mt, int n_targets, int depth, int threads, int smem_bytes,
    cudaStream_t stream) {
  KqTree t{subtree, guaranteed, borrow_cap, has_blim, parent, F, depth};
  KqCycle c{nominal_cq, npb_cq, wl_cq, dec_fr, dec_amt, rd, fit_mask,
            res_fr, res_amt, rr, res_mask, res_borrows};
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_preempt_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_preempt_kernel<<<1, threads, smem_bytes, stream>>>(
      t, c, preempt_mask, pre_fr, pre_amt, rp, tgt_mat, mt, tu_cq, tu_delta,
      n_targets, usage0, scratch, used, n_nodes, order, W, admitted,
      preempting, overlap_skip, smem_bytes > 0);
  return static_cast<int>(cudaGetLastError());
}
