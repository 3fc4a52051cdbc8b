// One entry of the fixed-assignment admit loop, shared by admit_scan and
// admit_scan_forests: the fit re-check of the head's (flavor-resource,
// amount) pairs, or the capacity reserve of a preempt head without
// candidates, then the charge up the CQ's ancestor chain.
// Replaces kueue_tpu/ops/cycle.py _entry_decision + _admit_step.
#pragma once

#include "quota.cuh"

// Per-cycle head planes: [C, F] CQ planes, [W] and [W, R] head planes.
struct KqCycle {
  const int* nominal_cq;
  const int* npb_cq;
  const int* wl_cq;
  const int* dec_fr;
  const int* dec_amt;
  int rd;
  const uint8_t* fit_mask;
  const int* res_fr;
  const int* res_amt;
  int rr;
  const uint8_t* res_mask;
  const uint8_t* res_borrows;
};

// True when every pair of row wi that names column f holds amt <= avail.
__device__ __forceinline__ bool kq_pairs_fit(const int* fr, const int* amt,
                                             int r_width, int wi, int f,
                                             int avail) {
  bool ok = true;
  for (int r = 0; r < r_width; ++r) {
    const size_t o = static_cast<size_t>(wi) * r_width + r;
    if (fr[o] == f && amt[o] > avail) ok = false;
  }
  return ok;
}

// Sum of the amounts of row wi's pairs that name column f.
__device__ __forceinline__ int kq_pairs_sum(const int* fr, const int* amt,
                                            int r_width, int wi, int f) {
  int s = 0;
  for (int r = 0; r < r_width; ++r) {
    const size_t o = static_cast<size_t>(wi) * r_width + r;
    if (fr[o] == f) s = kq_add(s, amt[o]);
  }
  return s;
}

// resourcesToReserve (scheduler.go:383-408) for column f of head wi whose
// CQ row of `usage` is cq.
__device__ __forceinline__ int kq_reserve_delta(const KqCycle& c,
                                                const int* usage, int F,
                                                int wi, int cq, int f) {
  const size_t co = static_cast<size_t>(cq) * F + f;
  const int cur = usage[co];
  const bool borrows = c.res_borrows[wi] != 0;
  int s = 0;
  for (int r = 0; r < c.rr; ++r) {
    const size_t o = static_cast<size_t>(wi) * c.rr + r;
    if (c.res_fr[o] != f) continue;
    const int ramt = c.res_amt[o];
    const int d = borrows
        ? min(ramt, kq_sub(c.npb_cq[co], cur))
        : max(0, min(ramt, kq_sub(c.nominal_cq[co], cur)));
    s = kq_add(s, d);
  }
  return s;
}

// Every thread of the block calls this with the same (wi, valid); each
// thread owns the columns f = tid, tid + blockDim.x, ... of `usage`.
// Returns the block-uniform admit decision.
__device__ __forceinline__ bool kq_admit_entry(const KqTree& t,
                                               const KqCycle& c, int* usage,
                                               int wi, bool valid) {
  const int cq = max(c.wl_cq[wi], 0);
  bool ok_f = true;
  for (int f = threadIdx.x; f < t.F; f += blockDim.x) {
    const int avail = kq_available_at(t, usage, cq, f);
    if (!kq_pairs_fit(c.dec_fr, c.dec_amt, c.rd, wi, f, avail)) ok_f = false;
  }
  const bool ok = __syncthreads_and(ok_f) != 0;
  const bool admit = c.fit_mask[wi] && valid && ok;
  const bool is_res = c.res_mask[wi] && valid;
  if (admit || is_res) {
    for (int f = threadIdx.x; f < t.F; f += blockDim.x) {
      int delta = 0;
      if (admit) delta = kq_pairs_sum(c.dec_fr, c.dec_amt, c.rd, wi, f);
      if (is_res) {
        delta = kq_add(delta, kq_reserve_delta(c, usage, t.F, wi, cq, f));
      }
      kq_add_usage_chain(t, usage, c.wl_cq[wi], delta, f);
    }
  }
  return admit;
}
