// The per-cycle head planes of the admit scans (admit_scan,
// admit_scan_forests, admit_scan_preempt, whose entries replace
// kueue_tpu/ops/cycle.py _entry_decision + _admit_step).
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
