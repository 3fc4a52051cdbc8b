// burst_cycles: K fused admission cycles in one launch, one thread block
// per cohort forest.
//
// Replaces kueue_tpu/ops/burst.py _burst_cycles (jitted as burst_cycles).
// Quota never crosses cohort forests, and the only cross-forest quantity
// is the per-cycle dirty flags, which no state transition reads; so each
// block runs all K cycles of its forest alone (heads, classify with the
// FlavorFungibility walk, the preemption searches, the in-forest order,
// the admit scan and the end-of-cycle transitions) and ORs its dirty
// flags into the [K, 4] output with atomics.  The block keeps its
// per-CQ facts, the rebuilt node usage and the scan planes in global
// scratch rows that only it touches, and the candidate sort in shared
// memory.
//
// Bound: latency.  Every cycle is a chain of dependent phases separated
// by block barriers (the admit scan is L sequential steps, each with a
// usage rebuild), and a search walks its candidates one at a time; the
// bytes and operations are orders of magnitude below the card's rates.
// Blocks run in parallel, one forest each.
//
// Arithmetic: XLA's int32 adds and subtracts wrap, so they go through
// unsigned (quota.cuh kq_add / kq_sub); shifts are done on unsigned.
#include <cuda_runtime.h>

#include <cstdint>

#include "quota.cuh"

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kBorrowBit = 1 << 30;

enum : int {
  KIND_NONE = 0, KIND_ADMIT = 1, KIND_SKIP = 2, KIND_PARK = 3,
  KIND_PREEMPT = 4, KIND_RESERVE = 5, KIND_OVERLAP_SKIP = 6,
  KIND_PRE_NOFIT = 7
};

// per-CQ flag bits (scratch cq_i[c][Q_FLAGS])
enum : int {
  F_HEAD = 1, F_FIT = 2, F_BORROWS = 4, F_PREEMPT = 8, F_PBORROWS = 16,
  F_PREMODEL = 32, F_DIRTY = 64, F_PREEMPTING0 = 128, F_RESERVE = 256,
  F_ADMITTED = 512, F_PREEMPTING = 1024, F_PRENOFIT = 2048,
  F_OVERLAP = 4096
};

// per-CQ int facts of the current cycle
enum : int { Q_ROW = 0, Q_FLAGS, Q_FIT_SLOT, Q_CHOSEN, Q_TRIED, Q_PRIO, Q_N };

struct BurstArgs {
  int C, M, R, N, F, S, L, KC, KCW, KCP, K, G, depth, n_levels, NN;
  int runtime, seq_base;
  // inputs
  const int* wl_req;          // [C, M, R]
  const int* wl_rank;         // [C, M]
  const int* wl_cycle_rank;   // [C, M]
  const int* wl_prio;         // [C, M]
  const int* wl_uidrank;      // [C, M]
  const uint8_t* vec_ok;      // [C, M]
  const int* potential0;      // [N, F]
  const int* subtree;         // [N, F]
  const int* guaranteed;      // [N, F]
  const int* borrow_cap;      // [N, F]
  const uint8_t* has_blim;    // [N, F]
  const int* parent;          // [N]
  const int* node_level;      // [N]
  const int* nominal_cq;      // [C, F]
  const int* npb_cq;          // [C, F]
  const int* slot_fr;         // [C, S, R]
  const uint8_t* slot_valid;  // [C, S]
  const uint8_t* cpb;         // [C]
  const uint8_t* wcb;         // [C]
  const uint8_t* wcp;         // [C]
  const uint8_t* strict_cq;   // [C]
  const uint8_t* wcq_lower;   // [C]
  const uint8_t* rwc_enabled;     // [C]
  const uint8_t* rwc_only_lower;  // [C]
  const uint8_t* preempt_ok;  // [C]
  const int* members;         // [G, L]
  const int* cand_rows;       // [G, KC]
  const int* cand_lmem;       // [G, KC]
  const int* self_lmem;       // [C]
  const int* ext_release;     // [K, C, F]
  const uint8_t* ext_unpark;  // [K, G]
  const int* fnodes;          // [G, NN] forest nodes, deepest level first
  const int* fcount;          // [G]
  // carry, updated in place
  uint8_t* elig;              // [C, M]
  uint8_t* parked;            // [C, M]
  int* resume;                // [C, M]
  uint8_t* adm;               // [C, M]
  int* adm_seq;               // [C, M]
  int* adm_usage;             // [C, M, F]
  uint8_t* adm_uses;          // [C, M, F]
  int* death;                 // [C, M]
  int* u_cq;                  // [C, F]
  // outputs
  int* head_row;              // [K, C]
  int* kind;                  // [K, C]
  int* slot;                  // [K, C]
  uint8_t* borrows;           // [K, C]
  unsigned* tgt_words;        // [K, C, KCW]
  int* dflags;                // [K, 4], zeroed by the caller
  // scratch
  int* node_u;                // [N, F] rebuilt node usage
  int* u_scan;                // [C, F]
  int* u_chk;                 // [C, F]
  int* u_tmp;                 // [C, F]
  int* wu;                    // [C, F] preempt-slot request per column
  int* frs_need;              // [C, F] columns needing preemption
  int* adm_delta;             // [C, F]
  int* release;               // [C, F]
  int* cq_i;                  // [C, Q_N]
  int* mat;                   // [G, L] in-forest cycle order
  int* mkey;                  // [G, L]
  unsigned* used;             // [G, KCW] committed target slots
  int* u_mem;                 // [G, 2, L, F] search member usage
};

// -- usage rebuild: CQ rows of `src` → every node of the forest --------
// usage[node] = Σ_children max(0, usage[child] - guaranteed[child]),
// summed deepest level first (burst.py rebuild_usage).
__device__ void rebuild(const BurstArgs& a, int g, const int* src) {
  const int* fn = a.fnodes + static_cast<size_t>(g) * a.NN;
  const int nn = a.fcount[g];
  const int F = a.F;
  for (int i = threadIdx.x; i < nn * F; i += blockDim.x) {
    const int n = fn[i / F];
    const int f = i % F;
    const size_t o = static_cast<size_t>(n) * F + f;
    a.node_u[o] = n < a.C ? src[o] : 0;
  }
  __syncthreads();
  for (int lvl = a.n_levels - 1; lvl >= 1; --lvl) {
    for (int i = threadIdx.x; i < nn * F; i += blockDim.x) {
      const int n = fn[i / F];
      const int f = i % F;
      const int p = a.parent[n];
      if (a.node_level[n] != lvl || p < 0) continue;
      const size_t o = static_cast<size_t>(n) * F + f;
      const int c = max(0, kq_sub(a.node_u[o], a.guaranteed[o]));
      atomicAdd(&a.node_u[static_cast<size_t>(p) * F + f], c);
    }
    __syncthreads();
  }
}

// -- heads: argmin of the heap rank over eligible rows, first index ----
__device__ void heads(const BurstArgs& a, const int* mem) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int l = warp; l < a.L; l += n_warps) {
    const int c = mem[l];
    if (c < 0) continue;
    int best = kInf;
    int bi = 0;
    for (int m = lane; m < a.M; m += 32) {
      const size_t r = static_cast<size_t>(c) * a.M + m;
      const int key = a.elig[r] ? a.wl_rank[r] : kInf;
      if (key < best) {
        best = key;
        bi = m;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const int ob = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      int* q = a.cq_i + static_cast<size_t>(c) * Q_N;
      q[Q_ROW] = bi;
      q[Q_FLAGS] = best < kInf ? F_HEAD : 0;
    }
  }
}

// -- classify one flavor slot (classify_np dense twin) ------------------
struct SlotEval {
  bool fit, preempt, borrows;
};

__device__ SlotEval eval_slot(const BurstArgs& a, const KqTree& t, int c,
                              int s, const int* req) {
  bool missing = false, all_fit = true, res_nofit = false, borrow = false;
  for (int r = 0; r < a.R; ++r) {
    const int f = a.slot_fr[(static_cast<size_t>(c) * a.S + s) * a.R + r];
    const int q = req[r];
    const bool needed = q > 0;
    if (needed && f < 0) missing = true;
    if (!needed || f < 0) continue;
    const size_t o = static_cast<size_t>(c) * a.F + f;
    const int av = kq_available_at(t, a.node_u, c, f);
    const bool fit_r = q <= av;
    const bool nofit_r = q > a.potential0[o];
    const bool capable = q <= a.nominal_cq[o] || a.cpb[c];
    if (nofit_r || (!fit_r && !capable)) res_nofit = true;
    if (!fit_r) all_fit = false;
    if (kq_add(a.node_u[o], q) > a.subtree[o]) borrow = true;
  }
  const bool valid = a.slot_valid[static_cast<size_t>(c) * a.S + s];
  SlotEval e;
  e.fit = all_fit && !missing && valid;
  const bool nofit = res_nofit || missing || !valid;
  e.preempt = !e.fit && !nofit;
  e.borrows = borrow && a.parent[c] >= 0;
  return e;
}

// -- classify + fungibility walk, one thread per member CQ -------------
__device__ void classify(const BurstArgs& a, const KqTree& t, const int* mem,
                         int* s_dflags) {
  const int F = a.F;
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    if (c < 0) continue;
    int* q = a.cq_i + static_cast<size_t>(c) * Q_N;
    const int row = q[Q_ROW];
    const bool has_head = q[Q_FLAGS] & F_HEAD;
    const size_t rr = static_cast<size_t>(c) * a.M + row;
    const int* req = a.wl_req + rr * a.R;
    const int start = a.resume[rr];
    int first_stop = -1, best_mode = -1, best_idx = 0, p_count = 0;
    for (int s = max(start, 0); s < a.S; ++s) {
      const SlotEval e = eval_slot(a, t, c, s, req);
      const int mode = e.fit ? 2 : (e.preempt ? 1 : 0);
      if (e.preempt) ++p_count;
      if (first_stop < 0 && (e.fit || (e.preempt && a.wcp[c])) &&
          (!e.borrows || a.wcb[c])) {
        first_stop = s;
      }
      if (mode > best_mode) {
        best_mode = mode;
        best_idx = s;
      }
    }
    const bool has_stop = first_stop >= 0;
    const int chosen = has_stop ? first_stop : best_idx;
    const SlotEval ce = eval_slot(a, t, c, chosen, req);
    // with no active slot the pick is slot 0 in mode 0
    const int mode = chosen < start ? 0 : (ce.fit ? 2 : (ce.preempt ? 1 : 0));
    int slot_cnt = 0;
    for (int s = 0; s < a.S; ++s) {
      slot_cnt += a.slot_valid[static_cast<size_t>(c) * a.S + s] ? 1 : 0;
    }
    const bool has_fit = mode == 2 && has_head;
    const bool has_preempt = mode == 1 && has_head;
    // frsNeedingPreemption and the request on the chosen slot
    int* wu = a.wu + static_cast<size_t>(c) * F;
    int* need = a.frs_need + static_cast<size_t>(c) * F;
    for (int f = 0; f < F; ++f) {
      wu[f] = 0;
      need[f] = 0;
    }
    for (int r = 0; r < a.R; ++r) {
      const int f =
          a.slot_fr[(static_cast<size_t>(c) * a.S + chosen) * a.R + r];
      if (f < 0 || req[r] <= 0) continue;
      wu[f] = kq_add(wu[f], req[r]);
      if (!(req[r] <= kq_available_at(t, a.node_u, c, f))) need[f] = 1;
    }
    const bool pre_model = has_preempt && a.preempt_ok[c] &&
                           (has_stop || p_count == 1);
    const bool vec = a.vec_ok[rr];
    const bool dirty = has_head && ((has_preempt && !pre_model) || !vec);
    if (dirty) atomicOr(&s_dflags[0], 1);
    if (has_preempt && !pre_model) atomicOr(&s_dflags[1], 1);
    if (has_head && !vec) atomicOr(&s_dflags[2], 1);
    q[Q_FLAGS] = (has_head ? F_HEAD : 0) | (has_fit ? F_FIT : 0) |
                 (ce.borrows && has_fit ? F_BORROWS : 0) |
                 (has_preempt ? F_PREEMPT : 0) |
                 (ce.borrows && has_preempt ? F_PBORROWS : 0) |
                 (pre_model ? F_PREMODEL : 0) | (dirty ? F_DIRTY : 0);
    q[Q_FIT_SLOT] = has_fit ? chosen : -1;
    q[Q_CHOSEN] = chosen;
    q[Q_TRIED] = (has_stop && chosen < slot_cnt - 1) ? chosen : -1;
    q[Q_PRIO] = a.wl_prio[rr];
  }
}

// -- preemption search ---------------------------------------------------

// candidate slot j of forest g for the preemptor CQ c:
// bit 0 valid, bit 1 same CQ, bit 2 eligible (e_base)
__device__ int cand_eval(const BurstArgs& a, int g, int c, int j,
                         int prio_head) {
  const int row = a.cand_rows[static_cast<size_t>(g) * a.KC + j];
  if (row < 0) return 0;
  const int ci = row / a.M;
  const bool same = ci == c;
  const int bits = 1 | (same ? 2 : 0);
  if (!a.adm[row]) return bits;
  const int F = a.F;
  bool uses_needed = false, b0 = false;
  for (int f = 0; f < F; ++f) {
    if (!a.frs_need[static_cast<size_t>(c) * F + f]) continue;
    if (a.adm_uses[static_cast<size_t>(row) * F + f]) uses_needed = true;
    const size_t o = static_cast<size_t>(ci) * F + f;
    if (a.u_cq[o] > a.subtree[o]) b0 = true;
  }
  b0 = b0 && a.parent[ci] >= 0;
  const bool lower = a.wl_prio[row] < prio_head;
  const bool e_same = same && a.wcq_lower[c] && lower;
  const bool e_cross = !same && a.rwc_enabled[c] && b0 &&
                       (!a.rwc_only_lower[c] || lower);
  return bits | ((uses_needed && (e_same || e_cross)) ? 4 : 0);
}

// candidatesOrdering's two int32 composite keys (burst.py :414-418),
// compared (hi, lo) as signed ints, as one unsigned 64-bit key
__device__ unsigned long long cand_key(bool elig_any, bool same, int prio,
                                       int seq, int uid) {
  const int inv_seq = kq_sub((1 << 20) - 1, seq);
  const unsigned hi = (static_cast<unsigned>(elig_any ? 0 : 1) << 30) |
                      (static_cast<unsigned>(same ? 1 : 0) << 29) |
                      (static_cast<unsigned>(kq_add(prio, 1 << 20)) << 8) |
                      static_cast<unsigned>(inv_seq >> 12);
  const unsigned lo = ((static_cast<unsigned>(inv_seq) & 0xFFFu) << 19) |
                      static_cast<unsigned>(uid);
  return (static_cast<unsigned long long>(hi ^ 0x80000000u) << 32) |
         (lo ^ 0x80000000u);
}

// ascending bitonic sort of P (a power of two) (key, slot) pairs; slots
// are distinct, so the order is total and equals a stable sort by key
__device__ void bitonic(unsigned long long* key, int* val, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int j = i ^ stride;
        if (j <= i) continue;
        const bool up = (i & size) == 0;
        const unsigned long long ki = key[i], kj = key[j];
        const int vi = val[i], vj = val[j];
        const bool gt = ki > kj || (ki == kj && vi > vj);
        if (gt == up) {
          key[i] = kj;
          key[j] = ki;
          val[i] = vj;
          val[j] = vi;
        }
      }
      __syncthreads();
    }
  }
}

// workloadFits for the preemptor CQ c on member usage um [L, F]: the
// depth <= 2 form of available_at (burst.py avail_from_members)
__device__ bool fits(const BurstArgs& a, int c, const int* mem,
                     const int* um, bool allow_b) {
  const int F = a.F;
  const int self = a.self_lmem[c];
  const int pc = a.parent[c];
  const int root = max(pc, 0);
  for (int f = 0; f < F; ++f) {
    const size_t oc = static_cast<size_t>(c) * F + f;
    const int w = a.wu[oc];
    if (w <= 0) continue;
    int root_use = 0;
    for (int l = 0; l < a.L; ++l) {
      const int m = mem[l];
      if (m < 0) continue;
      root_use = kq_add(root_use,
                        max(0, kq_sub(um[l * F + f],
                                      a.guaranteed[static_cast<size_t>(m) *
                                                   F + f])));
    }
    const int root_avail =
        kq_sub(a.subtree[static_cast<size_t>(root) * F + f], root_use);
    const int u_self = um[self * F + f];
    const int g_c = a.guaranteed[oc];
    const int local = max(0, kq_sub(g_c, u_self));
    const int blim_cap = kq_sub(a.borrow_cap[oc], max(0, kq_sub(u_self, g_c)));
    const int par = a.has_blim[oc] ? min(blim_cap, root_avail) : root_avail;
    const int avail =
        pc >= 0 ? kq_add(local, par) : kq_sub(a.subtree[oc], u_self);
    if (!(w <= avail)) return false;
    if (!allow_b && kq_add(u_self, w) > a.subtree[oc]) return false;
  }
  return true;
}

// greedy walk over the sorted eligible candidates, then fill-back
// (preemption.go:275-342), for one search spec; one thread.  Spec 0
// walks every eligible candidate, spec 1 (staged only) the same-CQ ones.
// `kp` gets the kept positions; returns whether the preemptor fitted.
__device__ bool walk(const BurstArgs& a, int g, int c, const int* mem,
                     const int* sval, int n, int spec, bool staged,
                     unsigned* kp) {
  const int F = a.F;
  int* um = a.u_mem + static_cast<size_t>(g * 2 + spec) * a.L * F;
  for (int l = 0; l < a.L; ++l) {
    const int m = mem[l];
    for (int f = 0; f < F; ++f) {
      um[l * F + f] = m >= 0 ? a.u_cq[static_cast<size_t>(m) * F + f] : 0;
    }
  }
  for (int w = 0; w < a.KCW; ++w) kp[w] = 0;
  const bool allow_b = spec == 1 || !staged;
  bool fitted = false;
  int lastpos = -1;
  for (int t = 0; t < n && !fitted; ++t) {
    const size_t gj = static_cast<size_t>(g) * a.KC + sval[t];
    const int row = a.cand_rows[gj];
    const int ci = row / a.M;
    const bool same = ci == c;
    if (spec == 1 && !same) continue;
    int* u = um + a.cand_lmem[gj] * F;
    if (!same) {
      // live borrowing re-check for cross-CQ candidates
      bool live_b = false;
      for (int f = 0; f < F; ++f) {
        if (a.frs_need[static_cast<size_t>(c) * F + f] &&
            u[f] > a.subtree[static_cast<size_t>(ci) * F + f]) {
          live_b = true;
        }
      }
      if (!live_b) continue;
    }
    const int* du = a.adm_usage + static_cast<size_t>(row) * F;
    for (int f = 0; f < F; ++f) u[f] = kq_sub(u[f], du[f]);
    kp[t >> 5] |= 1u << (t & 31);
    lastpos = t;
    fitted = fits(a, c, mem, um, allow_b);
  }
  if (!fitted) {
    for (int w = 0; w < a.KCW; ++w) kp[w] = 0;
    return false;
  }
  for (int t = lastpos - 1; t >= 0; --t) {
    if (!((kp[t >> 5] >> (t & 31)) & 1u)) continue;
    const size_t gj = static_cast<size_t>(g) * a.KC + sval[t];
    int* u = um + a.cand_lmem[gj] * F;
    const int* du = a.adm_usage + static_cast<size_t>(a.cand_rows[gj]) * F;
    for (int f = 0; f < F; ++f) u[f] = kq_add(u[f], du[f]);
    if (fits(a, c, mem, um, allow_b)) {
      kp[t >> 5] &= ~(1u << (t & 31));
    } else {
      for (int f = 0; f < F; ++f) u[f] = kq_sub(u[f], du[f]);
    }
  }
  return true;
}

// the nominate-time searches of one modeled preemptor CQ c; the whole
// block builds and sorts the candidate order, threads 0 and 32 walk
// spec 0 and spec 1, and the kept targets land in tgt_words[k][c]
__device__ void search_lane(const BurstArgs& a, int g, int c, int k,
                            const int* mem, unsigned long long* skey,
                            int* sval, unsigned* keep, int* s_int) {
  const int tid = threadIdx.x;
  int* q = a.cq_i + static_cast<size_t>(c) * Q_N;
  const int prio_head = q[Q_PRIO];
  if (tid == 0) {
    s_int[0] = 0;   // has_cross
    s_int[1] = 0;   // eligible count
    s_int[2] = 0;   // fitted, spec 0
    s_int[3] = 0;   // fitted, spec 1
  }
  __syncthreads();
  for (int j = tid; j < a.KC; j += blockDim.x) {
    const int b = cand_eval(a, g, c, j, prio_head);
    if ((b & 4) && !(b & 2)) s_int[0] = 1;
  }
  __syncthreads();
  const bool has_cross = s_int[0] != 0;
  bool under_nom = true;
  for (int f = 0; f < a.F; ++f) {
    const size_t o = static_cast<size_t>(c) * a.F + f;
    if (a.frs_need[o] && !(a.u_cq[o] < a.nominal_cq[o])) under_nom = false;
  }
  // plan_searches (preemption.go:144-191, bwc == Never)
  const bool staged = has_cross && under_nom;
  for (int j = tid; j < a.KC; j += blockDim.x) {
    const int b = cand_eval(a, g, c, j, prio_head);
    const bool elig_any = staged ? (b & 4) != 0 : (b & 6) == 6;
    if (!elig_any) continue;
    const int row = a.cand_rows[static_cast<size_t>(g) * a.KC + j];
    const int pos = atomicAdd(&s_int[1], 1);
    skey[pos] = cand_key(true, (b & 2) != 0, a.wl_prio[row], a.adm_seq[row],
                         a.wl_uidrank[row]);
    sval[pos] = j;
  }
  __syncthreads();
  const int n = s_int[1];
  int P = 1;
  while (P < n) P <<= 1;
  for (int i = n + tid; i < P; i += blockDim.x) {
    skey[i] = ~0ull;
    sval[i] = kInf;
  }
  __syncthreads();
  bitonic(skey, sval, P);
  if (tid == 0) {
    s_int[2] = walk(a, g, c, mem, sval, n, 0, staged, keep) ? 1 : 0;
  } else if (tid == 32 && staged) {
    s_int[3] = walk(a, g, c, mem, sval, n, 1, staged, keep + a.KCW) ? 1 : 0;
  }
  __syncthreads();
  const bool f0 = s_int[2] != 0, f1 = s_int[3] != 0;
  if (f0 || f1) {
    const unsigned* kp = keep + ((!f0 && f1) ? a.KCW : 0);
    unsigned* tw = a.tgt_words +
                   (static_cast<size_t>(k) * a.C + c) * a.KCW;
    for (int t = tid; t < n; t += blockDim.x) {
      if ((kp[t >> 5] >> (t & 31)) & 1u) {
        const int j = sval[t];
        atomicOr(&tw[j >> 5], 1u << (j & 31));
      }
    }
    if (tid == 0) q[Q_FLAGS] |= F_PREEMPTING0;
  }
  __syncthreads();
}

// -- in-forest cycle order (entryOrdering), one thread ------------------
__device__ void order(const BurstArgs& a, int g, const int* mem) {
  int* mat = a.mat + static_cast<size_t>(g) * a.L;
  int* key = a.mkey + static_cast<size_t>(g) * a.L;
  int cnt = 0;
  for (int l = 0; l < a.L; ++l) {
    const int c = mem[l];
    if (c < 0) continue;
    int* q = a.cq_i + static_cast<size_t>(c) * Q_N;
    int flags = q[Q_FLAGS];
    if ((flags & F_PREMODEL) && !(flags & F_PREEMPTING0)) {
      flags |= F_RESERVE;
      q[Q_FLAGS] = flags;
    }
    if (!(flags & (F_FIT | F_PREEMPTING0 | F_RESERVE))) continue;
    const bool eb = (flags & F_FIT) ? (flags & F_BORROWS) : (flags & F_PBORROWS);
    const int kv = kq_add(
        a.wl_cycle_rank[static_cast<size_t>(c) * a.M + q[Q_ROW]],
        eb ? kBorrowBit : 0);
    if (kv == kInf) continue;
    int i = cnt++;
    while (i > 0 && key[i - 1] > kv) {
      key[i] = key[i - 1];
      mat[i] = mat[i - 1];
      --i;
    }
    key[i] = kv;
    mat[i] = c;
  }
  for (int i = cnt; i < a.L; ++i) mat[i] = -1;
}

// dst[target CQ] -= target usage, for every slot set in words `tw`
__device__ void sub_targets(const BurstArgs& a, int g, const unsigned* tw,
                            int* dst) {
  for (int j = threadIdx.x; j < a.KC; j += blockDim.x) {
    if (!((tw[j >> 5] >> (j & 31)) & 1u)) continue;
    const int row = a.cand_rows[static_cast<size_t>(g) * a.KC + j];
    const int ci = row / a.M;
    for (int f = 0; f < a.F; ++f) {
      atomicSub(&dst[static_cast<size_t>(ci) * a.F + f],
                a.adm_usage[static_cast<size_t>(row) * a.F + f]);
    }
  }
}

// -- admit scan: the forest's entries in order --------------------------
__device__ void scan(const BurstArgs& a, const KqTree& t, int g, int k,
                     const int* mem, int* s_int) {
  const int F = a.F;
  const int tid = threadIdx.x;
  unsigned* used = a.used + static_cast<size_t>(g) * a.KCW;
  for (int i = tid; i < a.L * F; i += blockDim.x) {
    const int c = mem[i / F];
    if (c < 0) continue;
    const size_t o = static_cast<size_t>(c) * F + i % F;
    a.u_scan[o] = a.u_cq[o];
    a.u_chk[o] = a.u_cq[o];
  }
  for (int w = tid; w < a.KCW; w += blockDim.x) used[w] = 0;
  if (tid == 0) s_int[4] = 0;
  __syncthreads();
  const int* mat = a.mat + static_cast<size_t>(g) * a.L;
  for (int col = 0; col < a.L; ++col) {
    const int cq = mat[col];
    if (cq < 0) break;
    int* q = a.cq_i + static_cast<size_t>(cq) * Q_N;
    const int flags = q[Q_FLAGS];
    const bool lane_pre = flags & F_PREEMPTING0;
    const unsigned* tw =
        a.tgt_words + (static_cast<size_t>(k) * a.C + cq) * a.KCW;
    if (lane_pre) {
      for (int w = tid; w < a.KCW; w += blockDim.x) {
        if (used[w] & tw[w]) s_int[4] = 1;
      }
    }
    for (int i = tid; i < a.L * F; i += blockDim.x) {
      const int c = mem[i / F];
      if (c < 0) continue;
      const size_t o = static_cast<size_t>(c) * F + i % F;
      a.u_tmp[o] = a.u_chk[o];
    }
    __syncthreads();
    const bool overlap = lane_pre && s_int[4] != 0;
    const bool act = lane_pre && !overlap;
    // the check plane with this entry's targets removed
    if (act) sub_targets(a, g, tw, a.u_tmp);
    __syncthreads();
    rebuild(a, g, a.u_tmp);
    const size_t rr = static_cast<size_t>(cq) * a.M + q[Q_ROW];
    const int* req = a.wl_req + rr * a.R;
    const int* fr_fit = a.slot_fr +
        (static_cast<size_t>(cq) * a.S + max(q[Q_FIT_SLOT], 0)) * a.R;
    if (tid == 0) {
      bool admit = (flags & F_FIT) != 0;
      for (int r = 0; admit && r < a.R; ++r) {
        const int f = fr_fit[r];
        if (f >= 0 && req[r] > 0 &&
            !(req[r] <= kq_available_at(t, a.node_u, cq, f))) {
          admit = false;
        }
      }
      bool pre_ok = true;
      for (int f = 0; f < F; ++f) {
        const int w = a.wu[static_cast<size_t>(cq) * F + f];
        if (w > 0 && !(w <= kq_available_at(t, a.node_u, cq, f))) {
          pre_ok = false;
        }
      }
      s_int[5] = admit ? 1 : 0;
      s_int[6] = pre_ok ? 1 : 0;
      s_int[4] = 0;
    }
    __syncthreads();
    const bool admit = s_int[5] != 0;
    const bool pre_ok = s_int[6] != 0;
    const bool pre_now = act && pre_ok;
    const bool is_res = flags & F_RESERVE;
    if (admit || pre_now || is_res) {
      for (int f = tid; f < F; f += blockDim.x) {
        const size_t o = static_cast<size_t>(cq) * F + f;
        int d = 0;
        if (admit) {
          for (int r = 0; r < a.R; ++r) {
            if (fr_fit[r] == f && req[r] > 0) d = kq_add(d, req[r]);
          }
        }
        const int w = a.wu[o];
        if (pre_now) d = kq_add(d, w);
        if (is_res && w > 0) {
          // resourcesToReserve (scheduler.go:383)
          const int cur = a.u_scan[o];
          const int res_b = min(w, kq_sub(a.npb_cq[o], cur));
          const int res_n = max(0, min(w, kq_sub(a.nominal_cq[o], cur)));
          d = kq_add(d, (flags & F_PBORROWS) ? res_b : res_n);
        }
        a.u_scan[o] = kq_add(a.u_scan[o], d);
        atomicAdd(&a.u_chk[o], d);
      }
    }
    if (pre_now) {
      sub_targets(a, g, tw, a.u_chk);
      for (int w = tid; w < a.KCW; w += blockDim.x) used[w] |= tw[w];
    }
    if (tid == 0) {
      q[Q_FLAGS] = flags | (admit ? F_ADMITTED : 0) |
                   (pre_now ? F_PREEMPTING : 0) |
                   (act && !pre_ok ? F_PRENOFIT : 0) |
                   (overlap ? F_OVERLAP : 0);
    }
    __syncthreads();
  }
}

// -- end-of-cycle state transitions and the cycle's decision output ----
__device__ void transitions(const BurstArgs& a, int g, int k, const int* mem,
                            int* s_int) {
  const int F = a.F;
  const int tid = threadIdx.x;
  for (int l = tid; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    if (c < 0) continue;
    const int* q = a.cq_i + static_cast<size_t>(c) * Q_N;
    const int flags = q[Q_FLAGS];
    const int row = q[Q_ROW];
    const size_t rr = static_cast<size_t>(c) * a.M + row;
    const int* req = a.wl_req + rr * a.R;
    const bool has_head = flags & F_HEAD;
    const bool has_fit = flags & F_FIT;
    const bool admitted = flags & F_ADMITTED;
    const bool reserve = flags & F_RESERVE;
    const bool overlap = flags & F_OVERLAP;
    const bool pre_nofit = flags & F_PRENOFIT;
    const int tried = q[Q_TRIED];
    const bool pending = tried >= 0;
    int* ad = a.adm_delta + static_cast<size_t>(c) * F;
    int* rel = a.release + static_cast<size_t>(c) * F;
    for (int f = 0; f < F; ++f) {
      ad[f] = 0;
      rel[f] = a.ext_release[(static_cast<size_t>(k) * a.C + c) * F + f];
    }
    const int* fr_fit = a.slot_fr +
        (static_cast<size_t>(c) * a.S + max(q[Q_FIT_SLOT], 0)) * a.R;
    if (admitted) {
      for (int r = 0; r < a.R; ++r) {
        if (fr_fit[r] >= 0 && req[r] > 0) {
          ad[fr_fit[r]] = kq_add(ad[fr_fit[r]], req[r]);
        }
      }
    }
    const bool skipped = has_fit && !admitted;
    const bool park_new =
        ((has_head && !has_fit && !(flags & F_PREEMPT) &&
          !(flags & F_DIRTY)) ||
         (reserve && !pending)) &&
        !a.strict_cq[c];
    if (admitted || park_new) a.elig[rr] = 0;
    if (park_new) a.parked[rr] = 1;
    const bool keep_resume = skipped || (reserve && pending) || overlap ||
                             pre_nofit;
    if (has_head) a.resume[rr] = (keep_resume && pending) ? tried + 1 : 0;
    if (admitted) {
      a.adm[rr] = 1;
      a.adm_seq[rr] = kq_add(a.seq_base, k);
      for (int f = 0; f < F; ++f) {
        a.adm_usage[rr * F + f] = ad[f];
        a.adm_uses[rr * F + f] = 0;
      }
      for (int r = 0; r < a.R; ++r) {
        if (fr_fit[r] >= 0 && req[r] > 0) a.adm_uses[rr * F + fr_fit[r]] = 1;
      }
      a.death[rr] = a.runtime > 0 ? kq_add(k, a.runtime) : kInf;
    }
    int kd = KIND_NONE;
    if (park_new) kd = KIND_PARK;
    if (skipped) kd = KIND_SKIP;
    if (admitted) kd = KIND_ADMIT;
    if (reserve) kd = KIND_RESERVE;
    if (flags & F_PREEMPTING) kd = KIND_PREEMPT;
    if (overlap) kd = KIND_OVERLAP_SKIP;
    if (pre_nofit) kd = KIND_PRE_NOFIT;
    const size_t o = static_cast<size_t>(k) * a.C + c;
    a.head_row[o] = has_head ? row : -1;
    a.kind[o] = kd;
    a.slot[o] = has_fit ? q[Q_FIT_SLOT]
                        : ((flags & F_PREMODEL) ? q[Q_CHOSEN] : -1);
    a.borrows[o] = has_fit ? ((flags & F_BORROWS) ? 1 : 0)
                           : ((flags & F_PBORROWS) ? 1 : 0);
  }
  __syncthreads();
  // evictions: committed targets release their usage and requeue
  const unsigned* used = a.used + static_cast<size_t>(g) * a.KCW;
  for (int j = tid; j < a.KC; j += blockDim.x) {
    if (!((used[j >> 5] >> (j & 31)) & 1u)) continue;
    const int row = a.cand_rows[static_cast<size_t>(g) * a.KC + j];
    const int ci = row / a.M;
    for (int f = 0; f < F; ++f) {
      atomicAdd(&a.release[static_cast<size_t>(ci) * F + f],
                a.adm_usage[static_cast<size_t>(row) * F + f]);
    }
    a.adm[row] = 0;
    a.elig[row] = 1;
    a.death[row] = kInf;
  }
  __syncthreads();
  // modeled finishes of this cycle (an eviction above wins)
  const int rows = a.L * a.M;
  for (int i = tid; i < rows; i += blockDim.x) {
    const int c = mem[i / a.M];
    if (c < 0) continue;
    const size_t row = static_cast<size_t>(c) * a.M + i % a.M;
    if (a.adm[row] && a.death[row] == k) {
      for (int f = 0; f < F; ++f) {
        atomicAdd(&a.release[static_cast<size_t>(c) * F + f],
                  a.adm_usage[row * F + f]);
      }
      a.adm[row] = 0;
    }
  }
  if (tid == 0) s_int[7] = 0;
  __syncthreads();
  for (int i = tid; i < a.L * F; i += blockDim.x) {
    const int c = mem[i / F];
    if (c < 0) continue;
    const size_t o = static_cast<size_t>(c) * F + i % F;
    const int rel = a.release[o];
    a.u_cq[o] = kq_sub(kq_add(a.u_cq[o], a.adm_delta[o]), rel);
    if (rel > 0) s_int[7] = 1;
  }
  __syncthreads();
  // released quota (or an external event) unparks the whole forest
  if (a.ext_unpark[static_cast<size_t>(k) * a.G + g] || s_int[7] != 0) {
    for (int i = tid; i < rows; i += blockDim.x) {
      const int c = mem[i / a.M];
      if (c < 0) continue;
      const size_t row = static_cast<size_t>(c) * a.M + i % a.M;
      if (a.parked[row]) {
        a.parked[row] = 0;
        a.elig[row] = 1;
      }
    }
  }
  // only preempting heads keep their target words
  for (int i = tid; i < a.L * a.KCW; i += blockDim.x) {
    const int c = mem[i / a.KCW];
    if (c < 0) continue;
    if (!(a.cq_i[static_cast<size_t>(c) * Q_N + Q_FLAGS] & F_PREEMPTING)) {
      a.tgt_words[(static_cast<size_t>(k) * a.C + c) * a.KCW + i % a.KCW] = 0;
    }
  }
  __syncthreads();
}

__global__ void kq_burst_cycles_kernel(BurstArgs a) {
  extern __shared__ unsigned long long smem_u64[];
  unsigned long long* skey = smem_u64;                          // [KCP]
  int* sval = reinterpret_cast<int*>(skey + a.KCP);             // [KCP]
  unsigned* keep = reinterpret_cast<unsigned*>(sval + a.KCP);   // [2, KCW]
  __shared__ int s_int[8];
  __shared__ int s_dflags[3];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const int* mem = a.members + static_cast<size_t>(g) * a.L;
  const KqTree t{a.subtree, a.guaranteed, a.borrow_cap, a.has_blim, a.parent,
                 a.F, a.depth};
  for (int k = 0; k < a.K; ++k) {
    if (tid < 3) s_dflags[tid] = 0;
    for (int i = tid; i < a.L * a.KCW; i += blockDim.x) {
      const int c = mem[i / a.KCW];
      if (c >= 0) {
        a.tgt_words[(static_cast<size_t>(k) * a.C + c) * a.KCW +
                    i % a.KCW] = 0;
      }
    }
    rebuild(a, g, a.u_cq);
    heads(a, mem);
    __syncthreads();
    classify(a, t, mem, s_dflags);
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) {
        if (s_dflags[i]) atomicOr(&a.dflags[k * 4 + i], 1);
      }
    }
    for (int l = 0; l < a.L; ++l) {
      const int c = mem[l];
      if (c < 0) continue;
      if (!(a.cq_i[static_cast<size_t>(c) * Q_N + Q_FLAGS] & F_PREMODEL)) {
        continue;
      }
      search_lane(a, g, c, k, mem, skey, sval, keep, s_int);
    }
    if (tid == 0) order(a, g, mem);
    __syncthreads();
    scan(a, t, g, k, mem, s_int);
    transitions(a, g, k, mem, s_int);
  }
}

}  // namespace

// ptrs: the BurstArgs pointers in declaration order (inputs, carry,
// outputs, scratch); dims: C, M, R, N, F, S, L, KC, K, G, depth,
// n_levels, NN, runtime, seq_base, threads.
extern "C" int kq_burst_cycles(void* const* ptrs, const int* dims,
                               cudaStream_t stream) {
  BurstArgs a;
  a.C = dims[0];
  a.M = dims[1];
  a.R = dims[2];
  a.N = dims[3];
  a.F = dims[4];
  a.S = dims[5];
  a.L = dims[6];
  a.KC = dims[7];
  a.K = dims[8];
  a.G = dims[9];
  a.depth = dims[10];
  a.n_levels = dims[11];
  a.NN = dims[12];
  a.runtime = dims[13];
  a.seq_base = dims[14];
  const int threads = dims[15];
  a.KCW = a.KC / 32;
  a.KCP = 1;
  while (a.KCP < a.KC) a.KCP <<= 1;
  int i = 0;
#define KQ_IN(field, T) a.field = static_cast<T>(ptrs[i++])
  KQ_IN(wl_req, const int*);
  KQ_IN(wl_rank, const int*);
  KQ_IN(wl_cycle_rank, const int*);
  KQ_IN(wl_prio, const int*);
  KQ_IN(wl_uidrank, const int*);
  KQ_IN(vec_ok, const uint8_t*);
  KQ_IN(potential0, const int*);
  KQ_IN(subtree, const int*);
  KQ_IN(guaranteed, const int*);
  KQ_IN(borrow_cap, const int*);
  KQ_IN(has_blim, const uint8_t*);
  KQ_IN(parent, const int*);
  KQ_IN(node_level, const int*);
  KQ_IN(nominal_cq, const int*);
  KQ_IN(npb_cq, const int*);
  KQ_IN(slot_fr, const int*);
  KQ_IN(slot_valid, const uint8_t*);
  KQ_IN(cpb, const uint8_t*);
  KQ_IN(wcb, const uint8_t*);
  KQ_IN(wcp, const uint8_t*);
  KQ_IN(strict_cq, const uint8_t*);
  KQ_IN(wcq_lower, const uint8_t*);
  KQ_IN(rwc_enabled, const uint8_t*);
  KQ_IN(rwc_only_lower, const uint8_t*);
  KQ_IN(preempt_ok, const uint8_t*);
  KQ_IN(members, const int*);
  KQ_IN(cand_rows, const int*);
  KQ_IN(cand_lmem, const int*);
  KQ_IN(self_lmem, const int*);
  KQ_IN(ext_release, const int*);
  KQ_IN(ext_unpark, const uint8_t*);
  KQ_IN(fnodes, const int*);
  KQ_IN(fcount, const int*);
  KQ_IN(elig, uint8_t*);
  KQ_IN(parked, uint8_t*);
  KQ_IN(resume, int*);
  KQ_IN(adm, uint8_t*);
  KQ_IN(adm_seq, int*);
  KQ_IN(adm_usage, int*);
  KQ_IN(adm_uses, uint8_t*);
  KQ_IN(death, int*);
  KQ_IN(u_cq, int*);
  KQ_IN(head_row, int*);
  KQ_IN(kind, int*);
  KQ_IN(slot, int*);
  KQ_IN(borrows, uint8_t*);
  KQ_IN(tgt_words, unsigned*);
  KQ_IN(dflags, int*);
  KQ_IN(node_u, int*);
  KQ_IN(u_scan, int*);
  KQ_IN(u_chk, int*);
  KQ_IN(u_tmp, int*);
  KQ_IN(wu, int*);
  KQ_IN(frs_need, int*);
  KQ_IN(adm_delta, int*);
  KQ_IN(release, int*);
  KQ_IN(cq_i, int*);
  KQ_IN(mat, int*);
  KQ_IN(mkey, int*);
  KQ_IN(used, unsigned*);
  KQ_IN(u_mem, int*);
#undef KQ_IN
  if (a.G < 1 || a.K < 1) return 0;
  const int smem_bytes = static_cast<int>(
      a.KCP * (sizeof(unsigned long long) + sizeof(int)) +
      2 * a.KCW * sizeof(unsigned));
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_burst_cycles_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_burst_cycles_kernel<<<a.G, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
