// burst_cycles: K fused admission cycles in one launch, one thread block
// per cohort forest.
//
// Replaces kueue_tpu/ops/burst.py _burst_cycles (jitted as burst_cycles).
// Quota never crosses cohort forests, and the only cross-forest quantity
// is the per-cycle dirty flags, which no state transition reads; so each
// block runs all K cycles of its forest alone (heads, classify with the
// FlavorFungibility walk, the preemption searches, the in-forest order,
// the admit scan and the end-of-cycle transitions) and ORs its dirty
// flags into the [K, 4] output with atomics.
//
// Where the state lives: the block's per-forest state is indexed by
// member position l (members[g][l]) and forest node position p
// (fnodes[g][p], deepest level first), not by global CQ or node index,
// and sits in dynamic shared memory after the candidate sort: node usage
// and the nodes' static quota rows, parents, levels and member of each
// node; per member the CQ usage carry, the scan's u_scan / u_chk / u_tmp,
// wu, frs_need, adm_delta, release, the per-cycle facts, the fit slot's
// pairs, the order and the search's member usage and candidate bits.  A
// forest whose state does not fit keeps it in a global [G, state] row
// instead (the same code on other pointers).
//
// The CQ rows the cycles only read (slot columns and validity,
// potential, nominal and borrowing-limit quota, the flags) and the
// member table are staged there once per launch.
//
// Per cycle: a full rebuild of the forest's node usage (one barrier per
// level); heads, classify, the searches and the transitions over the
// members; the order as a rank by comparisons (ties to the lower member
// position, as a stable sort); then the admit scan on warp 0 alone, no
// block barrier per entry: each entry refreshes only the u_tmp rows that
// can differ from u_chk (the last entries' CQ and targets, this entry's
// targets), updates only those rows' ancestors — each ancestor's usage
// moves by the change of its child's term, the plane being a wrapping
// int32 sum of terms, so it equals the full rebuild's bit for bit —,
// walks the fit of its R pairs and F preempt columns on the lanes with a
// vote, and charges its columns on the lanes.
//
// Bound: latency.  Every cycle is a chain of dependent phases separated
// by block barriers and the admit scan is L sequential steps; a search
// walks its candidates one at a time.  The bytes and operations are
// orders of magnitude below the card's rates.
//
// Arithmetic: XLA's int32 adds and subtracts wrap, so they go through
// unsigned (quota.cuh kq_add / kq_sub); shifts are done on unsigned.
#include <cuda_runtime.h>

#include <cstdint>

#include "quota.cuh"

namespace {

constexpr int kInf = 0x7fffffff;
constexpr int kBorrowBit = 1 << 30;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRows = 8;   // rows a thread loads together in a pass

enum : int {
  KIND_NONE = 0, KIND_ADMIT = 1, KIND_SKIP = 2, KIND_PARK = 3,
  KIND_PREEMPT = 4, KIND_RESERVE = 5, KIND_OVERLAP_SKIP = 6,
  KIND_PRE_NOFIT = 7
};

// per-member flag bits (cq_i[l][Q_FLAGS])
enum : int {
  F_HEAD = 1, F_FIT = 2, F_BORROWS = 4, F_PREEMPT = 8, F_PBORROWS = 16,
  F_PREMODEL = 32, F_DIRTY = 64, F_PREEMPTING0 = 128, F_RESERVE = 256,
  F_ADMITTED = 512, F_PREEMPTING = 1024, F_PRENOFIT = 2048,
  F_OVERLAP = 4096
};

// per-member bits of the static CQ flags (cflag[l])
enum : int {
  CF_CPB = 1, CF_WCB = 2, CF_WCP = 4, CF_STRICT = 8, CF_PREEMPT_OK = 16,
  CF_HAS_PARENT = 32, CF_WCQ_LOWER = 64, CF_RWC = 128,
  CF_RWC_ONLY_LOWER = 256
};

// per-member int facts of the current cycle
enum : int { Q_ROW = 0, Q_FLAGS, Q_FIT_SLOT, Q_CHOSEN, Q_TRIED, Q_PRIO, Q_N };

struct BurstArgs {
  int C, M, R, N, F, S, L, KC, KCW, KCP, K, G, depth, n_levels, NN;
  int runtime, seq_base, state_ints;
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
  int* gmap;                  // [N] node → its forest position
  int* gstate;                // [G, state_ints] or null: the global route
};

// The block's forest state (shared memory, or its global row).
struct State {
  // by node position p < NN
  int* nu;          // [NN, F] node usage
  int* nst;         // [NN, F] subtree
  int* ng;          // [NN, F] guaranteed
  int* nbc;         // [NN, F] borrow cap
  int* npar;        // [NN] parent position, -1 at a root
  int* nlev;        // [NN] level, -1 past the forest
  int* nmem;        // [NN] member position of a CQ node, else -1
  uint8_t* nbl;     // [NN, F] has borrow limit
  // by member position l < L
  int* memb;        // [L] the member's CQ, or -1 (members[g])
  int* npos;        // [L] node position of the member's CQ, or -1
  int* mat;         // [L] in-forest cycle order (member positions)
  int* mkey;        // [L] order keys
  int* tmark;       // [L] u_tmp rows that may differ from u_chk
  int* cflag;       // [L] CF_* bits of the CQ
  int* cq_i;        // [L, Q_N]
  int* cslot;       // [L, S, R] slot_fr of the CQ
  int* cval;        // [L, S] slot_valid of the CQ
  int* cpot;        // [L, F] potential0 at the CQ
  int* cnom;        // [L, F] nominal quota of the CQ
  int* cnpb;        // [L, F] nominal plus borrowing limit
  int* ucq;         // [L, F] the CQ usage carry
  int* u_scan;      // [L, F]
  int* u_chk;       // [L, F]
  int* u_tmp;       // [L, F]
  int* u_prev;      // [L, F] a changed u_tmp row's value before the entry
  int* wu;          // [L, F] preempt-slot request per column
  int* need;        // [L, F] columns needing preemption
  int* adm_delta;   // [L, F]
  int* release;     // [L, F]
  int* u_mem;       // [2, L, F] search member usage
  int* fitf;        // [L, R] the fit slot's columns (-1: no pair)
  int* fita;        // [L, R] and amounts
  unsigned* used;   // [KCW] committed target slots
  uint8_t* cbits;   // [KC] a search's candidate bits (cand_eval)
  KqTree tp;        // the quota planes by node position
};

__host__ __device__ inline int state_ints(int NN, int L, int F, int S,
                                          int R, int KCW) {
  return 4 * NN * F + 3 * NN + 6 * L + L * Q_N + 14 * L * F + 2 * L * R +
         L * S * R + L * S + KCW + 8 * KCW + (NN * F + 3) / 4;
}

__device__ State carve(const BurstArgs& a, int* base) {
  const int NN = a.NN, L = a.L, F = a.F;
  State s;
  int* p = base;
  auto take = [&](int n) {
    int* q = p;
    p += n;
    return q;
  };
  s.nu = take(NN * F);
  s.nst = take(NN * F);
  s.ng = take(NN * F);
  s.nbc = take(NN * F);
  s.npar = take(NN);
  s.nlev = take(NN);
  s.nmem = take(NN);
  s.memb = take(L);
  s.npos = take(L);
  s.mat = take(L);
  s.mkey = take(L);
  s.tmark = take(L);
  s.cflag = take(L);
  s.cq_i = take(L * Q_N);
  s.cslot = take(L * a.S * a.R);
  s.cval = take(L * a.S);
  s.cpot = take(L * F);
  s.cnom = take(L * F);
  s.cnpb = take(L * F);
  s.ucq = take(L * F);
  s.u_scan = take(L * F);
  s.u_chk = take(L * F);
  s.u_tmp = take(L * F);
  s.u_prev = take(L * F);
  s.wu = take(L * F);
  s.need = take(L * F);
  s.adm_delta = take(L * F);
  s.release = take(L * F);
  s.u_mem = take(2 * L * F);
  s.fitf = take(L * a.R);
  s.fita = take(L * a.R);
  s.used = reinterpret_cast<unsigned*>(take(a.KCW));
  s.cbits = reinterpret_cast<uint8_t*>(take(8 * a.KCW));
  s.nbl = reinterpret_cast<uint8_t*>(p);
  s.tp = KqTree{s.nst, s.ng, s.nbc, s.nbl, s.npar, F, a.depth};
  return s;
}

// -- the forest's tables, static CQ rows and carry, once per launch ------
__device__ void stage(const BurstArgs& a, const State& s, int g) {
  const int* mem = a.members + static_cast<size_t>(g) * a.L;
  const int* fn = a.fnodes + static_cast<size_t>(g) * a.NN;
  const int nn = a.fcount[g];
  const int F = a.F;
  for (int p = threadIdx.x; p < nn; p += blockDim.x) a.gmap[fn[p]] = p;
  __syncthreads();
  for (int p = threadIdx.x; p < a.NN; p += blockDim.x) {
    const int n = p < nn ? fn[p] : -1;
    const int up = n >= 0 ? a.parent[n] : -1;
    s.npar[p] = up >= 0 ? a.gmap[up] : -1;
    s.nlev[p] = n >= 0 ? a.node_level[n] : -1;
    s.nmem[p] = (n >= 0 && n < a.C) ? a.self_lmem[n] : -1;
  }
  for (int i = threadIdx.x; i < nn * F; i += blockDim.x) {
    const size_t o = static_cast<size_t>(fn[i / F]) * F + i % F;
    s.nst[i] = a.subtree[o];
    s.ng[i] = a.guaranteed[o];
    s.nbc[i] = a.borrow_cap[o];
    s.nbl[i] = a.has_blim[o];
  }
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    s.memb[l] = c;
    s.npos[l] = c >= 0 ? a.gmap[c] : -1;
    s.tmark[l] = 0;
    s.cflag[l] = c < 0 ? 0
        : (a.cpb[c] ? CF_CPB : 0) | (a.wcb[c] ? CF_WCB : 0) |
          (a.wcp[c] ? CF_WCP : 0) | (a.strict_cq[c] ? CF_STRICT : 0) |
          (a.preempt_ok[c] ? CF_PREEMPT_OK : 0) |
          (a.parent[c] >= 0 ? CF_HAS_PARENT : 0) |
          (a.wcq_lower[c] ? CF_WCQ_LOWER : 0) |
          (a.rwc_enabled[c] ? CF_RWC : 0) |
          (a.rwc_only_lower[c] ? CF_RWC_ONLY_LOWER : 0);
  }
  for (int i = threadIdx.x; i < a.L * F; i += blockDim.x) {
    const int c = mem[i / F];
    const size_t o = static_cast<size_t>(max(c, 0)) * F + i % F;
    s.ucq[i] = c >= 0 ? a.u_cq[o] : 0;
    s.cpot[i] = c >= 0 ? a.potential0[o] : 0;
    s.cnom[i] = c >= 0 ? a.nominal_cq[o] : 0;
    s.cnpb[i] = c >= 0 ? a.npb_cq[o] : 0;
  }
  for (int i = threadIdx.x; i < a.L * a.S * a.R; i += blockDim.x) {
    const int c = mem[i / (a.S * a.R)];
    s.cslot[i] = c >= 0
        ? a.slot_fr[static_cast<size_t>(c) * a.S * a.R + i % (a.S * a.R)]
        : -1;
  }
  for (int i = threadIdx.x; i < a.L * a.S; i += blockDim.x) {
    const int c = mem[i / a.S];
    s.cval[i] = c >= 0 ? a.slot_valid[static_cast<size_t>(c) * a.S +
                                      i % a.S] : 0;
  }
  __syncthreads();
}

// -- usage rebuild: member rows → every node of the forest ---------------
// usage[node] = rows[member] (CQs) + Σ_children max(0, usage[child] -
// guaranteed[child]), summed deepest level first (burst.py
// rebuild_usage), by the whole block.
__device__ void rebuild(const BurstArgs& a, const State& s, int g,
                        const int* rows) {
  const int nn = a.fcount[g];
  const int F = a.F;
  for (int i = threadIdx.x; i < nn * F; i += blockDim.x) {
    const int m = s.nmem[i / F];
    s.nu[i] = m >= 0 ? rows[m * F + i % F] : 0;
  }
  __syncthreads();
  for (int lvl = a.n_levels - 1; lvl >= 1; --lvl) {
    for (int i = threadIdx.x; i < nn * F; i += blockDim.x) {
      const int p = i / F;
      const int up = s.npar[p];
      if (s.nlev[p] != lvl || up < 0) continue;
      atomicAdd(&s.nu[up * F + i % F], max(0, kq_sub(s.nu[i], s.ng[i])));
    }
    __syncthreads();
  }
}

// One member row's usage went from `was` to `now` in column f: its CQ
// node's usage moves by the same amount, and each ancestor's by the
// change of its child's term max(0, usage - guaranteed), up the chain
// until a term stays the same.  The plane is a wrapping int32 sum of the
// terms, so replacing one term gives what rebuild() would, bit for bit.
__device__ void retarget(const State& s, int p, int F, int f, int was,
                         int now) {
  if (was == now) return;
  int before = s.nu[p * F + f];
  int after = kq_add(before, kq_sub(now, was));
  s.nu[p * F + f] = after;
  for (int up = s.npar[p]; up >= 0; p = up, up = s.npar[p]) {
    const int gq = s.ng[p * F + f];
    const int t0 = max(0, kq_sub(before, gq));
    const int t1 = max(0, kq_sub(after, gq));
    if (t0 == t1) break;
    before = s.nu[up * F + f];
    after = kq_add(before, kq_sub(t1, t0));
    s.nu[up * F + f] = after;
  }
}

// quota.cuh kq_available_at on the forest's positions; chains of at most
// four levels are held in registers (the general walk keeps its chain
// in a local array)
__device__ int avail_pos(const BurstArgs& a, const State& s, int pos, int f) {
  if (a.depth > 4) return kq_available_at(s.tp, s.nu, pos, f);
  const int F = a.F;
  int up[4] = {pos, -1, -1, -1};
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    up[i] = (i < a.depth && up[i - 1] >= 0) ? s.npar[up[i - 1]] : -1;
  }
  int avail = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    const int c = up[i];
    if (c < 0) continue;
    const int o = c * F + f;
    const int u = s.nu[o];
    if (s.npar[c] < 0) {
      avail = kq_sub(s.nst[o], u);
    } else {
      const int g = s.ng[o];
      const int local = max(0, kq_sub(g, u));
      int pa = avail;
      if (s.nbl[o]) pa = min(kq_sub(s.nbc[o], max(0, kq_sub(u, g))), avail);
      avail = kq_add(local, pa);
    }
  }
  return avail;
}

// -- heads: argmin of the heap rank over eligible rows, first index ----
__device__ void heads(const BurstArgs& a, const State& s, const int* mem) {
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
      const int ob = __shfl_down_sync(kFull, best, off);
      const int oi = __shfl_down_sync(kFull, bi, off);
      if (ob < best || (ob == best && oi < bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      int* q = s.cq_i + l * Q_N;
      q[Q_ROW] = bi;
      q[Q_FLAGS] = best < kInf ? F_HEAD : 0;
    }
  }
}

// -- classify one flavor slot (classify_np dense twin) ------------------
struct SlotEval {
  bool fit, preempt, borrows;
};

__device__ SlotEval eval_slot(const BurstArgs& a, const State& s, int l,
                              int pos, int sl, const int* req) {
  bool missing = false, all_fit = true, res_nofit = false, borrow = false;
  const int flags = s.cflag[l];
  for (int r = 0; r < a.R; ++r) {
    const int f = s.cslot[(l * a.S + sl) * a.R + r];
    const int q = req[r];
    const bool needed = q > 0;
    if (needed && f < 0) missing = true;
    if (!needed || f < 0) continue;
    const int o = l * a.F + f;
    const int av = avail_pos(a, s, pos, f);
    const bool fit_r = q <= av;
    const bool nofit_r = q > s.cpot[o];
    const bool capable = q <= s.cnom[o] || (flags & CF_CPB);
    if (nofit_r || (!fit_r && !capable)) res_nofit = true;
    if (!fit_r) all_fit = false;
    if (kq_add(s.nu[pos * a.F + f], q) > s.nst[pos * a.F + f]) borrow = true;
  }
  const bool valid = s.cval[l * a.S + sl] != 0;
  SlotEval e;
  e.fit = all_fit && !missing && valid;
  const bool nofit = res_nofit || missing || !valid;
  e.preempt = !e.fit && !nofit;
  e.borrows = borrow && (flags & CF_HAS_PARENT);
  return e;
}

// -- classify + fungibility walk, one thread per member CQ -------------
__device__ void classify(const BurstArgs& a, const State& s, const int* mem,
                         int* s_dflags) {
  const int F = a.F;
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    if (c < 0) continue;
    const int pos = s.npos[l];
    int* q = s.cq_i + l * Q_N;
    const int row = q[Q_ROW];
    const bool has_head = q[Q_FLAGS] & F_HEAD;
    const size_t rr = static_cast<size_t>(c) * a.M + row;
    const int start = a.resume[rr];
    const bool vec = a.vec_ok[rr];
    const int prio = a.wl_prio[rr];
    // the head's request, staged (fita keeps it for the scan)
    int* req = s.fita + l * a.R;
    for (int r = 0; r < a.R; ++r) req[r] = a.wl_req[rr * a.R + r];
    const int cf = s.cflag[l];
    int first_stop = -1, best_mode = -1, best_idx = 0, p_count = 0;
    for (int sl = max(start, 0); sl < a.S; ++sl) {
      const SlotEval e = eval_slot(a, s, l, pos, sl, req);
      const int mode = e.fit ? 2 : (e.preempt ? 1 : 0);
      if (e.preempt) ++p_count;
      if (first_stop < 0 && (e.fit || (e.preempt && (cf & CF_WCP))) &&
          (!e.borrows || (cf & CF_WCB))) {
        first_stop = sl;
      }
      if (mode > best_mode) {
        best_mode = mode;
        best_idx = sl;
      }
    }
    const bool has_stop = first_stop >= 0;
    const int chosen = has_stop ? first_stop : best_idx;
    const SlotEval ce = eval_slot(a, s, l, pos, chosen, req);
    // with no active slot the pick is slot 0 in mode 0
    const int mode = chosen < start ? 0 : (ce.fit ? 2 : (ce.preempt ? 1 : 0));
    int slot_cnt = 0;
    for (int sl = 0; sl < a.S; ++sl) slot_cnt += s.cval[l * a.S + sl] ? 1 : 0;
    const bool has_fit = mode == 2 && has_head;
    const bool has_preempt = mode == 1 && has_head;
    // frsNeedingPreemption and the request on the chosen slot
    int* wu = s.wu + l * F;
    int* need = s.need + l * F;
    for (int f = 0; f < F; ++f) {
      wu[f] = 0;
      need[f] = 0;
    }
    for (int r = 0; r < a.R; ++r) {
      const int f = s.cslot[(l * a.S + chosen) * a.R + r];
      // the fit slot's pairs for the scan (the fit slot is the chosen)
      s.fitf[l * a.R + r] = (has_fit && f >= 0 && req[r] > 0) ? f : -1;
      if (f < 0 || req[r] <= 0) continue;
      wu[f] = kq_add(wu[f], req[r]);
      if (!(req[r] <= avail_pos(a, s, pos, f))) need[f] = 1;
    }
    const bool pre_model = has_preempt && (cf & CF_PREEMPT_OK) &&
                           (has_stop || p_count == 1);
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
    q[Q_PRIO] = prio;
  }
}

// -- preemption search ---------------------------------------------------

// candidate slot j of forest g (its row, member lj, and the row's
// admitted flag and priority) for the preemptor (member lp, CQ c): bit 0
// valid, bit 1 same CQ, bit 2 eligible (e_base)
__device__ int cand_eval(const BurstArgs& a, const State& s, int lp, int c,
                         int row, int lj, bool adm, int prio, int prio_head) {
  if (row < 0) return 0;
  const int ci = row / a.M;
  const bool same = ci == c;
  const int bits = 1 | (same ? 2 : 0);
  if (!adm) return bits;
  const int F = a.F;
  const int pj = s.npos[lj];
  bool uses_needed = false, b0 = false;
  for (int f = 0; f < F; ++f) {
    if (!s.need[lp * F + f]) continue;
    if (a.adm_uses[static_cast<size_t>(row) * F + f]) uses_needed = true;
    if (s.ucq[lj * F + f] > s.nst[pj * F + f]) b0 = true;
  }
  b0 = b0 && (s.cflag[lj] & CF_HAS_PARENT);
  const int cf = s.cflag[lp];
  const bool lower = prio < prio_head;
  const bool e_same = same && (cf & CF_WCQ_LOWER) && lower;
  const bool e_cross = !same && (cf & CF_RWC) && b0 &&
                       (!(cf & CF_RWC_ONLY_LOWER) || lower);
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

// workloadFits for the preemptor (member lp, CQ c) on member usage um
// [L, F]: the depth <= 2 form of available_at (burst.py
// avail_from_members)
__device__ bool fits(const BurstArgs& a, const State& s, int lp,
                     const int* mem, const int* um, bool allow_b) {
  const int F = a.F;
  const int pos = s.npos[lp];
  const int pc = s.npar[pos];
  for (int f = 0; f < F; ++f) {
    const int oc = pos * F + f;
    const int w = s.wu[lp * F + f];
    if (w <= 0) continue;
    int root_use = 0;
    for (int l = 0; l < a.L; ++l) {
      if (mem[l] < 0) continue;
      root_use = kq_add(root_use, max(0, kq_sub(um[l * F + f],
                                                s.ng[s.npos[l] * F + f])));
    }
    const int u_self = um[lp * F + f];
    const int g_c = s.ng[oc];
    int avail;
    if (pc >= 0) {
      const int root_avail = kq_sub(s.nst[pc * F + f], root_use);
      const int local = max(0, kq_sub(g_c, u_self));
      const int blim_cap = kq_sub(s.nbc[oc], max(0, kq_sub(u_self, g_c)));
      const int par = s.nbl[oc] ? min(blim_cap, root_avail) : root_avail;
      avail = kq_add(local, par);
    } else {
      avail = kq_sub(s.nst[oc], u_self);
    }
    if (!(w <= avail)) return false;
    if (!allow_b && kq_add(u_self, w) > s.nst[oc]) return false;
  }
  return true;
}

// greedy walk over the sorted eligible candidates, then fill-back
// (preemption.go:275-342), for one search spec; one thread.  Spec 0
// walks every eligible candidate, spec 1 (staged only) the same-CQ ones.
// `kp` gets the kept positions; returns whether the preemptor fitted.
__device__ bool walk(const BurstArgs& a, const State& s, int g, int lp,
                     int c, const int* mem, const int* sval, int n, int spec,
                     bool staged, unsigned* kp) {
  const int F = a.F;
  int* um = s.u_mem + spec * a.L * F;
  for (int i = 0; i < a.L * F; ++i) um[i] = s.ucq[i];
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
    const int lj = a.cand_lmem[gj];
    int* u = um + lj * F;
    if (!same) {
      // live borrowing re-check for cross-CQ candidates
      const int pj = s.npos[lj];
      bool live_b = false;
      for (int f = 0; f < F; ++f) {
        if (s.need[lp * F + f] && u[f] > s.nst[pj * F + f]) live_b = true;
      }
      if (!live_b) continue;
    }
    const int* du = a.adm_usage + static_cast<size_t>(row) * F;
    for (int f = 0; f < F; ++f) u[f] = kq_sub(u[f], du[f]);
    kp[t >> 5] |= 1u << (t & 31);
    lastpos = t;
    fitted = fits(a, s, lp, mem, um, allow_b);
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
    if (fits(a, s, lp, mem, um, allow_b)) {
      kp[t >> 5] &= ~(1u << (t & 31));
    } else {
      for (int f = 0; f < F; ++f) u[f] = kq_sub(u[f], du[f]);
    }
  }
  return true;
}

// the nominate-time searches of one modeled preemptor (member l, CQ c);
// the whole block builds and sorts the candidate order, threads 0 and 32
// walk spec 0 and spec 1, and the kept targets land in tgt_words[k][c]
__device__ void search_lane(const BurstArgs& a, const State& s, int g, int l,
                            int c, int k, const int* mem,
                            unsigned long long* skey, int* sval,
                            unsigned* keep, int* s_int) {
  const int tid = threadIdx.x;
  int* q = s.cq_i + l * Q_N;
  const int prio_head = q[Q_PRIO];
  if (tid == 0) {
    s_int[0] = 0;   // has_cross
    s_int[1] = 0;   // eligible count
    s_int[2] = 0;   // fitted, spec 0
    s_int[3] = 0;   // fitted, spec 1
  }
  __syncthreads();
  // every candidate's bits, kRows a thread with their loads in flight
  for (int j0 = tid; j0 < a.KC; j0 += blockDim.x * kRows) {
    int row[kRows], lj[kRows], prio[kRows];
    bool adm[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = j0 + u * blockDim.x;
      const size_t gj = static_cast<size_t>(g) * a.KC + min(j, a.KC - 1);
      row[u] = j < a.KC ? a.cand_rows[gj] : -1;
      lj[u] = a.cand_lmem[gj];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      adm[u] = a.adm[max(row[u], 0)] != 0;
      prio[u] = a.wl_prio[max(row[u], 0)];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int j = j0 + u * blockDim.x;
      if (j >= a.KC) continue;
      const int b = cand_eval(a, s, l, c, row[u], lj[u], adm[u], prio[u],
                              prio_head);
      s.cbits[j] = static_cast<uint8_t>(b);
      if ((b & 4) && !(b & 2)) s_int[0] = 1;
    }
  }
  __syncthreads();
  const bool has_cross = s_int[0] != 0;
  bool under_nom = true;
  for (int f = 0; f < a.F; ++f) {
    if (s.need[l * a.F + f] &&
        !(s.ucq[l * a.F + f] <
          a.nominal_cq[static_cast<size_t>(c) * a.F + f])) {
      under_nom = false;
    }
  }
  // plan_searches (preemption.go:144-191, bwc == Never)
  const bool staged = has_cross && under_nom;
  for (int j = tid; j < a.KC; j += blockDim.x) {
    const int b = s.cbits[j];
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
    s_int[2] = walk(a, s, g, l, c, mem, sval, n, 0, staged, keep) ? 1 : 0;
  } else if (tid == 32 && staged) {
    s_int[3] =
        walk(a, s, g, l, c, mem, sval, n, 1, staged, keep + a.KCW) ? 1 : 0;
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

// -- in-forest cycle order (entryOrdering): a rank by comparisons -------
// Each entry's place is the count of entries with a smaller key, or an
// equal key at a lower member position: the stable ascending order of
// the keys, as burst.py's argsort and an insertion sort give it.
__device__ void order(const BurstArgs& a, const State& s, const int* mem) {
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    int kv = kInf;
    if (c >= 0) {
      int* q = s.cq_i + l * Q_N;
      int flags = q[Q_FLAGS];
      if ((flags & F_PREMODEL) && !(flags & F_PREEMPTING0)) {
        flags |= F_RESERVE;
        q[Q_FLAGS] = flags;
      }
      if (flags & (F_FIT | F_PREEMPTING0 | F_RESERVE)) {
        const bool eb = (flags & F_FIT) ? (flags & F_BORROWS)
                                        : (flags & F_PBORROWS);
        kv = kq_add(a.wl_cycle_rank[static_cast<size_t>(c) * a.M + q[Q_ROW]],
                    eb ? kBorrowBit : 0);
      }
    }
    s.mkey[l] = kv;
    s.mat[l] = -1;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < a.L; l += blockDim.x) {
    const int kv = s.mkey[l];
    if (kv == kInf) continue;
    int rank = 0;
    for (int m = 0; m < a.L; ++m) {
      const int km = s.mkey[m];
      rank += (km < kv || (km == kv && m < l)) ? 1 : 0;
    }
    s.mat[rank] = l;
  }
  __syncthreads();
}

// dst[target member] -= target usage, for every slot set in words `tw`,
// on one warp's lanes (a lane per word, then its set bits)
__device__ void sub_targets(const BurstArgs& a, int g, const unsigned* tw,
                            int* dst) {
  for (int w = threadIdx.x & 31; w < a.KCW; w += 32) {
    for (unsigned x = tw[w]; x; x &= x - 1) {
      const size_t gj = static_cast<size_t>(g) * a.KC + (w << 5) +
                        __ffs(x) - 1;
      const int row = a.cand_rows[gj];
      const int lj = a.cand_lmem[gj];
      for (int f = 0; f < a.F; ++f) {
        atomicSub(&dst[lj * a.F + f],
                  a.adm_usage[static_cast<size_t>(row) * a.F + f]);
      }
    }
  }
}

// tmark[member] = 1 for the member of every target set in words `tw`,
// on one warp's lanes
__device__ void mark_targets(const BurstArgs& a, const State& s, int g,
                             const unsigned* tw) {
  for (int w = threadIdx.x & 31; w < a.KCW; w += 32) {
    for (unsigned x = tw[w]; x; x &= x - 1) {
      s.tmark[a.cand_lmem[static_cast<size_t>(g) * a.KC + (w << 5) +
                          __ffs(x) - 1]] = 1;
    }
  }
}

// -- admit scan: the forest's entries in order, on warp 0 ---------------
// (`twc`: KCW words of shared memory for an entry's target words)
__device__ void scan(const BurstArgs& a, const State& s, int g, int k,
                     const int* mem, unsigned* twc) {
  const int F = a.F;
  const int tid = threadIdx.x;
  for (int i = tid; i < a.L * F; i += blockDim.x) {
    s.u_scan[i] = s.ucq[i];
    s.u_chk[i] = s.ucq[i];
    s.u_tmp[i] = s.ucq[i];
  }
  for (int l = tid; l < a.L; l += blockDim.x) s.tmark[l] = 0;
  for (int w = tid; w < a.KCW; w += blockDim.x) s.used[w] = 0;
  __syncthreads();
  // the node usage of the cycle's rebuild is the plane of u_tmp = ucq
  if (tid < 32) {
    const int lane = tid;
    bool marks = false;        // some u_tmp row differs from u_chk
    for (int col = 0; col < a.L; ++col) {
      const int l = s.mat[col];
      if (l < 0) break;
      const int cq = mem[l];
      int* q = s.cq_i + l * Q_N;
      const int flags = q[Q_FLAGS];
      const bool lane_pre = flags & F_PREEMPTING0;
      // a preempting entry's target words, read once
      const unsigned* tw = twc;
      bool hit = false;
      if (lane_pre) {
        const unsigned* src =
            a.tgt_words + (static_cast<size_t>(k) * a.C + cq) * a.KCW;
        for (int w = lane; w < a.KCW; w += 32) {
          twc[w] = src[w];
          if (s.used[w] & twc[w]) hit = true;
        }
      }
      const bool overlap = lane_pre && __any_sync(kFull, hit);
      const bool act = lane_pre && !overlap;
      __syncwarp();
      // the check plane with this entry's targets removed: the u_tmp
      // rows that may differ from u_chk (marked) and the targets' rows
      // are refreshed from u_chk, the targets taken off, and each
      // changed row's term replaced up its chain (lanes own columns);
      // without targets a marked row is refreshed as its term moves.
      // An unmarked row follows u_chk at the charge (below).
      if (act) {
        mark_targets(a, s, g, tw);
        __syncwarp();
        for (int m = lane; m < a.L; m += 32) {
          if (!s.tmark[m]) continue;
          for (int f = 0; f < F; ++f) {
            s.u_prev[m * F + f] = s.u_tmp[m * F + f];
            s.u_tmp[m * F + f] = s.u_chk[m * F + f];
          }
        }
        __syncwarp();
        sub_targets(a, g, tw, s.u_tmp);
        __syncwarp();
      }
      if (act || marks) {
        for (int base = 0; base < a.L; base += 32) {
          const int m0 = base + lane;
          unsigned rows = __ballot_sync(kFull, m0 < a.L && s.tmark[m0]);
          if (m0 < a.L) s.tmark[m0] = 0;
          for (; rows; rows &= rows - 1) {
            const int m = base + __ffs(rows) - 1;
            for (int f = lane; f < F; f += 32) {
              const int o = m * F + f;
              int was = s.u_prev[o];
              if (!act) {
                was = s.u_tmp[o];
                s.u_tmp[o] = s.u_chk[o];
              }
              retarget(s, s.npos[m], F, f, was, s.u_tmp[o]);
            }
          }
        }
        __syncwarp();
        // from here u_tmp differs from u_chk in the targets' rows only
        if (act) mark_targets(a, s, g, tw);
        marks = act;
        __syncwarp();
      }
      // the fit re-check on the lanes: the fixed slot's R pairs, and for
      // a preempting entry the F columns of its request
      const int pos = s.npos[l];
      const int* fitf = s.fitf + l * a.R;
      const int* fita = s.fita + l * a.R;
      bool ok = true;
      if (flags & F_FIT) {
        for (int r = lane; r < a.R; r += 32) {
          const int f = fitf[r];
          if (f >= 0 && !(fita[r] <= avail_pos(a, s, pos, f))) {
            ok = false;
          }
        }
      }
      const bool fit_ok = __all_sync(kFull, ok);
      const bool admit = (flags & F_FIT) && fit_ok;
      bool pok = true;
      if (act) {
        for (int f = lane; f < F; f += 32) {
          const int w = s.wu[l * F + f];
          if (w > 0 && !(w <= avail_pos(a, s, pos, f))) {
            pok = false;
          }
        }
      }
      const bool pre_ok = __all_sync(kFull, pok);
      const bool pre_now = act && pre_ok;
      const bool is_res = flags & F_RESERVE;
      if (admit || pre_now || is_res) {
        const bool marked = s.tmark[l] != 0;
        for (int f = lane; f < F; f += 32) {
          const int o = l * F + f;
          int d = 0;
          if (admit) {
            for (int r = 0; r < a.R; ++r) {
              if (fitf[r] == f) d = kq_add(d, fita[r]);
            }
          }
          const int w = s.wu[o];
          if (pre_now) d = kq_add(d, w);
          if (is_res && w > 0) {
            // resourcesToReserve (scheduler.go:383)
            const int cur = s.u_scan[o];
            const int res_b = min(w, kq_sub(s.cnpb[o], cur));
            const int res_n = max(0, min(w, kq_sub(s.cnom[o], cur)));
            d = kq_add(d, (flags & F_PBORROWS) ? res_b : res_n);
          }
          s.u_scan[o] = kq_add(s.u_scan[o], d);
          s.u_chk[o] = kq_add(s.u_chk[o], d);
          if (!marked) {
            const int was = s.u_tmp[o];
            s.u_tmp[o] = kq_add(was, d);
            retarget(s, pos, F, f, was, s.u_tmp[o]);
          }
        }
      }
      __syncwarp();
      if (pre_now) {
        sub_targets(a, g, tw, s.u_chk);
        for (int w = lane; w < a.KCW; w += 32) s.used[w] |= tw[w];
      }
      if (lane == 0) {
        q[Q_FLAGS] = flags | (admit ? F_ADMITTED : 0) |
                     (pre_now ? F_PREEMPTING : 0) |
                     (act && !pre_ok ? F_PRENOFIT : 0) |
                     (overlap ? F_OVERLAP : 0);
      }
      __syncwarp();
    }
  }
  __syncthreads();
}

// The thread's kRows rows of the forest's [L, M] block from i0 (stride
// blockDim.x): each row's index in the [C, M] planes (0 past the block
// or for a missing member, so every load stays in bounds) and its
// member position (-1 there).
__device__ void member_rows(const BurstArgs& a, const int* mem, int i0,
                            int rows, size_t (&rw)[kRows], int (&lr)[kRows]) {
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = i0 + u * blockDim.x;
    const int l = i < rows ? i / a.M : 0;
    const int c = i < rows ? mem[l] : -1;
    lr[u] = c >= 0 ? l : -1;
    rw[u] = c >= 0 ? static_cast<size_t>(c) * a.M + (i - l * a.M) : 0;
  }
}

// -- end-of-cycle state transitions and the cycle's decision output ----
__device__ void transitions(const BurstArgs& a, const State& s, int g, int k,
                            const int* mem, int* s_int) {
  const int F = a.F;
  const int tid = threadIdx.x;
  for (int l = tid; l < a.L; l += blockDim.x) {
    const int c = mem[l];
    if (c < 0) continue;
    const int* q = s.cq_i + l * Q_N;
    const int flags = q[Q_FLAGS];
    const int row = q[Q_ROW];
    const size_t rr = static_cast<size_t>(c) * a.M + row;
    const bool has_head = flags & F_HEAD;
    const bool has_fit = flags & F_FIT;
    const bool admitted = flags & F_ADMITTED;
    const bool reserve = flags & F_RESERVE;
    const bool overlap = flags & F_OVERLAP;
    const bool pre_nofit = flags & F_PRENOFIT;
    const int tried = q[Q_TRIED];
    const bool pending = tried >= 0;
    int* ad = s.adm_delta + l * F;
    int* rel = s.release + l * F;
    for (int f = 0; f < F; ++f) {
      ad[f] = 0;
      rel[f] = a.ext_release[(static_cast<size_t>(k) * a.C + c) * F + f];
    }
    const int* fitf = s.fitf + l * a.R;
    const int* fita = s.fita + l * a.R;
    if (admitted) {
      for (int r = 0; r < a.R; ++r) {
        if (fitf[r] >= 0) ad[fitf[r]] = kq_add(ad[fitf[r]], fita[r]);
      }
    }
    const bool skipped = has_fit && !admitted;
    const bool park_new =
        ((has_head && !has_fit && !(flags & F_PREEMPT) &&
          !(flags & F_DIRTY)) ||
         (reserve && !pending)) &&
        !(s.cflag[l] & CF_STRICT);
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
        if (fitf[r] >= 0) a.adm_uses[rr * F + fitf[r]] = 1;
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
  for (int j = tid; j < a.KC; j += blockDim.x) {
    if (!((s.used[j >> 5] >> (j & 31)) & 1u)) continue;
    const size_t gj = static_cast<size_t>(g) * a.KC + j;
    const int row = a.cand_rows[gj];
    const int lj = a.cand_lmem[gj];
    for (int f = 0; f < F; ++f) {
      atomicAdd(&s.release[lj * F + f],
                a.adm_usage[static_cast<size_t>(row) * F + f]);
    }
    a.adm[row] = 0;
    a.elig[row] = 1;
    a.death[row] = kInf;
  }
  __syncthreads();
  // modeled finishes of this cycle (an eviction above wins), kRows
  // rows a thread with their loads in flight together
  const int rows = a.L * a.M;
  for (int i0 = tid; i0 < rows; i0 += blockDim.x * kRows) {
    size_t rw[kRows];
    int lr[kRows];
    member_rows(a, mem, i0, rows, rw, lr);
    uint8_t ad[kRows];
    int dt[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      ad[u] = a.adm[rw[u]];
      dt[u] = a.death[rw[u]];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      if (lr[u] < 0 || !ad[u] || dt[u] != k) continue;
      for (int f = 0; f < F; ++f) {
        atomicAdd(&s.release[lr[u] * F + f], a.adm_usage[rw[u] * F + f]);
      }
      a.adm[rw[u]] = 0;
    }
  }
  if (tid == 0) s_int[7] = 0;
  __syncthreads();
  for (int i = tid; i < a.L * F; i += blockDim.x) {
    if (mem[i / F] < 0) continue;
    const int rel = s.release[i];
    s.ucq[i] = kq_sub(kq_add(s.ucq[i], s.adm_delta[i]), rel);
    if (rel > 0) s_int[7] = 1;
  }
  __syncthreads();
  // released quota (or an external event) unparks the whole forest
  if (a.ext_unpark[static_cast<size_t>(k) * a.G + g] || s_int[7] != 0) {
    for (int i0 = tid; i0 < rows; i0 += blockDim.x * kRows) {
      size_t rw[kRows];
      int lr[kRows];
      member_rows(a, mem, i0, rows, rw, lr);
      uint8_t pk[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) pk[u] = a.parked[rw[u]];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        if (lr[u] < 0 || !pk[u]) continue;
        a.parked[rw[u]] = 0;
        a.elig[rw[u]] = 1;
      }
    }
  }
  // only preempting heads keep their target words
  for (int i = tid; i < a.L * a.KCW; i += blockDim.x) {
    const int l = i / a.KCW;
    const int c = mem[l];
    if (c < 0) continue;
    if (!(s.cq_i[l * Q_N + Q_FLAGS] & F_PREEMPTING)) {
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
  int* base = a.gstate != nullptr
      ? a.gstate + static_cast<size_t>(g) * a.state_ints
      : reinterpret_cast<int*>(keep + 2 * a.KCW);
  const State s = carve(a, base);
  stage(a, s, g);
  const int* mem = s.memb;
  for (int k = 0; k < a.K; ++k) {
    if (tid < 3) s_dflags[tid] = 0;
    for (int i = tid; i < a.L * a.KCW; i += blockDim.x) {
      const int c = mem[i / a.KCW];
      if (c >= 0) {
        a.tgt_words[(static_cast<size_t>(k) * a.C + c) * a.KCW +
                    i % a.KCW] = 0;
      }
    }
    rebuild(a, s, g, s.ucq);
    heads(a, s, mem);
    __syncthreads();
    classify(a, s, mem, s_dflags);
    __syncthreads();
    if (tid == 0) {
      for (int i = 0; i < 3; ++i) {
        if (s_dflags[i]) atomicOr(&a.dflags[k * 4 + i], 1);
      }
    }
    for (int l = 0; l < a.L; ++l) {
      const int c = mem[l];
      if (c < 0) continue;
      if (!(s.cq_i[l * Q_N + Q_FLAGS] & F_PREMODEL)) continue;
      search_lane(a, s, g, l, c, k, mem, skey, sval, keep, s_int);
    }
    order(a, s, mem);
    scan(a, s, g, k, mem, keep);
    transitions(a, s, g, k, mem, s_int);
  }
  for (int i = tid; i < a.L * a.F; i += blockDim.x) {
    const int c = mem[i / a.F];
    if (c >= 0) a.u_cq[static_cast<size_t>(c) * a.F + i % a.F] = s.ucq[i];
  }
}

}  // namespace

// ptrs: the BurstArgs pointers in declaration order (inputs, carry,
// outputs, then gmap and gstate, null for the shared route); dims: C, M,
// R, N, F, S, L, KC, K, G, depth, n_levels, NN, runtime, seq_base,
// threads, state_ints, smem_bytes.  Returns -1 when state_ints is not
// this layout's.
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
  a.state_ints = dims[16];
  const int smem_bytes = dims[17];
  a.KCW = a.KC / 32;
  a.KCP = 1;
  while (a.KCP < a.KC) a.KCP <<= 1;
  if (a.state_ints != state_ints(a.NN, a.L, a.F, a.S, a.R, a.KCW)) {
    return -1;
  }
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
  KQ_IN(gmap, int*);
  KQ_IN(gstate, int*);
#undef KQ_IN
  if (a.G < 1 || a.K < 1) return 0;
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_burst_cycles_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  // the registers of a block cap its threads; every loop strides, so
  // fewer threads than asked only take more turns
  cudaFuncAttributes attr;
  cudaFuncGetAttributes(&attr, kq_burst_cycles_kernel);
  const int block = min(threads, attr.maxThreadsPerBlock & ~31);
  kq_burst_cycles_kernel<<<a.G, block, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
