// admit_scan_preempt: the admit loop with in-scan preemption, cohort
// forests in parallel.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan_preempt (+
// _preempt_entry_decision and _remove_usage_chain).  Three usage-like
// planes are carried: `usage` (the live snapshot: admits, reserves and
// preemptor charges, targets not removed), `check` (usage with every
// issued preemption's targets removed, what fits check against) and
// `trial` (check with the current entry's targets removed).  `used` [T]
// marks targets already preempted this cycle; an entry whose targets
// overlap it is skipped.
//
// Quota never flows between cohort forests and a preemption target lies
// in its preemptor's forest (Kueue preempts within the cohort tree), so
// the scan only orders entries within a forest.  Layout
// (flat_forest.cuh, shared with admit_scan): forests by the caller's
// forest_of_node (a host join makes the forests of a head and its
// targets one) or by their roots, dealt to blocks and warps; a block
// stages its nodes' three planes in shared memory or keeps them in a
// global carry [3, N, F], and lists its heads in cycle order with their
// decision pairs, preemption pairs and targets (each with its CQ's local
// node).  While it lists them it checks that every target's forest is
// its head's: a target elsewhere sets the error word (the launcher's
// caller raises on it) and is dropped, so no entry reads rows its warp
// does not own.  Each warp then decides its own entries in order:
//   - the fit of the head's pairs against `check` (pairs on the lanes,
//     available() walked up the chain, a warp vote);
//   - for a preempting head, the overlap of its targets with `used` (one
//     writer per target: its forest's warp), then the targets removed
//     along their own chains into `trial` (the lanes own the columns),
//     the fit of its preemption pairs against `trial`, and the targets'
//     chains copied trial → check on success or check → trial on
//     failure: the rows a trial changes are those chains, so no plane is
//     copied whole and trial equals check again after every entry;
//   - the charge summed per column in the warp's column row and walked
//     up the head's chain in `usage` and `check` (and copied to `trial`).
// Int32 arithmetic wraps through unsigned, as quota.cuh.
//
// Bound: latency.  Each forest's entries are sequential, each a few
// chains of depth dependent shared-memory steps per target and pair; the
// forests run in parallel on the warps and blocks after the prologue.
#include <cuda_runtime.h>

#include "flat_forest.cuh"

namespace {

using namespace kq_flat;

// head list entry: head, node, bits, the rd decision pairs (columns,
// amounts), the rp preemption pairs, the mt targets, their nodes
constexpr int kEntryHead = 3;
constexpr int kBatch = 8;        // target values loaded together

struct PreArgs {
  Flat a;
  const uint8_t* preempt_mask;
  const int* pre_fr;
  const int* pre_amt;
  const int* tgt_mat;
  const int* tu_cq;
  const int* tu_delta;
  int rp, mt;
  uint8_t* used;
  uint8_t* admitted;
  uint8_t* preempting;
  uint8_t* skip;
  int* error;
};

__device__ __forceinline__ int pre_ent(const PreArgs& p) {
  return kEntryHead + 2 * p.a.c.rd + 2 * p.rp + 2 * p.mt;
}

// Makes trial and check agree again on the targets' chains: trial →
// check when the entry preempts, else check → trial.  The lanes take the
// (target, column) pairs; a row two chains share is copied twice, with
// the same value, and no lane writes what another reads.
template <class Rows>
__device__ void sync_chains(const Rows& check, const Rows& trial,
                            const int* tg, const int* tn, int mt, int depth,
                            bool commit) {
  const int F = check.F;
  const int* src = commit ? trial.u : check.u;
  int* dst = commit ? check.u : trial.u;
  for (int j = threadIdx.x & 31; j < mt * F; j += 32) {
    const int k = j / F;
    const int f = j - k * F;
    if (tg[k] < 0) continue;
    int cur = tn[k];
    for (int i = 0; i < depth && cur >= 0; ++i) {
      const size_t o = static_cast<size_t>(cur) * F + f;
      dst[o] = src[o];
      cur = check.parent(cur);
    }
  }
}

// The deltas in column f of targets k0 .. k0 + kBatch - 1 (0 past the
// row or the width), loaded together.
__device__ __forceinline__ void load_deltas(const PreArgs& p, const int* tg,
                                            int k0, int f, int F,
                                            int (&d)[kBatch]) {
#pragma unroll
  for (int u = 0; u < kBatch; ++u) {
    const int k = k0 + u;
    d[u] = (f < F && k < p.mt && tg[k] >= 0)
        ? p.tu_delta[static_cast<size_t>(tg[k]) * F + f] : 0;
  }
}

// The warp's entries of the list, in order.
template <class Rows>
__device__ void preempt_decide(const PreArgs& p, const Rows& usage,
                               const Rows& check, const Rows& trial,
                               const int* list, int n, int* col) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const Flat& a = p.a;
  const KqCycle& c = a.c;
  const int F = a.t.F;
  const int depth = a.t.depth;
  const int ent = pre_ent(p);
  for (int j = 0; j < n; ++j) {
    const int* e = list + static_cast<size_t>(j) * ent;
    const int bits = e[2];
    if ((bits >> kOwnerShift) != warp) continue;
    const int wi = e[0];
    const int node = e[1];
    const int* dfr = e + kEntryHead;
    const int* damt = dfr + c.rd;
    const int* pfr = damt + c.rd;
    const int* pamt = pfr + p.rp;
    const int* tg = pamt + p.rp;
    const int* tn = tg + p.mt;

    // fit entry: the fixed pairs against the check plane
    bool ok = true;
    if (bits & kFit) {
      for (int r = lane; r < c.rd; r += 32) {
        const int fr = dfr[r];
        if (fr >= 0 && fr < F &&
            damt[r] > available(check, node, fr, depth)) {
          ok = false;
        }
      }
      ok = __all_sync(full, ok);
    }
    const bool admit = (bits & kFit) && ok;

    // preempt entry: overlap, targets removed into trial, fit after it;
    // the lane's first batch of deltas is loaded beside the overlap reads
    const bool is_pre = (bits & kPre) != 0;
    int d0[kBatch];
    if (is_pre) load_deltas(p, tg, 0, lane, F, d0);
    bool overlap = false;
    if (is_pre) {
      for (int k = lane; k < p.mt; k += 32) {
        if (tg[k] >= 0 && p.used[tg[k]]) overlap = true;
      }
      overlap = __any_sync(full, overlap);
    }
    bool preempting = false;
    if (is_pre && !overlap) {
      // each lane's columns, target after target; the targets' deltas
      // are loaded kBatch at a time so their loads overlap
      for (int f = lane; f < F; f += 32) {
        for (int k0 = 0; k0 < p.mt; k0 += kBatch) {
          int d[kBatch];
          if (f == lane && k0 == 0) {
#pragma unroll
            for (int u = 0; u < kBatch; ++u) d[u] = d0[u];
          } else {
            load_deltas(p, tg, k0, f, F, d);
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            if (d[u] != 0) remove_chain(trial, tn[k0 + u], d[u], f, depth);
          }
        }
      }
      __syncwarp();
      bool pre_ok = true;
      for (int r = lane; r < p.rp; r += 32) {
        const int fr = pfr[r];
        if (fr >= 0 && fr < F &&
            pamt[r] > available(trial, node, fr, depth)) {
          pre_ok = false;
        }
      }
      preempting = __all_sync(full, pre_ok);
      if (preempting) {
        for (int k = lane; k < p.mt; k += 32) {
          if (tg[k] >= 0) p.used[tg[k]] = 1;
        }
      }
      __syncwarp();
      sync_chains(check, trial, tg, tn, p.mt, depth, preempting);
      __syncwarp();
    }

    // the charge: admitted pairs, preemption pairs, the reserve
    const bool is_res = (bits & kRes) != 0;
    if (admit || preempting || is_res) {
      for (int f = lane; f < F; f += 32) col[f] = 0;
      __syncwarp();
      if (admit) {
        for (int r = lane; r < c.rd; r += 32) {
          const int fr = dfr[r];
          if (fr >= 0 && fr < F) atomicAdd(&col[fr], damt[r]);
        }
      }
      if (preempting) {
        for (int r = lane; r < p.rp; r += 32) {
          const int fr = pfr[r];
          if (fr >= 0 && fr < F) atomicAdd(&col[fr], pamt[r]);
        }
      }
      if (is_res) {
        // resourcesToReserve (scheduler.go:383-408) on the live usage
        // before this entry's charge
        const int cq = c.wl_cq[wi];
        for (int r = lane; r < c.rr; r += 32) {
          const size_t o = static_cast<size_t>(wi) * c.rr + r;
          const int fr = c.res_fr[o];
          if (fr < 0 || fr >= F) continue;
          const size_t co = static_cast<size_t>(cq) * F + fr;
          const int cur = usage.u[static_cast<size_t>(node) * F + fr];
          const int ramt = c.res_amt[o];
          const int d = (bits & kResBorrows)
              ? min(ramt, kq_sub(c.npb_cq[co], cur))
              : max(0, min(ramt, kq_sub(c.nominal_cq[co], cur)));
          atomicAdd(&col[fr], d);
        }
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        const int d = col[f];
        if (d == 0) continue;
        add_chain(usage, node, d, f, depth);
        add_chain(check, node, d, f, depth);
        int cur = node;
        for (int i = 0; i < depth && cur >= 0; ++i) {
          const size_t o = static_cast<size_t>(cur) * F + f;
          trial.u[o] = check.u[o];
          cur = check.parent(cur);
        }
      }
      __syncwarp();
    }
    if (lane == 0) {
      p.admitted[wi] = admit;
      p.preempting[wi] = preempting;
      p.skip[wi] = is_pre && overlap;
    }
  }
}

__global__ void kq_admit_scan_preempt_kernel(PreArgs p) {
  const Flat& a = p.a;
  const KqCycle& c = a.c;
  Stage st;
  const bool any = stage(
      a, 3, pre_ent(p), st,
      [&](int wi) {
        p.admitted[wi] = 0;
        p.preempting[wi] = 0;
        p.skip[wi] = 0;
      },
      [&](int* e, int h, int fid, bool shared) {
        int* d = e + kEntryHead;
        for (int r = 0; r < c.rd; ++r) {
          const size_t o = static_cast<size_t>(h) * c.rd + r;
          d[r] = c.dec_fr[o];
          d[c.rd + r] = c.dec_amt[o];
        }
        d += 2 * c.rd;
        const bool pre = p.preempt_mask[h] != 0;
        for (int r = 0; r < p.rp; ++r) {
          const size_t o = static_cast<size_t>(h) * p.rp + r;
          d[r] = p.pre_fr[o];
          d[p.rp + r] = p.pre_amt[o];
        }
        d += 2 * p.rp;
        // the targets kBatch at a time, each step's loads together
        for (int k0 = 0; k0 < p.mt; k0 += kBatch) {
          int tk[kBatch], tq[kBatch], tf[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + u;
            tk[u] = (pre && k < p.mt)
                ? p.tgt_mat[static_cast<size_t>(h) * p.mt + k] : -1;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            tq[u] = tk[u] >= 0 ? p.tu_cq[tk[u]] : -1;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            tf[u] = tq[u] >= 0 ? forest_of(a, tq[u]) : fid;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int k = k0 + u;
            if (k >= p.mt) break;
            if (tf[u] != fid) {
              atomicOr(p.error, 1);   // a target outside its forest
              tk[u] = -1;
            }
            d[k] = tk[u];
            d[p.mt + k] = tk[u] < 0 ? -1 : shared ? a.gmap[tq[u]] : tq[u];
          }
        }
        return (c.fit_mask[h] ? kFit : 0) | (c.res_mask[h] ? kRes : 0) |
               (c.res_borrows[h] ? kResBorrows : 0) | (pre ? kPre : 0);
      });
  if (!any) return;

  if (st.shared) {
    const SmemRows r = st.rows;
    preempt_decide(p, r, with_u(r, st.planes_u + st.plane_ints),
                   with_u(r, st.planes_u + 2 * st.plane_ints), st.list,
                   st.n_heads, st.col);
  } else {
    const GlobalRows r{a.t.parent, a.gusage, a.t, a.t.F};
    preempt_decide(p, r, with_u(r, a.gusage + st.plane_ints),
                   with_u(r, a.gusage + 2 * st.plane_ints), st.list,
                   st.n_heads, st.col);
  }
}

}  // namespace

// ptrs: usage0, the 16 planes of admit_scan after it (subtree ..
// res_borrows), order, forest_of_node (or null), preempt_mask, pre_fr,
// pre_amt, tgt_mat, tu_cq, tu_delta, gmap, gusage ([3, N, F] or a
// stub), glist, gcount (or null), gcol (or null), used [T], admitted,
// preempting, overlap_skip, route, error [1]; dims: N, F, W, rd, rr, rp,
// mt, T, depth, blocks, threads, smem_bytes.
extern "C" int kq_admit_scan_preempt(void* const* ptrs, const int* dims,
                                     cudaStream_t stream) {
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto B8 = [&](int i) { return static_cast<const uint8_t*>(ptrs[i]); };
  auto M = [&](int i) { return static_cast<int*>(ptrs[i]); };
  auto M8 = [&](int i) { return static_cast<uint8_t*>(ptrs[i]); };
  PreArgs p;
  Flat& a = p.a;
  a.t = KqTree{I(1), I(2), I(3), B8(4), I(5), dims[1], dims[8]};
  a.c = KqCycle{I(6), I(7), I(8), I(9), I(10), dims[3], B8(11),
                I(12), I(13), dims[4], B8(14), B8(15)};
  a.usage0 = I(0);
  a.order = I(16);
  a.forest_of_node = I(17);
  p.preempt_mask = B8(18);
  p.pre_fr = I(19);
  p.pre_amt = I(20);
  p.tgt_mat = I(21);
  p.tu_cq = I(22);
  p.tu_delta = I(23);
  a.gmap = M(24);
  a.gusage = M(25);
  a.glist = M(26);
  a.gcount = M(27);
  a.gcol = M(28);
  p.used = M8(29);
  p.admitted = M8(30);
  p.preempting = M8(31);
  p.skip = M8(32);
  a.route = M(33);
  p.error = M(34);
  a.n_nodes = dims[0];
  a.W = dims[2];
  p.rp = dims[5];
  p.mt = dims[6];
  const int n_targets = dims[7];
  const int blocks = dims[9];
  const int threads = dims[10];
  const int smem_bytes = dims[11];
  a.smem_ints = smem_bytes / static_cast<int>(sizeof(int));
  if (a.gcount != nullptr) {
    cudaMemsetAsync(a.gcount, 0, sizeof(int), stream);
  }
  if (n_targets > 0) cudaMemsetAsync(p.used, 0, n_targets, stream);
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_preempt_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_preempt_kernel<<<blocks, threads, smem_bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
