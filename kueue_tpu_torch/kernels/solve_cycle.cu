// solve_cycle: phase 1 of the one-call cycle solver as three kernels.
//
// Replaces the jitted kueue_tpu/ops/cycle.py solve_cycle (:429-534) and
// the phase-1 half of solve_cycle_forests (:649-674).  With the scan on,
// the routed solve_cycle launches, on one stream and without a host
// synchronisation in between:
//
// 1. kq_cq_avail: available_all (:458-461) of every CQ row, for usage0
//    and for zero usage (potential0), both folded top-down along the
//    CQ's ancestor chain in registers (any depth, in segments of up to
//    KQ_CHAIN_SEG levels); the arithmetic is quota.cuh's, whose chain form equals
//    the JAX dense recurrence on forests no deeper than `depth` (the
//    packer's depth is the forest's).  Only the C CQ rows are computed:
//    the classify never reads a cohort's availability.  Staged route (N
//    <= KQ_AVAIL_STAGE_MAX, parent[] in the 48 KB a block gets without
//    the opt-in): each block copies parent[] into shared memory in one
//    coalesced pass of cp.async (the CQ's own cells load meanwhile), a
//    thread resolves its CQ's chain there, then issues the five plane
//    loads of every level of the segment before it uses any, so a chain
//    costs about two global round trips (the staging, the loads) instead
//    of a dependent pair (parent, then the cells) per level.  The F cells of a CQ sit in one warp (32 / F CQs a warp, or
//    ceil(F / 32) warps a CQ), so a level's loads of a CQ coalesce.
//    Global route (wider N): a thread per (CQ, flavor-resource) walks
//    the chain from global memory (kq_chain_top_down).
// 2. kq_classify_heads: the vmapped classify (:463-514).  A group of G
//    lanes per head (G = S rounded up to a power of two, at most 32), lane
//    g owning slot g: it issues its slot's slot_fr cells and requests,
//    then the five [C, F] cells of each pair, KQ_CLASSIFY_RC resources at
//    a time, and folds the pair votes in registers.  Four ballots over the
//    group give S-bit masks (fit, preempt, stop, borrows) on which the
//    FlavorFungibility walk (first stop slot, else the first slot of the
//    best mode) is a few __ffs.  Where S > 32 (the loop route) a warp per
//    head walks chunks of 32 slots.  Writes fit_slot0, borrows0 and
//    preempt0 and, with the scan, the decision pairs
//    (decision_pairs_from_slots, :537, fused): the group's lanes write
//    the chosen slot's dec_fr and dec_amt, lane 0 fit_mask.
// 3. kq_cycle_order: the stable jnp.lexsort of :521 — heads by borrows0,
//    then priority descending, then the float32 timestamp, then index —
//    as a bitonic sort of one 96-bit key per head: hi = borrows << 63 |
//    (-priority, sign bit flipped) << 31 | ts key >> 1, lo = (ts key &
//    1) << 31 | index.  The index makes every key distinct, so the order
//    is total and the sort stable by construction.  The timestamp key
//    follows XLA's sort comparator: -0 is +0, every NaN one NaN after
//    +inf.  Registers route (P <= KQ_ORDER_CHIP_MAX, P >= 128 the
//    power of two >= W): one block of P / E threads holds E keys each in
//    registers; a stage whose partner is in the same thread exchanges in
//    registers, in another lane of the warp by __shfl_xor_sync, and only
//    a stage whose partner is in another warp goes through shared memory
//    (two buffers, one barrier per stage; one buffer and two barriers at
//    16,384).  Padding keys (all ones) sort after every real key.
//    Global route (wider, or no shared memory allowed): the first
//    design, one block of 1,024 threads over two 64-bit words per key in
//    global scratch, a barrier per stage; no path sorts that many heads.
// The admit scan then runs as admit_scan.cu or admit_scan_forests.cu.
//
// Bound: at the probe's shapes (W = 100,000 heads, C = 1,000, S = 4,
// R = 3) the classify moves about 2.9 MB (5.4 MB with the decision
// pairs) and does ~20 int32 operations per (head, slot, resource):
// 0.9-1.6 us at 3.35 TB/s, so latency rules: a thread per head walked
// its S x R pairs as ~24 dependent round trips, a lane per slot makes
// them three (the head, the slot cells, the pair cells) with the lanes
// of a head on one CQ row.  The sort of 1,000 heads is 55 stages: 19 in
// registers, 30 by shuffles, 6 behind a barrier.  Wrapping int32 as
// XLA wraps it: adds and subtracts through quota.cuh's unsigned helpers.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quota.cuh"

#define KQ_SORT_THREADS 1024
#define KQ_CLASSIFY_THREADS 256
#define KQ_ORDER_CHIP_MAX 16384  // the widest sort of the registers route
#define KQ_AVAIL_THREADS 256
#define KQ_AVAIL_STAGE_MAX 12288   // parent[] staged in 48 KB: 4 N bytes

// -- 1. available() of the CQ rows, for usage0 and for zeros ----------------

// One level of the top-down fold for both outputs: a under usage u, p
// under zero usage (quota_kernel.available_at, resource_node.go:89).
__device__ __forceinline__ void kq_avail_step(bool root, int sub, int g,
                                              int bc, bool hb, int u,
                                              int& a, int& p) {
  if (root) {
    a = kq_sub(sub, u);
    p = sub;
    return;
  }
  int pa = a;
  int pp = p;
  if (hb) {
    pa = min(kq_sub(bc, max(0, kq_sub(u, g))), a);
    pp = min(kq_sub(bc, max(0, kq_sub(0, g))), p);
  }
  a = kq_add(max(0, kq_sub(g, u)), pa);
  p = kq_add(max(0, g), pp);
}

// The global route: thread i is cell (i / F, i % F); the chain is
// walked from global memory, a level's cells loaded after its parent.
__device__ __forceinline__ void kq_avail_global(const KqTree& t,
                                                const int* usage0, int C,
                                                int* avail, int* potential) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= static_cast<long long>(C) * t.F) return;
  const int c = static_cast<int>(i / t.F);
  const int f = static_cast<int>(i % t.F);
  int a = 0;   // available() under usage0
  int p = 0;   // available() under zero usage
  kq_chain_top_down(t.parent, c, t.depth, [&](int node) {
    const size_t o = static_cast<size_t>(node) * t.F + f;
    kq_avail_step(t.parent[node] < 0, t.subtree[o], t.guaranteed[o],
                  t.borrow_cap[o], t.has_blim[o] != 0, usage0[o], a, p);
  });
  avail[i] = a;
  potential[i] = p;
}

// The staged route (see the head of the file).  Warp w holds CQs
// w * per .. w * per + per - 1 (per = 32 / F; lane l on column l % F of
// CQ w * per + l / F) for F <= 32, else CQ w / wpc with lane l on
// column (w % wpc) * 32 + l (wpc = ceil(F / 32)).  The CQ's own row of
// cells loads while parent[] is staged.  Segments hold S levels, S the
// launch's depth rounded up to 1, 2, 4, 8 or 16 (KQ_CHAIN_SEG): a shallow
// forest runs a short unrolled loop, whose code a cold SM fetches fast.
template <int S>
__device__ __forceinline__ void kq_avail_staged(const KqTree& t,
                                                const int* usage0, int N,
                                                int C, int* avail,
                                                int* potential) {
  extern __shared__ int s_par[];
  const int* par = t.parent;
  if ((reinterpret_cast<uintptr_t>(par) & 15) == 0) {
    const int n4 = N >> 2;
    for (int j = threadIdx.x; j < n4; j += blockDim.x) {
      __pipeline_memcpy_async(s_par + 4 * j, par + 4 * j, 16);
    }
    for (int j = (n4 << 2) + threadIdx.x; j < N; j += blockDim.x) {
      __pipeline_memcpy_async(s_par + j, par + j, sizeof(int));
    }
  } else {
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      __pipeline_memcpy_async(s_par + j, par + j, sizeof(int));
    }
  }
  __pipeline_commit();
  const int F = t.F;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  int c, f;
  bool live;
  if (F <= 32) {
    const int per = 32 / F;
    const int q = lane / F;
    c = warp * per + q;
    f = lane - q * F;
    live = lane < per * F;
  } else {
    const int wpc = (F + 31) >> 5;
    c = warp / wpc;
    f = (warp - c * wpc) * 32 + lane;
    live = f < F;
  }
  live = live && c < C;
  int u0 = 0, sub0 = 0, g0 = 0, bc0 = 0;
  uint8_t hb0 = 0;
  if (live) {
    const size_t o = static_cast<size_t>(c) * F + f;
    u0 = __ldg(usage0 + o);
    sub0 = __ldg(t.subtree + o);
    g0 = __ldg(t.guaranteed + o);
    bc0 = __ldg(t.borrow_cap + o);
    hb0 = __ldg(t.has_blim + o);
  }
  __pipeline_wait_prior(0);
  __syncthreads();
  if (!live) return;
  int a = 0;
  int p = 0;
  for (int lo = ((t.depth - 1) / S) * S; lo >= 0; lo -= S) {
    const int n_seg = min(t.depth - lo, S);
    int n = c;
    for (int k = 0; k < lo && n >= 0; ++k) n = s_par[n];
    // the segment's chain from shared memory: node[i] i levels above the
    // segment's first (-1 past a root)
    int node[S];
    bool root[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i >= n_seg) break;
      const int up = n >= 0 ? s_par[n] : -1;
      node[i] = n;
      root[i] = up < 0;
      n = up;
    }
    // every level's five cells, all loads in flight before any is used
    int u[S], sub[S], g[S], bc[S];
    uint8_t hb[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i >= n_seg) break;
      if (lo == 0 && i == 0) {      // node[0] is the CQ: its row, loaded
        u[0] = u0;
        sub[0] = sub0;
        g[0] = g0;
        bc[0] = bc0;
        hb[0] = hb0;
        continue;
      }
      u[i] = sub[i] = g[i] = bc[i] = 0;
      hb[i] = 0;
      if (node[i] >= 0) {
        const size_t o = static_cast<size_t>(node[i]) * F + f;
        u[i] = __ldg(usage0 + o);
        sub[i] = __ldg(t.subtree + o);
        g[i] = __ldg(t.guaranteed + o);
        bc[i] = __ldg(t.borrow_cap + o);
        hb[i] = __ldg(t.has_blim + o);
      }
    }
    // the fold, top-down
#pragma unroll
    for (int i = S - 1; i >= 0; --i) {
      if (i < n_seg && node[i] >= 0) {
        kq_avail_step(root[i], sub[i], g[i], bc[i], hb[i] != 0, u[i], a, p);
      }
    }
  }
  const size_t o = static_cast<size_t>(c) * F + f;
  avail[o] = a;
  potential[o] = p;
}

// S: the staged route's segment length, 0 the global route.
template <int S>
__global__ void __launch_bounds__(KQ_AVAIL_THREADS)
kq_cq_avail_kernel(KqTree t, const int* usage0, int N, int C, int* avail,
                   int* potential) {
  if constexpr (S > 0) {
    kq_avail_staged<S>(t, usage0, N, C, avail, potential);
  } else {
    kq_avail_global(t, usage0, C, avail, potential);
  }
}

template <int S>
static void kq_cq_avail_launch(const KqTree& t, const int* usage0, int N,
                               int C, int* avail, int* potential,
                               cudaStream_t stream) {
  const int F = t.F;
  long long threads;
  size_t smem = 0;
  if (S > 0) {
    threads = 32 * (F <= 32 ? (C + 32 / F - 1) / (32 / F)
                            : static_cast<long long>(C) * ((F + 31) / 32));
    smem = static_cast<size_t>(N) * sizeof(int);
  } else {
    threads = static_cast<long long>(C) * F;
  }
  const int blocks = static_cast<int>(
      (threads + KQ_AVAIL_THREADS - 1) / KQ_AVAIL_THREADS);
  kq_cq_avail_kernel<S><<<blocks, KQ_AVAIL_THREADS, smem, stream>>>(
      t, usage0, N, C, avail, potential);
}

// -- 2. classify each head against its CQ's slots ----------------------------

struct KqClassify {
  const int* wl_cq;          // [W]
  const int* wl_requests;    // [W, R]
  const int* start_slot;     // [W]
  const int* slot_fr;        // [C, S, R]
  const uint8_t* slot_valid; // [C, S]
  const int* nominal_cq;     // [C, F]
  const int* usage0;         // [N, F] (CQ rows read)
  const int* subtree;        // [N, F] (CQ rows read)
  const int* parent;         // [N]
  const uint8_t* can_preempt_borrow;  // [C]
  const uint8_t* wcb_borrow;          // [C]
  const uint8_t* wcp_preempt;         // [C]
  const int* avail0;         // [C, F]
  const int* potential0;     // [C, F]
  int* fit_slot0;            // [W]
  uint8_t* borrows0;         // [W]
  uint8_t* preempt0;         // [W]
  int* dec_fr;               // [W, R] or null (no scan)
  int* dec_amt;              // [W, R]
  uint8_t* fit_mask;         // [W]
  int W, S, R, F;
};

// A pair's four votes: a needed resource the slot does not cover; a
// relevant pair that does not fit; one that can never fit here (over the
// potential, or over the available and not preempt-capable); one whose
// charge would pass its subtree quota (wrapping add).  The five cells are
// loaded whatever the pair (at column 0 for an uncovered one), so that a
// lane's loads of several pairs issue together.
struct KqPairVotes {
  bool missing, notfit, nofit, borrow;
};

__device__ __forceinline__ KqPairVotes kq_pair_votes(const KqClassify& k,
                                                     int cq, int fr, int rq,
                                                     bool can_pb) {
  const size_t o = static_cast<size_t>(cq) * k.F + max(fr, 0);
  const int av = k.avail0[o];
  const int pot = k.potential0[o];
  const int nom = k.nominal_cq[o];
  const int use = k.usage0[o];
  const int sub = k.subtree[o];
  const bool rel = fr >= 0 && rq > 0;
  const bool fit_r = rq <= av;
  return KqPairVotes{
      rq > 0 && fr < 0, rel && !fit_r,
      rel && (rq > pot || (!fit_r && !(rq <= nom || can_pb))),
      rel && kq_add(use, rq) > sub};
}

// The group's G bits of a warp-wide ballot (lanes base .. base + G - 1).
template <int G>
__device__ __forceinline__ unsigned kq_group_ballot(bool v, int base) {
  const unsigned b = __ballot_sync(0xffffffffu, v);
  return G == 32 ? b : (b >> base) & ((1u << G) - 1u);
}

#define KQ_CLASSIFY_RC 4   // resources a lane loads at once

// G lanes per head, lane g owning slot g (G: S rounded up to a power of
// two).  kLoop (G = 32): S > 32 slots (or the route forced), so the warp
// walks chunks of 32 slots.  A lane loads its slot's pairs
// KQ_CLASSIFY_RC resources at a time (the slot_fr cells, the requests,
// then the five cells of each), folds the votes in registers, and four
// ballots give the group S-bit masks (fit, preempt, stop, borrows) on
// which the walk is a few __ffs.  No lane returns before the ballots:
// every lane of a warp takes part, padding groups (w >= W) with votes of
// false.
template <int G, bool kLoop>
__global__ void __launch_bounds__(KQ_CLASSIFY_THREADS)
kq_classify_heads_kernel(KqClassify k) {
  const int lane = threadIdx.x & 31;
  const int g = lane & (G - 1);
  const int base = lane & ~(G - 1);
  const long long w = (static_cast<long long>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / G;
  const bool live = w < k.W;
  const int S = k.S;
  const int R = k.R;
  const int q = live ? k.wl_cq[w] : -1;
  const bool valid = q >= 0;
  const int cq = max(q, 0);
  const int start = live ? k.start_slot[w] : 0;
  const bool can_pb = k.can_preempt_borrow[cq] != 0;
  const bool wcb = k.wcb_borrow[cq] != 0;
  const bool wcp = k.wcp_preempt[cq] != 0;
  const bool has_parent = k.parent[cq] >= 0;
  const int* req = k.wl_requests + static_cast<size_t>(live ? w : 0) * R;
  const int* frs = k.slot_fr + static_cast<size_t>(cq) * S * R;
  int stop_idx = -1, stop_mode = 0, best_idx = 0, best_mode = -1;
  bool stop_b = false, best_b = false;
  for (int s0 = 0; s0 < S; s0 += G) {    // one pass without the loop
    const int s = s0 + g;                // this lane's slot
    const bool in = live && s < S;
    bool slot_ok = false, missing = false, notfit = false, nofit = false;
    bool borrow = false;
    if (in) {
      slot_ok = k.slot_valid[static_cast<size_t>(cq) * S + s] != 0;
      const int* row = frs + static_cast<size_t>(s) * R;
      for (int r0 = 0; r0 < R; r0 += KQ_CLASSIFY_RC) {
        int fr[KQ_CLASSIFY_RC], rq[KQ_CLASSIFY_RC];
#pragma unroll
        for (int i = 0; i < KQ_CLASSIFY_RC; ++i) {
          const bool ok = r0 + i < R;
          fr[i] = ok ? row[r0 + i] : -1;
          rq[i] = ok ? req[r0 + i] : 0;
        }
#pragma unroll
        for (int i = 0; i < KQ_CLASSIFY_RC; ++i) {
          const KqPairVotes v = kq_pair_votes(k, cq, fr[i], rq[i], can_pb);
          missing |= v.missing;
          notfit |= v.notfit;
          nofit |= v.nofit;
          borrow |= v.borrow;
        }
      }
    }
    const bool fit = !notfit && !missing && slot_ok;
    const bool pre = !fit && !(nofit || missing || !slot_ok);
    const bool bor = borrow && has_parent;
    const bool active = s >= start;
    const bool stop = active && (fit || (pre && wcp)) && (!bor || wcb);
    const unsigned m_fit = kq_group_ballot<G>(in && active && fit, base);
    const unsigned m_pre = kq_group_ballot<G>(in && active && pre, base);
    const unsigned m_stop = kq_group_ballot<G>(in && stop, base);
    const unsigned m_bor = kq_group_ballot<G>(in && bor, base);
    if (stop_idx < 0 && m_stop != 0) {   // the first stop slot
      const int i = __ffs(m_stop) - 1;
      stop_idx = s0 + i;
      stop_mode = (m_fit >> i) & 1u ? 2 : 1;
      stop_b = (m_bor >> i) & 1u;
    }
    // the first slot of the chunk's best mode (mode 0: its first slot)
    const int mode = m_fit != 0 ? 2 : (m_pre != 0 ? 1 : 0);
    if (mode > best_mode) {
      const int i = mode == 2 ? __ffs(m_fit) - 1
                              : (mode == 1 ? __ffs(m_pre) - 1 : 0);
      best_idx = s0 + i;
      best_mode = mode;
      best_b = (m_bor >> i) & 1u;
    }
  }
  const bool has_stop = stop_idx >= 0;
  const int mode = has_stop ? stop_mode : best_mode;
  const bool has_fit = valid && mode == 2;
  const int fit_slot = has_fit ? (has_stop ? stop_idx : best_idx) : -1;
  if (!live) return;
  if (g == 0) {
    k.fit_slot0[w] = fit_slot;
    k.borrows0[w] = has_fit && (has_stop ? stop_b : best_b);
    k.preempt0[w] = valid && mode == 1;
    if (k.dec_fr != nullptr) k.fit_mask[w] = has_fit;
  }
  if (k.dec_fr == nullptr) return;
  // the decision pairs of the chosen slot (slot 0's without a fit), the
  // group's lanes taking resources g, g + G, ...
  const int* row = frs + static_cast<size_t>(max(fit_slot, 0)) * R;
  for (int r = g; r < R; r += G) {
    const int fr = row[r];
    const int rq = req[r];
    const bool rel = has_fit && fr >= 0 && rq > 0;
    k.dec_fr[static_cast<size_t>(w) * R + r] = rel ? fr : -1;
    k.dec_amt[static_cast<size_t>(w) * R + r] = rel ? rq : 0;
  }
}

// -- 3. the cycle order: a stable sort by (borrows, -priority, ts, index) ----

// The float32 timestamp as an unsigned key in XLA's sort order.
__device__ __forceinline__ unsigned kq_ts_key(float x) {
  unsigned b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;              // -0 sorts as +0
  if (x != x) b = 0x7fc00000u;        // every NaN is one NaN, last
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// -priority, wrapping at INT_MIN, as an unsigned key in signed order.
__device__ __forceinline__ unsigned kq_prio_key(int priority) {
  return (0u - static_cast<unsigned>(priority)) ^ 0x80000000u;
}

// Is key (bh, bl) before key (ah, al)?
__device__ __forceinline__ bool kq_key_less(unsigned long long bh,
                                            unsigned bl,
                                            unsigned long long ah,
                                            unsigned al) {
  return bh < ah || (bh == ah && bl < al);
}

// The registers route: P / E threads, thread t holding positions
// t * E .. t * E + E - 1 (head r * T + t's key in position t * E + r).
// Shared memory: two buffers of P keys (one at E = 16, P = 16,384, which
// two would not fit: a second barrier before each write), position
// t * E + r at r * T + t.
template <int E>
__device__ __forceinline__ void kq_order_chip(const uint8_t* borrows,
                                              const int* priority,
                                              const float* ts, int W, int P,
                                              int* order) {
  extern __shared__ unsigned long long order_smem[];
  const int tid = threadIdx.x;
  const int T = P / E;
  const unsigned full = 0xffffffffu;
  unsigned long long hi[E];
  unsigned lo[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    const int h = r * T + tid;
    if (h < W) {
      const unsigned t = kq_ts_key(ts[h]);
      hi[r] = (static_cast<unsigned long long>(borrows[h] != 0) << 63) |
              (static_cast<unsigned long long>(kq_prio_key(priority[h]))
               << 31) | (t >> 1);
      lo[r] = ((t & 1u) << 31) | static_cast<unsigned>(h);
    } else {
      hi[r] = ~0ull;
      lo[r] = ~0u;
    }
  }
  const int cross = 32 * E;   // from here on the partner is in another warp
  constexpr int kBufs = E < 16 ? 2 : 1;
  int buf = 0;
  for (int k = 2; k <= P; k <<= 1) {
    // partner in another warp: through shared memory, a barrier a stage
    for (int j = k >> 1; j >= cross; j >>= 1) {
      unsigned long long* sh = order_smem + buf * P;
      unsigned* sl =
          reinterpret_cast<unsigned*>(order_smem + kBufs * P) + buf * P;
      if constexpr (kBufs == 2) {
        buf ^= 1;
      } else {
        __syncthreads();   // every read of the stage before is done
      }
      const int other = tid ^ (j / E);
      const bool lower = (tid & (j / E)) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        sh[r * T + tid] = hi[r];
        sl[r * T + tid] = lo[r];
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const unsigned long long oh = sh[r * T + other];
        const unsigned ol = sl[r * T + other];
        const bool up = ((tid * E + r) & k) == 0;
        // keep the smaller key where this position is the lower one of an
        // ascending pair or the upper one of a descending pair
        if (kq_key_less(oh, ol, hi[r], lo[r]) == (lower == up)) {
          hi[r] = oh;
          lo[r] = ol;
        }
      }
    }
    // partner in another lane of this warp: shuffles
    for (int j = min(k >> 1, cross >> 1); j >= E; j >>= 1) {
      const int x = j / E;
      const bool lower = (tid & x) == 0;
#pragma unroll
      for (int r = 0; r < E; ++r) {
        const unsigned long long oh = __shfl_xor_sync(full, hi[r], x);
        const unsigned ol = __shfl_xor_sync(full, lo[r], x);
        const bool up = ((tid * E + r) & k) == 0;
        if (kq_key_less(oh, ol, hi[r], lo[r]) == (lower == up)) {
          hi[r] = oh;
          lo[r] = ol;
        }
      }
    }
    // partner in this thread: registers
#pragma unroll
    for (int j = E / 2; j >= 1; j >>= 1) {
      if (j < k) {
#pragma unroll
        for (int r = 0; r < E; ++r) {
          const int rp = r ^ j;
          if (rp > r) {
            const bool up = ((tid * E + r) & k) == 0;
            if (kq_key_less(hi[rp], lo[rp], hi[r], lo[r]) == up) {
              const unsigned long long th = hi[r];
              hi[r] = hi[rp];
              hi[rp] = th;
              const unsigned tl = lo[r];
              lo[r] = lo[rp];
              lo[rp] = tl;
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    if (tid * E + r < W) {
      order[tid * E + r] = static_cast<int>(lo[r] & 0x7fffffffu);
    }
  }
}

__device__ __forceinline__ bool kq_key_after(const unsigned long long* hi,
                                             const unsigned long long* lo,
                                             int a, int b) {
  return hi[a] > hi[b] || (hi[a] == hi[b] && lo[a] > lo[b]);
}

// The global route: a block of KQ_SORT_THREADS over two 64-bit words per
// key in global scratch (hi = borrows << 32 | priority key, lo = ts key
// << 32 | index), a barrier per stage.
__device__ __forceinline__ void kq_order_global(const uint8_t* borrows,
                                                const int* priority,
                                                const float* ts, int W,
                                                int P,
                                                unsigned long long* hi,
                                                int* order) {
  unsigned long long* lo = hi + P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (i < W) {
      hi[i] = (static_cast<unsigned long long>(borrows[i] != 0) << 32) |
              kq_prio_key(priority[i]);
      lo[i] = (static_cast<unsigned long long>(kq_ts_key(ts[i])) << 32) |
              static_cast<unsigned>(i);
    } else {
      hi[i] = ~0ull;
      lo[i] = ~0ull;
    }
  }
  __syncthreads();
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P; i += blockDim.x) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const bool up = (i & k) == 0;
          if (kq_key_after(hi, lo, i, ixj) == up) {
            const unsigned long long th = hi[i];
            hi[i] = hi[ixj];
            hi[ixj] = th;
            const unsigned long long tl = lo[i];
            lo[i] = lo[ixj];
            lo[ixj] = tl;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    order[i] = static_cast<int>(static_cast<unsigned>(lo[i] & 0xffffffffull));
  }
}

// E keys a thread on the registers route; E = 0: the global route.
template <int E>
__global__ void __launch_bounds__(KQ_SORT_THREADS, 1)
kq_cycle_order_kernel(const uint8_t* borrows, const int* priority,
                      const float* ts, int W, int P,
                      unsigned long long* scratch, int* order) {
  if constexpr (E == 0) {
    kq_order_global(borrows, priority, ts, W, P, scratch, order);
  } else {
    kq_order_chip<E>(borrows, priority, ts, W, P, order);
  }
}

// -- launchers --------------------------------------------------------------

// ptrs: usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
//       avail [C, F], potential [C, F];  dims: N, F, C, depth, S (the
//       staged route's segment length, 1, 2, 4, 8 or KQ_CHAIN_SEG, with
//       N <= KQ_AVAIL_STAGE_MAX; 0: the global route).
extern "C" int kq_cq_avail(void* const* ptrs, const int* dims,
                           cudaStream_t stream) {
  KqTree t{static_cast<const int*>(ptrs[1]),
           static_cast<const int*>(ptrs[2]),
           static_cast<const int*>(ptrs[3]),
           static_cast<const uint8_t*>(ptrs[4]),
           static_cast<const int*>(ptrs[5]), dims[1], dims[3]};
  const int N = dims[0], C = dims[2];
  const int* usage0 = static_cast<const int*>(ptrs[0]);
  int* avail = static_cast<int*>(ptrs[6]);
  int* potential = static_cast<int*>(ptrs[7]);
  if (dims[4] != 0 && N > KQ_AVAIL_STAGE_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (dims[4]) {
    case 0:
      kq_cq_avail_launch<0>(t, usage0, N, C, avail, potential, stream);
      break;
    case 1:
      kq_cq_avail_launch<1>(t, usage0, N, C, avail, potential, stream);
      break;
    case 2:
      kq_cq_avail_launch<2>(t, usage0, N, C, avail, potential, stream);
      break;
    case 4:
      kq_cq_avail_launch<4>(t, usage0, N, C, avail, potential, stream);
      break;
    case 8:
      kq_cq_avail_launch<8>(t, usage0, N, C, avail, potential, stream);
      break;
    case KQ_CHAIN_SEG:
      kq_cq_avail_launch<KQ_CHAIN_SEG>(t, usage0, N, C, avail, potential,
                                       stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int G, bool kLoop>
static void kq_classify_launch(const KqClassify& k, cudaStream_t stream) {
  const long long threads = static_cast<long long>(k.W) * G;
  const int blocks = static_cast<int>(
      (threads + KQ_CLASSIFY_THREADS - 1) / KQ_CLASSIFY_THREADS);
  kq_classify_heads_kernel<G, kLoop>
      <<<blocks, KQ_CLASSIFY_THREADS, 0, stream>>>(k);
}

// ptrs: as KqClassify's fields in order (dec_fr, dec_amt and fit_mask
// null without the scan);  dims: W, S, R, F, G (lanes per head: 1, 2, 4,
// 8, 16 or 32, at least S), loop (1: the loop route, G = 32).
extern "C" int kq_classify_heads(void* const* ptrs, const int* dims,
                                 cudaStream_t stream) {
  KqClassify k{static_cast<const int*>(ptrs[0]),
               static_cast<const int*>(ptrs[1]),
               static_cast<const int*>(ptrs[2]),
               static_cast<const int*>(ptrs[3]),
               static_cast<const uint8_t*>(ptrs[4]),
               static_cast<const int*>(ptrs[5]),
               static_cast<const int*>(ptrs[6]),
               static_cast<const int*>(ptrs[7]),
               static_cast<const int*>(ptrs[8]),
               static_cast<const uint8_t*>(ptrs[9]),
               static_cast<const uint8_t*>(ptrs[10]),
               static_cast<const uint8_t*>(ptrs[11]),
               static_cast<const int*>(ptrs[12]),
               static_cast<const int*>(ptrs[13]),
               static_cast<int*>(ptrs[14]),
               static_cast<uint8_t*>(ptrs[15]),
               static_cast<uint8_t*>(ptrs[16]),
               static_cast<int*>(ptrs[17]),
               static_cast<int*>(ptrs[18]),
               static_cast<uint8_t*>(ptrs[19]),
               dims[0], dims[1], dims[2], dims[3]};
  if (dims[5]) {
    if (dims[4] != 32) return static_cast<int>(cudaErrorInvalidValue);
    kq_classify_launch<32, true>(k, stream);
    return static_cast<int>(cudaGetLastError());
  }
  switch (dims[4]) {
    case 1: kq_classify_launch<1, false>(k, stream); break;
    case 2: kq_classify_launch<2, false>(k, stream); break;
    case 4: kq_classify_launch<4, false>(k, stream); break;
    case 8: kq_classify_launch<8, false>(k, stream); break;
    case 16: kq_classify_launch<16, false>(k, stream); break;
    case 32: kq_classify_launch<32, false>(k, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int E>
static int kq_order_launch(const uint8_t* borrows, const int* priority,
                           const float* ts, int W, int P,
                           unsigned long long* scratch, int* order,
                           int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kq_cycle_order_kernel<E>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = E == 0 ? KQ_SORT_THREADS : P / (E == 0 ? 1 : E);
  kq_cycle_order_kernel<E><<<1, threads, smem, stream>>>(
      borrows, priority, ts, W, P, scratch, order);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: borrows0, priority, timestamp (float32), scratch (2P int64 on the
// global route, else null), order;  dims: W, P, E (keys a thread on the
// registers route: 4 for P <= 4,096, 8 for P = 8,192, 16 for P =
// 16,384; 0: the global route), smem (bytes: the key buffers, 24 P, or
// 12 P at E = 16, where a stage crosses warps, else 0).
extern "C" int kq_cycle_order(void* const* ptrs, const int* dims,
                              cudaStream_t stream) {
  const auto* borrows = static_cast<const uint8_t*>(ptrs[0]);
  const auto* priority = static_cast<const int*>(ptrs[1]);
  const auto* ts = static_cast<const float*>(ptrs[2]);
  auto* scratch = static_cast<unsigned long long*>(ptrs[3]);
  auto* order = static_cast<int*>(ptrs[4]);
  const int W = dims[0], P = dims[1], E = dims[2], smem = dims[3];
  if (E != 0 && (P > KQ_ORDER_CHIP_MAX || P < 32 * E || P % E != 0 ||
                 P / E > KQ_SORT_THREADS)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (E) {
    case 0: return kq_order_launch<0>(borrows, priority, ts, W, P, scratch,
                                      order, 0, stream);
    case 4: return kq_order_launch<4>(borrows, priority, ts, W, P, nullptr,
                                      order, smem, stream);
    case 8: return kq_order_launch<8>(borrows, priority, ts, W, P, nullptr,
                                      order, smem, stream);
    case 16: return kq_order_launch<16>(borrows, priority, ts, W, P,
                                        nullptr, order, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
