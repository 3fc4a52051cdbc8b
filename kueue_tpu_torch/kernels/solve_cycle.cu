// solve_cycle: phase 1 of the one-call cycle solver as three kernels.
//
// Replaces the jitted kueue_tpu/ops/cycle.py solve_cycle (:429-534) and
// the phase-1 half of solve_cycle_forests (:649-674).  With the scan on,
// the routed solve_cycle launches, on one stream and without a host
// synchronisation in between:
//
// 1. kq_cq_avail: available_all (:458-461) of every CQ row, for usage0
//    and for zero usage (potential0).  A thread per (CQ, flavor-resource)
//    walks the CQ's ancestor chain top-down (kq_chain_top_down: any
//    depth) and carries both values; the
//    arithmetic is quota.cuh's kq_available_at, whose chain form equals
//    the JAX dense recurrence on forests no deeper than `depth` (the
//    packer's depth is the forest's).  Only the C CQ rows are computed:
//    the classify never reads a cohort's availability.
// 2. kq_classify_heads: the vmapped classify (:463-514).  A thread per
//    head loops over its CQ's S slots x R resources, classifies each slot
//    fit / preempt / no-fit, runs the FlavorFungibility walk (first stop
//    slot, else the first slot of the best mode) and writes fit_slot0,
//    borrows0 and preempt0.  With the scan it also writes the decision
//    pairs (decision_pairs_from_slots, :537, fused): dec_fr, dec_amt and
//    fit_mask.
// 3. kq_cycle_order: the stable jnp.lexsort of :521 — heads by borrows0,
//    then priority descending, then the float32 timestamp, then index.
//    One block sorts two 64-bit words per head with a bitonic sort:
//    hi = borrows << 32 | (-priority, sign bit flipped) and
//    lo = (timestamp's order-preserving key) << 32 | index.  The index
//    makes every key distinct, so the order is total and the sort stable
//    by construction.  The timestamp key follows XLA's sort comparator:
//    -0 is +0, every NaN one NaN after +inf.  In shared memory while the
//    keys fit, else in global scratch.
// The admit scan then runs as admit_scan.cu or admit_scan_forests.cu.
//
// Bound: at the probe's shapes (W = 100,000 heads, C = 1,000, S = 4,
// R = 3) the classify moves about 2.9 MB (5.4 MB with the decision
// pairs) and does ~20 int32 operations per (head, slot, resource):
// 0.9-1.6 us at 3.35 TB/s, so launch latency rules.
// The sort of 1,000 heads is 55 barrier stages in one block.  Wrapping
// int32 as XLA wraps it: adds and subtracts through quota.cuh's
// unsigned helpers.
#include <cuda_runtime.h>

#include <cstdint>

#include "quota.cuh"

#define KQ_SORT_THREADS 1024

// -- 1. available() of the CQ rows, for usage0 and for zeros ----------------

__global__ void kq_cq_avail_kernel(KqTree t, const int* usage0, int C,
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
    const int u = usage0[o];
    if (t.parent[node] < 0) {
      a = kq_sub(t.subtree[o], u);
      p = t.subtree[o];
    } else {
      const int g = t.guaranteed[o];
      int pa = a;
      int pp = p;
      if (t.has_blim[o]) {
        pa = min(kq_sub(t.borrow_cap[o], max(0, kq_sub(u, g))), a);
        pp = min(kq_sub(t.borrow_cap[o], max(0, kq_sub(0, g))), p);
      }
      a = kq_add(max(0, kq_sub(g, u)), pa);
      p = kq_add(max(0, g), pp);
    }
  });
  avail[i] = a;
  potential[i] = p;
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

__global__ void kq_classify_heads_kernel(KqClassify k) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= k.W) return;
  const int q = k.wl_cq[w];
  const bool valid = q >= 0;
  const int cq = max(q, 0);
  const int* req = k.wl_requests + static_cast<size_t>(w) * k.R;
  const int start = k.start_slot[w];
  const bool can_pb = k.can_preempt_borrow[cq] != 0;
  const bool wcb = k.wcb_borrow[cq] != 0;
  const bool wcp = k.wcp_preempt[cq] != 0;
  const bool has_parent = k.parent[cq] >= 0;
  int stop_idx = -1, stop_mode = 0;
  bool stop_borrows = false;
  int best_idx = 0, best_mode = -1;
  bool best_borrows = false;
  for (int s = 0; s < k.S; ++s) {
    const int* frs = k.slot_fr + (static_cast<size_t>(cq) * k.S + s) * k.R;
    bool missing = false, all_fit = true, any_nofit = false;
    bool any_borrow = false;
    for (int r = 0; r < k.R; ++r) {
      const int fr = frs[r];
      const int rq = req[r];
      const bool covered = fr >= 0;
      const bool needed = rq > 0;
      if (needed && !covered) missing = true;
      if (!(covered && needed)) continue;
      const size_t o = static_cast<size_t>(cq) * k.F + fr;
      const bool fit_r = rq <= k.avail0[o];
      const bool nofit_r = rq > k.potential0[o];
      const bool capable = rq <= k.nominal_cq[o] || can_pb;
      all_fit &= fit_r;
      any_nofit |= nofit_r || (!fit_r && !capable);
      any_borrow |= kq_add(k.usage0[o], rq) > k.subtree[o];
    }
    const bool slot_ok = k.slot_valid[static_cast<size_t>(cq) * k.S + s] != 0;
    const bool fit = all_fit && !missing && slot_ok;
    const bool nofit = any_nofit || missing || !slot_ok;
    const bool preempt = !fit && !nofit;
    const bool borrows = any_borrow && has_parent;
    const bool active = s >= start;
    const int mode = active ? (fit ? 2 : (preempt ? 1 : 0)) : 0;
    if (stop_idx < 0 && active && (fit || (preempt && wcp)) &&
        (!borrows || wcb)) {
      stop_idx = s;
      stop_mode = mode;
      stop_borrows = borrows;
    }
    if (mode > best_mode) {   // the first slot of the best mode
      best_idx = s;
      best_mode = mode;
      best_borrows = borrows;
    }
  }
  const int chosen = stop_idx >= 0 ? stop_idx : best_idx;
  const int mode = stop_idx >= 0 ? stop_mode : best_mode;
  const bool chosen_borrows = stop_idx >= 0 ? stop_borrows : best_borrows;
  const bool has_fit = valid && mode == 2;
  const int fit_slot = has_fit ? chosen : -1;
  k.fit_slot0[w] = fit_slot;
  k.borrows0[w] = has_fit && chosen_borrows;
  k.preempt0[w] = valid && mode == 1;
  if (k.dec_fr == nullptr) return;
  const int* frs = k.slot_fr +
                   (static_cast<size_t>(cq) * k.S + max(fit_slot, 0)) * k.R;
  for (int r = 0; r < k.R; ++r) {
    const bool rel = has_fit && frs[r] >= 0 && req[r] > 0;
    k.dec_fr[static_cast<size_t>(w) * k.R + r] = rel ? frs[r] : -1;
    k.dec_amt[static_cast<size_t>(w) * k.R + r] = rel ? req[r] : 0;
  }
  k.fit_mask[w] = has_fit;
}

// -- 3. the cycle order: a stable sort by (borrows, -priority, ts, index) ----

// The float32 timestamp as an unsigned key in XLA's sort order.
__device__ __forceinline__ unsigned kq_ts_key(float x) {
  unsigned b = __float_as_uint(x);
  if (x == 0.0f) b = 0u;              // -0 sorts as +0
  if (x != x) b = 0x7fc00000u;        // every NaN is one NaN, last
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ bool kq_key_after(const unsigned long long* hi,
                                             const unsigned long long* lo,
                                             int a, int b) {
  return hi[a] > hi[b] || (hi[a] == hi[b] && lo[a] > lo[b]);
}

__global__ void kq_cycle_order_kernel(const uint8_t* borrows,
                                      const int* priority, const float* ts,
                                      int W, int P,
                                      unsigned long long* scratch,
                                      int use_smem, int* order) {
  extern __shared__ unsigned long long sort_smem[];
  unsigned long long* hi = use_smem ? sort_smem : scratch;
  unsigned long long* lo = hi + P;
  for (int i = threadIdx.x; i < P; i += blockDim.x) {
    if (i < W) {
      const unsigned neg = 0u - static_cast<unsigned>(priority[i]);
      hi[i] = (static_cast<unsigned long long>(borrows[i] != 0) << 32) |
              (neg ^ 0x80000000u);
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

// -- launchers --------------------------------------------------------------

// ptrs: usage0, subtree, guaranteed, borrow_cap, has_blim, parent,
//       avail [C, F], potential [C, F];  dims: N, F, C, depth.
extern "C" int kq_cq_avail(void* const* ptrs, const int* dims,
                           cudaStream_t stream) {
  KqTree t{static_cast<const int*>(ptrs[1]),
           static_cast<const int*>(ptrs[2]),
           static_cast<const int*>(ptrs[3]),
           static_cast<const uint8_t*>(ptrs[4]),
           static_cast<const int*>(ptrs[5]), dims[1], dims[3]};
  const long long cells = static_cast<long long>(dims[2]) * dims[1];
  const int threads = 256;
  const int blocks = static_cast<int>((cells + threads - 1) / threads);
  kq_cq_avail_kernel<<<blocks, threads, 0, stream>>>(
      t, static_cast<const int*>(ptrs[0]), dims[2],
      static_cast<int*>(ptrs[6]), static_cast<int*>(ptrs[7]));
  return static_cast<int>(cudaGetLastError());
}

// ptrs: as KqClassify's fields in order (dec_fr, dec_amt and fit_mask
// null without the scan);  dims: W, S, R, F.
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
  const int threads = 128;
  kq_classify_heads_kernel<<<(k.W + threads - 1) / threads, threads, 0,
                             stream>>>(k);
  return static_cast<int>(cudaGetLastError());
}

// ptrs: borrows0, priority, timestamp (float32), scratch (null when the
// keys sort in shared memory), order;  dims: W, P, smem_bytes.
extern "C" int kq_cycle_order(void* const* ptrs, const int* dims,
                              cudaStream_t stream) {
  const int smem = dims[2];
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kq_cycle_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kq_cycle_order_kernel<<<1, KQ_SORT_THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(ptrs[0]), static_cast<const int*>(ptrs[1]),
      static_cast<const float*>(ptrs[2]), dims[0], dims[1],
      static_cast<unsigned long long*>(ptrs[3]), smem > 0,
      static_cast<int*>(ptrs[4]));
  return static_cast<int>(cudaGetLastError());
}
