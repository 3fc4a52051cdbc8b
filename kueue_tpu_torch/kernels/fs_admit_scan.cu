// fs_admit_scan: a fair-sharing cycle's tournament + admit loop in one
// launch.
//
// Replaces kueue_tpu/ops/fs_scan.py fs_admit_scan (a jitted lax.scan of
// W rounds).  Each round takes the first remaining entry e0, computes the
// post-admission DRS of every remaining entry of e0's cohort forest at
// every level of its path (int32, both divisions floored: kq_floordiv),
// runs the bottom-up 4-key tournament (DRS at the child, -priority,
// timestamp rank, child order) level by level, re-checks the winner's fit
// (kq_available_at) and charges its usage up the chain
// (kq_add_usage_chain).  Quota and the tournament never cross forests,
// so entries and nodes of other forests sit the round out; the outputs
// are those of the all-forest scan.
//
// One thread block.  Threads stride over entries (DRS), over nodes (the
// tournament) and own one flavor-resource column each in the fit and the
// charge.  The usage carry, the node winners, the four key minima and the
// promotion slots (each [N + 1]: slot N is JAX's drop bucket, unused here
// because dead rows simply do not scatter) and the per-entry DRS live in
// shared memory when they fit and in global scratch otherwise.  The
// minima are successive atomicMin passes, one per key, each reading the
// finished minima of the keys before it.
//
// Bound: latency.  The rounds are strictly sequential: a launch is
// live_rounds x (5 + 7 x (n_levels - 1)) block barriers plus, per round,
// two depth-long dependent chain walks (fit and charge); the rounds after
// the last remaining entry do not run.  The bytes bound (inputs read once,
// outputs written once) is orders of magnitude below that chain.
#include <climits>
#include <cuda_runtime.h>

#include "quota.cuh"

#define FS_MAX_F 64
#define FS_INF 0x7fffffff
#define FS_MAX_DRS 0x7ffffffe   // weight-zero sentinel (MAX_DRS_I32)

struct FsArgs {
  const int* usage0;
  const int* subtree;
  const uint8_t* sq_mask;
  const int* guaranteed;
  const int* borrow_cap;
  const uint8_t* has_blim;
  const int* parent;
  const int* node_level;
  const int* weights;
  const int* lendable_r;
  const int* onehot;
  const int* child_order;
  const int* wl_cq;
  const int* u_e;
  const uint8_t* nofit;
  const int* prio;
  const int* ts_rank;
  const uint8_t* valid;
  const int* forest_of_node;
  int* scratch;
  int* order;
  uint8_t* admitted;
  uint8_t* processed;
  int N, F, R, W, depth, n_levels, use_smem;
};

// DRS of entry j (CQ node cq) at each of the depth levels of its path,
// with the entry's usage added along the chain (TournamentDRS.drs_for).
__device__ void fs_entry_drs(const FsArgs& a, const int* usage, int j,
                             int cq, int* out) {
  const int F = a.F;
  const int R = a.R;
  int carry[FS_MAX_F];
  for (int f = 0; f < F; ++f) carry[f] = a.u_e[static_cast<size_t>(j) * F + f];
  int node = cq;
  for (int lvl = 0; lvl < a.depth; ++lvl) {
    int dws = 0;
    if (node >= 0) {
      const size_t row = static_cast<size_t>(node) * F;
      bool has_borrow = false;
      int drs_raw = INT_MIN;
      for (int r = 0; r < R; ++r) {
        int b = 0;
        for (int f = 0; f < F; ++f) {
          const int oh = a.onehot[f * R + r];
          if (oh == 0) continue;
          const int u_after = kq_add(usage[row + f], carry[f]);
          int bf = max(0, kq_sub(u_after, a.subtree[row + f]));
          if (!a.sq_mask[row + f]) bf = 0;
          b = kq_add(b, kq_mul(bf, oh));
        }
        has_borrow |= b > 0;
        const int lend = a.lendable_r[static_cast<size_t>(node) * R + r];
        const int lend1 = max(lend, 1);
        const int ratio = (b > 0 && lend > 0)
                              ? kq_floordiv(kq_mul(min(b, lend1), 1000), lend1)
                              : -1;
        drs_raw = max(drs_raw, ratio);
      }
      const int w = a.weights[node];
      dws = has_borrow ? kq_floordiv(kq_mul(drs_raw, 1000), max(w, 1)) : 0;
      if (w == 0) dws = FS_MAX_DRS;
      if (a.parent[node] < 0) dws = 0;
      for (int f = 0; f < F; ++f) {
        const int local = max(0, kq_sub(a.guaranteed[row + f], usage[row + f]));
        carry[f] = max(0, kq_sub(carry[f], local));
      }
      node = a.parent[node];
    }
    out[lvl] = dws;
  }
}

__global__ void kq_fs_admit_scan_kernel(FsArgs a) {
  extern __shared__ int smem[];
  const int N = a.N, F = a.F, W = a.W, L = a.depth;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  int* usage = a.use_smem ? smem : a.scratch;       // [N, F]
  int* nwin = usage + static_cast<size_t>(N) * F;  // [N]
  int* mkey[4];                                     // 4 x [N + 1]
  mkey[0] = nwin + N;
  for (int k = 1; k < 4; ++k) mkey[k] = mkey[k - 1] + N + 1;
  int* prom = mkey[3] + N + 1;                      // [N + 1]
  int* drs = prom + N + 1;                          // [W, L]
  int* rem = drs + static_cast<size_t>(W) * L;      // [W]
  int* misc = rem + W;                              // [2]
  const KqTree t{a.subtree, a.guaranteed, a.borrow_cap, a.has_blim,
                 a.parent, F, L};

  for (int i = tid; i < N * F; i += T) usage[i] = a.usage0[i];
  for (int i = tid; i < W; i += T) {
    rem[i] = a.valid[i];
    a.order[i] = -1;
    a.admitted[i] = 0;
    a.processed[i] = 0;
  }
  if (tid == 0) misc[0] = 0;
  __syncthreads();

  for (int rnd = 0; rnd < W; ++rnd) {
    // e0: the first remaining entry; entries only ever leave, so a
    // cursor that never moves back finds it
    if (tid == 0) {
      int c = misc[0];
      while (c < W && !rem[c]) ++c;
      misc[0] = c;
    }
    for (int n = tid; n <= N; n += T) {
      for (int k = 0; k < 4; ++k) mkey[k][n] = FS_INF;
      prom[n] = -1;
      if (n < N) nwin[n] = -1;
    }
    __syncthreads();
    const int e0 = misc[0];
    if (e0 >= W) break;    // nothing remains: the rounds left stay -1
    const int cq0 = max(a.wl_cq[e0], 0);
    const int fe0 = a.forest_of_node[cq0];

    // DRS of the forest's remaining entries; each seeds its CQ's winner
    for (int j = tid; j < W; j += T) {
      if (!rem[j]) continue;
      const int cq = max(a.wl_cq[j], 0);
      if (a.forest_of_node[cq] != fe0) continue;
      nwin[cq] = j;
      fs_entry_drs(a, usage, j, cq, drs + static_cast<size_t>(j) * L);
    }
    __syncthreads();

    // tournament: promote each level's winners into their parents
    for (int lvl = a.n_levels - 1; lvl >= 1; --lvl) {
      for (int pass = 0; pass <= 4; ++pass) {
        for (int n = tid; n < N; n += T) {
          const int w = nwin[n];
          const int p = a.parent[n];
          if (a.node_level[n] != lvl || w < 0 || p < 0) continue;
          const int li = min(max(a.node_level[max(a.wl_cq[w], 0)] - lvl, 0),
                             L - 1);
          const int key[4] = {drs[static_cast<size_t>(w) * L + li],
                              kq_sub(0, a.prio[w]), a.ts_rank[w],
                              a.child_order[n]};
          bool ok = true;
          for (int k = 0; k < pass; ++k) ok = ok && key[k] == mkey[k][p];
          if (!ok) continue;
          if (pass < 4) {
            atomicMin(&mkey[pass][p], key[pass]);
          } else {
            atomicMax(&prom[p], w);
          }
        }
        __syncthreads();
      }
      for (int n = tid; n < N; n += T) {
        if (a.node_level[n] == lvl - 1 && prom[n] >= 0) nwin[n] = prom[n];
      }
      __syncthreads();
      for (int n = tid; n <= N; n += T) {
        for (int k = 0; k < 4; ++k) mkey[k][n] = FS_INF;
        prom[n] = -1;
      }
      __syncthreads();
    }

    // the winner: e0 when its CQ has no parent or its tree has no winner
    if (tid == 0) {
      int root = cq0;
      for (int i = 0; i < L - 1; ++i) {
        const int p = a.parent[root];
        if (p >= 0) root = p;
      }
      const int tw = nwin[root];
      misc[1] = (a.parent[cq0] < 0 || tw < 0) ? e0 : tw;
    }
    __syncthreads();
    const int win = misc[1];
    const int wcq = max(a.wl_cq[win], 0);

    // fit re-check and charge (host admit-loop semantics)
    int wu = 0;
    bool ok_f = true;
    if (tid < F) {
      wu = a.u_e[static_cast<size_t>(win) * F + tid];
      if (wu > 0) ok_f = wu <= kq_available_at(t, usage, wcq, tid);
    }
    const bool fits = __syncthreads_and(ok_f) != 0;
    const bool admit = !a.nofit[win] && fits;
    if (admit && tid < F) kq_add_usage_chain(t, usage, wcq, wu, tid);
    if (tid == 0) {
      rem[win] = 0;
      a.order[rnd] = win;
      a.admitted[win] = admit;
      a.processed[win] = 1;
    }
    __syncthreads();
  }
}

// p: the 19 inputs in ops/fs_scan.py FS_ARGS order, then scratch, order,
// admitted, processed.  d: N, F, R, W, depth, n_levels, threads,
// smem_bytes (0: the work arrays live in scratch).
extern "C" int kq_fs_admit_scan(void* const* p, const int* d,
                                cudaStream_t stream) {
  FsArgs a;
  a.usage0 = static_cast<const int*>(p[0]);
  a.subtree = static_cast<const int*>(p[1]);
  a.sq_mask = static_cast<const uint8_t*>(p[2]);
  a.guaranteed = static_cast<const int*>(p[3]);
  a.borrow_cap = static_cast<const int*>(p[4]);
  a.has_blim = static_cast<const uint8_t*>(p[5]);
  a.parent = static_cast<const int*>(p[6]);
  a.node_level = static_cast<const int*>(p[7]);
  a.weights = static_cast<const int*>(p[8]);
  a.lendable_r = static_cast<const int*>(p[9]);
  a.onehot = static_cast<const int*>(p[10]);
  a.child_order = static_cast<const int*>(p[11]);
  a.wl_cq = static_cast<const int*>(p[12]);
  a.u_e = static_cast<const int*>(p[13]);
  a.nofit = static_cast<const uint8_t*>(p[14]);
  a.prio = static_cast<const int*>(p[15]);
  a.ts_rank = static_cast<const int*>(p[16]);
  a.valid = static_cast<const uint8_t*>(p[17]);
  a.forest_of_node = static_cast<const int*>(p[18]);
  a.scratch = static_cast<int*>(p[19]);
  a.order = static_cast<int*>(p[20]);
  a.admitted = static_cast<uint8_t*>(p[21]);
  a.processed = static_cast<uint8_t*>(p[22]);
  a.N = d[0];
  a.F = d[1];
  a.R = d[2];
  a.W = d[3];
  a.depth = d[4];
  a.n_levels = d[5];
  const int threads = d[6];
  const int smem_bytes = d[7];
  a.use_smem = smem_bytes > 0;
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_fs_admit_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_fs_admit_scan_kernel<<<1, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
