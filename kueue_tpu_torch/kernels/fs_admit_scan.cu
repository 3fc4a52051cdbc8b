// fs_admit_scan: a fair-sharing cycle's tournament + admit loop in one
// launch.
//
// Replaces kueue_tpu/ops/fs_scan.py fs_admit_scan (:163, a jitted
// lax.scan of W rounds).  Each round of the reference takes the first
// remaining entry e0, computes the post-admission DRS of the remaining
// entries of e0's cohort forest at every level of their paths (int32,
// both divisions floored: kq_floordiv), runs the bottom-up 4-key
// tournament (DRS at the child, -priority, timestamp rank, child order)
// level by level, re-checks the winner's fit and charges its usage up
// the chain.  Quota and the tournament never cross forests, so the
// forests are independent and run in parallel here:
//
// - grid: a block per cohort forest (n_forests, from the caller); the
//   block is sized by the largest forest (at least 128 threads, for the
//   passes over all N and W, at most 256).  Each block counts the nodes
//   and valid entries of its forest and of the forests before it (the
//   offsets of its region when the work arrays live in global scratch),
//   then collects its nodes (forest_of_node == f) and entries (the
//   forest of max(wl_cq, 0)) in ascending index by an ordered block
//   compaction: each thread takes FS_STRIP consecutive indices of a
//   chunk, a warp scan and the warps' totals place them.
// - rounds: the block plays its forest's rounds alone, with the round
//   body above restricted to its lists (local node and entry indices;
//   parents and CQs mapped by binary search in the sorted node list).
//   Usage, the node winners, the four key minima, the promotion slots
//   and the DRS live in shared memory sized by the forest (global
//   scratch past the launcher's budget).  The round's e0 is the lowest
//   remaining entry of the forest: a forest plays a round of the
//   reference exactly when its own lowest remaining entry is the global
//   lowest, so its rounds are the reference's rounds of that forest, in
//   order.  The fit (kq_chain_top_down: any depth) and the charge walk
//   the local chain; an entry's DRS walk carries its usage in a
//   per-thread array of F ints (registers up to FS_MAX_F columns, a
//   global [blocks x threads, F] row beyond).
// - order: forest f's k-th round has the key m_f(k), its lowest
//   remaining entry then; m_f is nondecreasing in k and keys of
//   different forests are different entries, so the reference's global
//   round order is the sort of all rounds by (m_f(k), k).  Each forest
//   writes, for each winner w, key_of[w] = m_f(k) and off_of[w] = k -
//   (the first k with that key), and for each of its entries e the
//   number of its rounds keyed by e (cnt[e]); then admitted and
//   processed.  The last block to finish (a __threadfence and an atomic
//   count of finished blocks in the launch's own scratch word, zeroed by
//   the launch function on the stream) scans cnt over W exclusively
//   (base), writes order[base[key_of[w]] + off_of[w]] = w, -1 past the
//   last round, and clears admitted / processed of the entries that are
//   not valid.  Every valid entry's forest must lie in [0, n_forests).
//
// Bound: latency.  Each forest's rounds are sequential: a forest with k
// entries plays k rounds of 5 + 7 (n_levels - 1) block barriers plus two
// depth-long chain walks each; the forests run side by side, so a launch
// waits on the largest forest's rounds plus the membership pass (2
// barriers for the counts, 2 per chunk of FS_STRIP x threads indices of
// N and of W, 1 for the local maps) and the merge (2, then 2 per chunk
// of W).  At the north-star shape (200 forests of 5 CQs, 1,000 heads,
// 128 threads) that is 5 rounds x 12 + 11 = 71 steps, against 12,000
// when one block played all 1,000 rounds.  A single forest holding every
// CQ plays the same rounds over the same nodes with as many threads as
// one block did before.  The bytes bound (inputs read once, outputs
// written once) is orders of magnitude below that chain.
#include <climits>
#include <cuda_runtime.h>

#include "quota.cuh"

#define FS_MAX_F 64
#define FS_INF 0x7fffffff
#define FS_MAX_DRS 0x7ffffffe   // weight-zero sentinel (MAX_DRS_I32)
#define FS_STRIP 16             // indices a thread takes per chunk
#define FS_LOADS 4              // independent loads a thread keeps in flight
#define FS_FULL 0xffffffffu

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
  int* scratch;        // the global work region (null: shared memory)
  int* carry;          // [blocks x threads, F] when F > FS_MAX_F, else null
  int* aux;            // cnt [W], key_of [W], off_of [W]
  unsigned* done;      // finished blocks (zeroed before the launch)
  int* order;
  uint8_t* admitted;
  uint8_t* processed;
  int N, F, R, W, depth, n_levels, n_forests, cap_nodes, cap_entries;
};

// A forest's work arrays: per local node (n) the global id, the local
// parent, the winner, four key minima, the promotion slot and F usage
// columns; per local entry (E) the global id, the local CQ, remaining
// and the DRS at each of the depth levels.
struct FsLocal {
  int* node;
  int* lpar;
  int* nwin;
  int* mkey[4];
  int* prom;
  int* usage;
  int* ent;
  int* lcq;
  int* rem;
  int* drs;
  int n, E;
};

__device__ __forceinline__ int fs_node_ints(int F) { return F + 8; }
__device__ __forceinline__ int fs_entry_ints(int L) { return L + 3; }

__device__ FsLocal fs_local(int* nodes_base, int* ents_base, int n, int E,
                            int F) {
  FsLocal s;
  s.node = nodes_base;
  s.lpar = s.node + n;
  s.nwin = s.lpar + n;
  s.mkey[0] = s.nwin + n;
  for (int k = 1; k < 4; ++k) s.mkey[k] = s.mkey[k - 1] + n;
  s.prom = s.mkey[3] + n;
  s.usage = s.prom + n;               // [n, F]
  s.ent = ents_base;
  s.lcq = s.ent + E;
  s.rem = s.lcq + E;
  s.drs = s.rem + E;                  // [E, depth]
  s.n = n;
  s.E = E;
  return s;
}

// The forest of entry j, or -1 for an entry that is not valid.
__device__ __forceinline__ int fs_entry_forest(const FsArgs& a, int j) {
  return a.valid[j] ? a.forest_of_node[max(a.wl_cq[j], 0)] : -1;
}

// The forests of entries j0 + q * stride (q < FS_LOADS), -1 for one
// past W or not valid; the loads of all of them issued together.
__device__ __forceinline__ void fs_entry_forests(const FsArgs& a, int j0,
                                                 int stride, int* g) {
  int cq[FS_LOADS];
  bool v[FS_LOADS];
#pragma unroll
  for (int q = 0; q < FS_LOADS; ++q) {
    const int j = j0 + q * stride;
    v[q] = j < a.W && a.valid[j];
    cq[q] = j < a.W ? max(a.wl_cq[j], 0) : 0;
  }
#pragma unroll
  for (int q = 0; q < FS_LOADS; ++q) {
    g[q] = v[q] ? a.forest_of_node[cq[q]] : -1;
  }
}

// The index of global node g in the ascending local node list, -1 if
// absent.
__device__ __forceinline__ int fs_find(const int* node, int n, int g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (node[mid] < g) lo = mid + 1; else hi = mid;
  }
  return lo < n && node[lo] == g ? lo : -1;
}

// Block sums of four ints per thread (every thread gets them).  tmp:
// 128 shared ints; two barriers.
__device__ int4 fs_block_sum4(int4 v, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) {
    v.x += __shfl_xor_sync(FS_FULL, v.x, off);
    v.y += __shfl_xor_sync(FS_FULL, v.y, off);
    v.z += __shfl_xor_sync(FS_FULL, v.z, off);
    v.w += __shfl_xor_sync(FS_FULL, v.w, off);
  }
  if (lane == 0) {
    tmp[4 * warp] = v.x;
    tmp[4 * warp + 1] = v.y;
    tmp[4 * warp + 2] = v.z;
    tmp[4 * warp + 3] = v.w;
  }
  __syncthreads();
  int4 s = make_int4(0, 0, 0, 0);
  for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k) {
    s.x += tmp[4 * k];
    s.y += tmp[4 * k + 1];
    s.z += tmp[4 * k + 2];
    s.w += tmp[4 * k + 3];
  }
  __syncthreads();
  return s;
}

// Ordered compaction of the indices i < count with pred(i) into out, in
// ascending order.  tmp: 32 shared ints.  Two barriers per chunk of
// FS_STRIP x blockDim.x indices.
template <typename Pred>
__device__ void fs_compact(int count, Pred pred, int* out, int* tmp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int base = 0;
  for (int start = 0; start < count; start += FS_STRIP * blockDim.x) {
    const int i0 = start + threadIdx.x * FS_STRIP;
    unsigned keep = 0u;
#pragma unroll
    for (int q = 0; q < FS_STRIP; ++q) {
      if (i0 + q < count && pred(i0 + q)) keep |= 1u << q;
    }
    const int mine = __popc(keep);
    int inc = mine;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FS_FULL, inc, off);
      if (lane >= off) inc += u;
    }
    if (lane == 31) tmp[warp] = inc;
    __syncthreads();
    int before = base, total = 0;
    for (int k = 0; k < warps; ++k) {
      if (k < warp) before += tmp[k];
      total += tmp[k];
    }
    int pos = before + inc - mine;
    for (int q = 0; q < FS_STRIP; ++q) {
      if (keep & (1u << q)) out[pos++] = i0 + q;
    }
    base += total;
    __syncthreads();
  }
}

// DRS of entry j (local CQ node cq) at each of the depth levels of its
// path, with the entry's usage added along the chain
// (TournamentDRS.drs_for).
__device__ void fs_entry_drs(const FsArgs& a, const FsLocal& s, int j, int cq,
                             int* out) {
  const int F = a.F;
  const int R = a.R;
  int carry_regs[FS_MAX_F];
  int* carry = a.carry != nullptr
                   ? a.carry + (static_cast<size_t>(blockIdx.x) * blockDim.x +
                                threadIdx.x) * F
                   : carry_regs;
  for (int f = 0; f < F; ++f) carry[f] = a.u_e[static_cast<size_t>(j) * F + f];
  int node = cq;
  for (int lvl = 0; lvl < a.depth; ++lvl) {
    int dws = 0;
    if (node >= 0) {
      const int g = s.node[node];
      const size_t row = static_cast<size_t>(g) * F;
      const int* usage = s.usage + static_cast<size_t>(node) * F;
      bool has_borrow = false;
      int drs_raw = INT_MIN;
      for (int r = 0; r < R; ++r) {
        int b = 0;
        for (int f = 0; f < F; ++f) {
          const int oh = a.onehot[f * R + r];
          if (oh == 0) continue;
          const int u_after = kq_add(usage[f], carry[f]);
          int bf = max(0, kq_sub(u_after, a.subtree[row + f]));
          if (!a.sq_mask[row + f]) bf = 0;
          b = kq_add(b, kq_mul(bf, oh));
        }
        has_borrow |= b > 0;
        const int lend = a.lendable_r[static_cast<size_t>(g) * R + r];
        const int lend1 = max(lend, 1);
        const int ratio = (b > 0 && lend > 0)
                              ? kq_floordiv(kq_mul(min(b, lend1), 1000), lend1)
                              : -1;
        drs_raw = max(drs_raw, ratio);
      }
      const int w = a.weights[g];
      dws = has_borrow ? kq_floordiv(kq_mul(drs_raw, 1000), max(w, 1)) : 0;
      if (w == 0) dws = FS_MAX_DRS;
      if (a.parent[g] < 0) dws = 0;
      for (int f = 0; f < F; ++f) {
        const int local = max(0, kq_sub(a.guaranteed[row + f], usage[f]));
        carry[f] = max(0, kq_sub(carry[f], local));
      }
      node = s.lpar[node];
    }
    out[lvl] = dws;
  }
}

// available() of local node `node` in column f (quota.cuh
// kq_available_at over the forest's local chain).
__device__ int fs_available(const FsArgs& a, const FsLocal& s, int node,
                            int f) {
  int avail = 0;
  kq_chain_top_down(s.lpar, node, a.depth, [&](int c) {
    const size_t o = static_cast<size_t>(s.node[c]) * a.F + f;
    const int u = s.usage[static_cast<size_t>(c) * a.F + f];
    if (a.parent[s.node[c]] < 0) {
      avail = kq_sub(a.subtree[o], u);
    } else {
      const int g = a.guaranteed[o];
      const int local = max(0, kq_sub(g, u));
      int pa = avail;
      if (a.has_blim[o]) {
        const int used_in_parent = max(0, kq_sub(u, g));
        pa = min(kq_sub(a.borrow_cap[o], used_in_parent), avail);
      }
      avail = kq_add(local, pa);
    }
  });
  return avail;
}

// addUsage() up the local chain in column f (flat_forest.cuh AddStep).
__device__ void fs_add_usage(const FsArgs& a, const FsLocal& s, int node,
                             int delta, int f) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < a.depth && cur >= 0; ++i) {
    int* cell = s.usage + static_cast<size_t>(cur) * a.F + f;
    const int u = *cell;
    const int g = a.guaranteed[static_cast<size_t>(s.node[cur]) * a.F + f];
    *cell = kq_add(u, carry);
    carry = max(0, kq_sub(carry, max(0, kq_sub(g, u))));
    cur = s.lpar[cur];
  }
}

__global__ void kq_fs_admit_scan_kernel(FsArgs a) {
  extern __shared__ int smem[];
  __shared__ int tmp[128];
  __shared__ int misc[4];       // cursor, winner, last block
  const int N = a.N, F = a.F, W = a.W, L = a.depth;
  const int tid = threadIdx.x;
  const int T = blockDim.x;
  const int f = blockIdx.x;
  int* cnt = a.aux;
  int* key_of = a.aux + W;
  int* off_of = a.aux + 2 * W;

  // -- membership: counts here and before, then the ordered lists ------
  // (FS_LOADS indices per thread in flight at once: the loop's loads do
  // not wait on one another)
  int n_here = 0, n_before = 0, e_here = 0, e_before = 0;
  for (int i0 = tid; i0 < N; i0 += FS_LOADS * T) {
    int g[FS_LOADS];
#pragma unroll
    for (int q = 0; q < FS_LOADS; ++q) {
      const int i = i0 + q * T;
      g[q] = i < N ? a.forest_of_node[i] : INT_MAX;
    }
#pragma unroll
    for (int q = 0; q < FS_LOADS; ++q) {
      n_here += g[q] == f;
      n_before += g[q] < f;
    }
  }
  for (int j0 = tid; j0 < W; j0 += FS_LOADS * T) {
    int g[FS_LOADS];
    fs_entry_forests(a, j0, T, g);
#pragma unroll
    for (int q = 0; q < FS_LOADS; ++q) {
      e_here += g[q] == f;
      e_before += g[q] >= 0 && g[q] < f;
    }
  }
  const int4 sums =
      fs_block_sum4(make_int4(n_here, e_here, n_before, e_before), tmp);
  const int n = sums.x, E = sums.y, n_off = sums.z, e_off = sums.w;
  int* nodes_base;
  int* ents_base;
  bool fits = true;
  if (a.scratch != nullptr) {
    nodes_base = a.scratch + static_cast<size_t>(n_off) * fs_node_ints(F);
    ents_base = a.scratch + static_cast<size_t>(N) * fs_node_ints(F) +
                static_cast<size_t>(e_off) * fs_entry_ints(L);
  } else {
    nodes_base = smem;
    ents_base = smem + static_cast<size_t>(a.cap_nodes) * fs_node_ints(F);
    // the launcher's capacity bounds every forest (one head per CQ);
    // a forest past it plays nothing rather than overrun the block
    fits = n <= a.cap_nodes && E <= a.cap_entries;
  }
  FsLocal s = fs_local(nodes_base, ents_base, n, E, F);
  if (E > 0 && fits) {
    fs_compact(N, [&](int i) { return a.forest_of_node[i] == f; }, s.node,
               tmp);
    fs_compact(W, [&](int j) { return fs_entry_forest(a, j) == f; }, s.ent,
               tmp);
    for (int i = tid; i < n; i += T) {
      const int p = a.parent[s.node[i]];
      s.lpar[i] = p < 0 ? -1 : fs_find(s.node, n, p);
    }
    for (int i = tid; i < n * F; i += T) {
      s.usage[i] = a.usage0[static_cast<size_t>(s.node[i / F]) * F + i % F];
    }
    for (int e = tid; e < E; e += T) {
      const int j = s.ent[e];
      s.lcq[e] = fs_find(s.node, n, max(a.wl_cq[j], 0));
      s.rem[e] = 1;
      cnt[j] = 0;
    }
    if (tid == 0) misc[0] = 0;
    __syncthreads();

    // -- the forest's rounds -------------------------------------------
    int k = 0, key_prev = -1, first_k = 0;     // thread 0's
    for (;;) {
      // e0: the forest's first remaining entry; entries only ever leave,
      // so a cursor that never moves back finds it
      if (tid == 0) {
        int c = misc[0];
        while (c < E && !s.rem[c]) ++c;
        misc[0] = c;
      }
      for (int i = tid; i < n; i += T) {
        for (int q = 0; q < 4; ++q) s.mkey[q][i] = FS_INF;
        s.prom[i] = -1;
        s.nwin[i] = -1;
      }
      __syncthreads();
      const int e0 = misc[0];
      if (e0 >= E) break;
      const int cq0 = s.lcq[e0];

      // DRS of the remaining entries; each seeds its CQ's winner
      for (int e = tid; e < E; e += T) {
        if (!s.rem[e]) continue;
        s.nwin[s.lcq[e]] = e;
        fs_entry_drs(a, s, s.ent[e], s.lcq[e],
                     s.drs + static_cast<size_t>(e) * L);
      }
      __syncthreads();

      // tournament: promote each level's winners into their parents
      for (int lvl = a.n_levels - 1; lvl >= 1; --lvl) {
        for (int pass = 0; pass <= 4; ++pass) {
          for (int i = tid; i < n; i += T) {
            const int w = s.nwin[i];
            const int p = s.lpar[i];
            const int g = s.node[i];
            if (a.node_level[g] != lvl || w < 0 || p < 0) continue;
            const int j = s.ent[w];
            const int li = min(max(a.node_level[max(a.wl_cq[j], 0)] - lvl, 0),
                               L - 1);
            const int key[4] = {s.drs[static_cast<size_t>(w) * L + li],
                                kq_sub(0, a.prio[j]), a.ts_rank[j],
                                a.child_order[g]};
            bool ok = true;
            for (int q = 0; q < pass; ++q) ok = ok && key[q] == s.mkey[q][p];
            if (!ok) continue;
            if (pass < 4) {
              atomicMin(&s.mkey[pass][p], key[pass]);
            } else {
              atomicMax(&s.prom[p], w);   // local order is global order
            }
          }
          __syncthreads();
        }
        for (int i = tid; i < n; i += T) {
          if (a.node_level[s.node[i]] == lvl - 1 && s.prom[i] >= 0) {
            s.nwin[i] = s.prom[i];
          }
        }
        __syncthreads();
        for (int i = tid; i < n; i += T) {
          for (int q = 0; q < 4; ++q) s.mkey[q][i] = FS_INF;
          s.prom[i] = -1;
        }
        __syncthreads();
      }

      // the winner: e0 when its CQ has no parent or its tree has no winner
      if (tid == 0) {
        int root = cq0;
        for (int i = 0; i < L - 1; ++i) {
          const int p = s.lpar[root];
          if (p >= 0) root = p;
        }
        const int tw = s.nwin[root];
        misc[1] = (a.parent[s.node[cq0]] < 0 || tw < 0) ? e0 : tw;
      }
      __syncthreads();
      const int win = misc[1];
      const int wj = s.ent[win];
      const int wcq = s.lcq[win];

      // fit re-check and charge (host admit-loop semantics)
      const int* wu = a.u_e + static_cast<size_t>(wj) * F;
      bool ok_f = true;
      for (int c = tid; c < F; c += T) {
        if (wu[c] > 0 && !(wu[c] <= fs_available(a, s, wcq, c))) ok_f = false;
      }
      const bool fit = __syncthreads_and(ok_f) != 0;
      const bool admit = !a.nofit[wj] && fit;
      if (admit) {
        for (int c = tid; c < F; c += T) fs_add_usage(a, s, wcq, wu[c], c);
      }
      if (tid == 0) {
        s.rem[win] = 0;
        a.admitted[wj] = admit;
        a.processed[wj] = 1;
        const int key = s.ent[e0];
        if (key != key_prev) {
          if (key_prev >= 0) cnt[key_prev] = k - first_k;
          key_prev = key;
          first_k = k;
        }
        key_of[wj] = key;
        off_of[wj] = k - first_k;
        ++k;
      }
      __syncthreads();
    }
    if (tid == 0 && key_prev >= 0) cnt[key_prev] = k - first_k;
  } else if (!fits) {
    // no rounds, no keys: the merge leaves these entries out
    for (int j = tid; j < W; j += T) {
      if (fs_entry_forest(a, j) != f) continue;
      cnt[j] = 0;
      key_of[j] = -1;
      a.admitted[j] = 0;
      a.processed[j] = 0;
    }
  }

  // -- the last block to finish merges the forests' rounds --------------
  __threadfence();
  __syncthreads();
  if (tid == 0) misc[2] = atomicAdd(a.done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!misc[2]) return;
  __threadfence();
  // exclusive scan of the per-key round counts over W, in place
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = T >> 5;
  int base = 0;
  for (int start = 0; start < W; start += FS_STRIP * T) {
    const int j0 = start + tid * FS_STRIP;
    int v[FS_STRIP];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < FS_STRIP; ++q) {
      const int j = j0 + q;
      const int c = j < W ? __ldcg(cnt + j) : 0;
      v[q] = j < W && a.valid[j] ? c : 0;
      mine += v[q];
    }
    int inc = mine;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(FS_FULL, inc, off);
      if (lane >= off) inc += u;
    }
    if (lane == 31) tmp[warp] = inc;
    __syncthreads();
    int before = base, total = 0;
    for (int q = 0; q < warps; ++q) {
      if (q < warp) before += tmp[q];
      total += tmp[q];
    }
    int run = before + inc - mine;
#pragma unroll
    for (int q = 0; q < FS_STRIP; ++q) {
      if (j0 + q < W) __stcg(cnt + j0 + q, run);
      run += v[q];
    }
    base += total;
    __syncthreads();
  }
  // base is the number of rounds: every held entry once
  for (int j = tid; j < W; j += T) {
    if (a.valid[j]) {
      const int key = __ldcg(key_of + j);
      const int pos = key >= 0 ? __ldcg(cnt + key) + __ldcg(off_of + j) : -1;
      if (pos >= 0 && pos < W) a.order[pos] = j;
    } else {
      a.admitted[j] = 0;
      a.processed[j] = 0;
    }
    if (j >= base) a.order[j] = -1;
  }
}

// p: the 19 inputs in ops/fs_scan.py FS_ARGS order, then scratch (null:
// shared memory), carry (null up to FS_MAX_F columns), aux [3 W + 1]
// (cnt, key_of, off_of, then the finished-block count), order,
// admitted, processed.  d: N, F, R, W, depth, n_levels, n_forests,
// threads, cap_nodes, cap_entries, smem_bytes (0: the work arrays live
// in scratch).
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
  a.carry = static_cast<int*>(p[20]);
  a.aux = static_cast<int*>(p[21]);
  a.order = static_cast<int*>(p[22]);
  a.admitted = static_cast<uint8_t*>(p[23]);
  a.processed = static_cast<uint8_t*>(p[24]);
  a.N = d[0];
  a.F = d[1];
  a.R = d[2];
  a.W = d[3];
  a.depth = d[4];
  a.n_levels = d[5];
  a.n_forests = d[6];
  const int threads = d[7];
  a.cap_nodes = d[8];
  a.cap_entries = d[9];
  const int smem_bytes = d[10];
  a.done = reinterpret_cast<unsigned*>(a.aux + 3 * static_cast<size_t>(a.W));
  cudaError_t e = cudaMemsetAsync(a.done, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (smem_bytes > 48 * 1024) {
    e = cudaFuncSetAttribute(kq_fs_admit_scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kq_fs_admit_scan_kernel<<<a.n_forests, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
