// The forest-parallel layout shared by the flat admit_scan,
// admit_scan_forests and admit_scan_preempt: cohort forests decided by
// warps, their rows staged per block.  The row views and chain walks
// (SmemRows / GlobalRows, available, add_chain, remove_chain) also serve
// minimal_preemptions' warp-per-search design.
//
// A forest is a tree of the parent plane, named by the caller's
// forest_of_node when given, else by its root (walked on the device).
// Forest f belongs to block f % gridDim.x and to its warp
// (f / gridDim.x) % warps.  stage() counts a block's nodes and heads;
// when its node rows and head list fit in its dynamic shared memory (the
// shared-memory route) it stages its nodes there — `planes` usage-like
// rows (each a copy of usage0), guaranteed, subtree (roots) or borrow
// cap (the others), the has-borrow-limit bits and each node's parent, by
// local index — and compacts its heads in cycle order into a list of
// fixed-size entries written by the caller; otherwise (the global route)
// its usage-like rows live in a global carry [planes, N, F], its walks
// read the input planes, and its list lives in a global array at an
// offset taken from a counter the launch function zeroes.  Each warp's
// column row [F] sits in shared memory after the staged rows when it
// fits, else in a global [blocks, warps, F] scratch: no F is refused.
#pragma once

#include "admit_entry.cuh"

namespace kq_flat {

constexpr int kItems = 4;        // items per thread in a prologue pass
// entry bits (entry word 2): decision kinds (kDistinct: the flat scans'
// pairs name distinct columns), then the owning warp, then
// (admit_scan_forests) the forest's rank counter within its warp
constexpr int kFit = 1, kRes = 2, kResBorrows = 4, kPre = 8, kDistinct = 16;
constexpr int kOwnerShift = 5;
constexpr int kRankShift = 10;
constexpr int kNoRank = (1 << 21) - 1;   // a head outside [0, n_forests)

struct Flat {
  KqTree t;
  KqCycle c;
  const int* usage0;
  const int* order;
  const int* forest_of_node;   // [N] or null: forests named by roots
  int n_nodes, W, smem_ints;
  int* gmap;                   // [N] node → local index
  int* gusage;                 // [planes, N, F] carries of the global route
  int* gcol;                   // [blocks, warps, F] column rows, or null
  int* glist;                  // [W, ent] lists of the global route
  int* gcount;                 // [1] zeroed per launch, or null
  int* route;                  // [gridDim.x]: 0 no heads, 1 shared, 2 global
};

// Rows of the shared-memory route, by local node index.
struct SmemRows {
  const int* par;
  int* u;
  const int* g;
  const int* cap;              // subtree at roots, borrow cap below
  const unsigned* blim;        // has-borrow-limit bits, words per node
  int F, words;
  __device__ int parent(int n) const { return par[n]; }
  __device__ int* at(int n, int f) const { return u + n * F + f; }
  __device__ int subtree(int n, int f) const { return cap[n * F + f]; }
  __device__ int guaranteed(int n, int f) const { return g[n * F + f]; }
  __device__ int borrow_cap(int n, int f) const { return cap[n * F + f]; }
  __device__ bool has_blim(int n, int f) const {
    return (blim[n * words + (f >> 5)] >> (f & 31)) & 1u;
  }
};

// Rows of the global route: the input planes and a global carry.
struct GlobalRows {
  const int* par;
  int* u;
  KqTree t;
  int F;
  __device__ int parent(int n) const { return par[n]; }
  __device__ int* at(int n, int f) const {
    return u + static_cast<size_t>(n) * F + f;
  }
  __device__ int subtree(int n, int f) const {
    return t.subtree[static_cast<size_t>(n) * F + f];
  }
  __device__ int guaranteed(int n, int f) const {
    return t.guaranteed[static_cast<size_t>(n) * F + f];
  }
  __device__ int borrow_cap(int n, int f) const {
    return t.borrow_cap[static_cast<size_t>(n) * F + f];
  }
  __device__ bool has_blim(int n, int f) const {
    return t.has_blim[static_cast<size_t>(n) * F + f] != 0;
  }
};

// The same rows over another usage-like plane.
template <class Rows>
__device__ Rows with_u(Rows r, int* u) {
  r.u = u;
  return r;
}

// One level of available() below the root from its cells: a node over
// what its parent leaves, `avail` (a root's is its subtree less u).
__device__ __forceinline__ int level_of(int u, int g, int bc, bool blim,
                                        int avail) {
  const int local = max(0, kq_sub(g, u));
  const int pa = blim ? min(kq_sub(bc, max(0, kq_sub(u, g))), avail) : avail;
  return kq_add(local, pa);
}

// One level of available(): node c over what its parent leaves, `avail`.
template <class Rows>
__device__ int level(const Rows& r, int c, int f, int avail) {
  const int u = *r.at(c, f);
  if (r.parent(c) < 0) return kq_sub(r.subtree(c, f), u);
  return level_of(u, r.guaranteed(c, f), r.borrow_cap(c, f),
                  r.has_blim(c, f), avail);
}

// A node's chain of at most four levels, bottom-up, -1 past the root.
template <class Rows>
__device__ void chain4(const Rows& r, int node, int depth, int (&up)[4]) {
  up[0] = node;
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    up[i] = (i < depth && up[i - 1] >= 0) ? r.parent(up[i - 1]) : -1;
  }
}

// available() over a chain4 chain.
template <class Rows>
__device__ int available4(const Rows& r, const int (&up)[4], int f) {
  int avail = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (up[i] >= 0) avail = level(r, up[i], f, avail);
  }
  return avail;
}

// A chain4 chain's cells in one column that no usage walk writes: each
// level's root flag, guaranteed, cap (subtree at a root, borrow cap
// below) and has-borrow-limit bit.
struct Fixed4 {
  bool root[4], bl[4];
  int g[4], cap[4];
};

template <class Rows>
__device__ Fixed4 fixed4(const Rows& r, const int (&up)[4], int f) {
  Fixed4 x{};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (up[i] < 0) continue;
    x.root[i] = r.parent(up[i]) < 0;
    x.g[i] = r.guaranteed(up[i], f);
    x.cap[i] = x.root[i] ? r.subtree(up[i], f) : r.borrow_cap(up[i], f);
    x.bl[i] = r.has_blim(up[i], f);
  }
  return x;
}

// available4 with the chain's fixed cells in registers: only the usage
// cells are read, all at once.
template <class Rows>
__device__ int available4(const Rows& r, const int (&up)[4], const Fixed4& x,
                          int f) {
  int u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (up[i] >= 0) u[i] = *r.at(up[i], f);
  }
  int avail = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (up[i] < 0) continue;
    avail = x.root[i] ? kq_sub(x.cap[i], u[i])
                      : level_of(u[i], x.g[i], x.cap[i], x.bl[i], avail);
  }
  return avail;
}

// quota.cuh kq_available_at over either route's rows; chains of at most
// four levels are held in registers.
template <class Rows>
__device__ int available(const Rows& r, int node, int f, int depth) {
  if (depth <= 4) {
    int up[4];
    chain4(r, node, depth, up);
    return available4(r, up, f);
  }
  int avail = 0;
  kq_chain_top_down(r.par, node, depth,
                    [&](int c) { avail = level(r, c, f, avail); });
  return avail;
}

// The usage walks, each up a node's chain (`node`, `depth`) or up a
// chain4 chain (`up`), level by level from the node.  A step of each:
// (cell, guaranteed, carry) → the new cell, and the carry to the parent.
struct AddStep {       // addUsage() (resource_node.go:123)
  __device__ int operator()(int& u, int g, int carry) const {
    const int local = max(0, kq_sub(g, u));
    u = kq_add(u, carry);
    return max(0, kq_sub(carry, local));
  }
};
struct RemoveStep {    // removeUsage() (resource_node.go:135)
  __device__ int operator()(int& u, int g, int carry) const {
    const int stored_in_parent = kq_sub(u, g);
    u = kq_sub(u, carry);
    return stored_in_parent > 0 ? min(carry, stored_in_parent) : 0;
  }
};
// The undo of the last AddStep walk with the same delta: each cell before
// the add is the charged cell less the carry that reached it, and that
// cell gives the next level's carry as the add did (the add is a
// bijection in wrapping int32), so no chain is kept.
struct UndoAddStep {
  __device__ int operator()(int& u, int g, int carry) const {
    u = kq_sub(u, carry);
    return max(0, kq_sub(carry, max(0, kq_sub(g, u))));
  }
};

template <class Step, class Rows>
__device__ void walk_chain(const Rows& r, int node, int delta, int f,
                           int depth) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < depth && cur >= 0; ++i) {
    int* u = r.at(cur, f);
    int v = *u;
    carry = Step()(v, r.guaranteed(cur, f), carry);
    *u = v;
    cur = r.parent(cur);
  }
}

template <class Step, class Rows>
__device__ void walk_chain4(const Rows& r, const int (&up)[4], int delta,
                            int f) {
  int carry = delta;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (up[i] < 0) break;
    int* u = r.at(up[i], f);
    int v = *u;
    carry = Step()(v, r.guaranteed(up[i], f), carry);
    *u = v;
  }
}

// addUsage() over either route's rows.
template <class Rows>
__device__ void add_chain(const Rows& r, int node, int delta, int f,
                          int depth) {
  walk_chain<AddStep>(r, node, delta, f, depth);
}

// removeUsage() over either route's rows.
template <class Rows>
__device__ void remove_chain(const Rows& r, int node, int delta, int f,
                             int depth) {
  walk_chain<RemoveStep>(r, node, delta, f, depth);
}

// node[k] (-1: none) → its forest id: forest_of_node, or its root, the
// kItems walks advanced together so their loads overlap.
__device__ inline void forests(const Flat& a, int (&node)[kItems]) {
  if (a.forest_of_node != nullptr) {
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (node[k] >= 0) node[k] = max(0, a.forest_of_node[node[k]]);
    }
    return;
  }
  for (int s = 0; s < a.n_nodes; ++s) {
    int up[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      up[k] = node[k] >= 0 ? a.t.parent[node[k]] : -1;
    }
    bool moved = false;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (up[k] >= 0) {
        node[k] = up[k];
        moved = true;
      }
    }
    if (!moved) break;
  }
}

// The forest id of one node (>= 0).
__device__ inline int forest_of(const Flat& a, int n) {
  int v[kItems] = {n, -1, -1, -1};
  forests(a, v);
  return v[0];
}

// Heads: the kItems consecutive order positions of this thread from
// `base` → head index, node (the CQ, or -1), forest id (or -1).
__device__ inline void heads(const Flat& a, int base, int (&wi)[kItems],
                             int (&cq)[kItems], int (&fid)[kItems]) {
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const int i = base + threadIdx.x * kItems + k;
    wi[k] = i < a.W ? a.order[i] : -1;
  }
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    cq[k] = wi[k] >= 0 ? a.c.wl_cq[wi[k]] : -1;
    fid[k] = cq[k];
  }
  forests(a, fid);
}

// What stage() leaves a block.
struct Stage {
  bool shared;          // node rows and list in shared memory
  int n_heads;
  int* list;            // n_heads entries of `ent` ints, in cycle order
  int* col;             // this warp's column row [F]
  SmemRows rows;        // the shared route's rows (plane 0)
  int* planes_u;        // plane p's rows: planes_u + p * plane_ints
  size_t plane_ints;
};

// Count, stage and list this block's forests (see the file comment).
// on_invalid(wi): called once per head without a CQ (wl_cq < 0), by
// block 0.  write(e, wi, fid, shared): fills the entry e of head wi of
// forest fid after its first three words (head, node — local on the
// shared route — and bits) and returns the kind bits; the owning warp's
// bits are added above them.  Returns false when the block has no heads
// (every thread of the block then returns).
template <class OnInvalid, class Write>
__device__ bool stage(const Flat& a, int planes, int ent, Stage& st,
                      OnInvalid on_invalid, Write write) {
  extern __shared__ int smem[];
  __shared__ int s_warp[32];
  __shared__ int s_n[3];      // nodes, heads, a counter / the list base
  const int B = gridDim.x;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nw = blockDim.x >> 5;
  const int F = a.t.F;
  const int N = a.n_nodes;
  const int chunk = blockDim.x * kItems;
  if (tid < 3) s_n[tid] = 0;
  __syncthreads();

  // 1. count this block's nodes and heads
  int nn = 0, nh = 0;
  for (int base = 0; base < N; base += chunk) {
    int fid[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + tid * kItems + k;
      fid[k] = n < N ? n : -1;
    }
    forests(a, fid);
#pragma unroll
    for (int k = 0; k < kItems; ++k) nn += (fid[k] >= 0 && fid[k] % B == b);
  }
  for (int base = 0; base < a.W; base += chunk) {
    int wi[kItems], cq[kItems], fid[kItems];
    heads(a, base, wi, cq, fid);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (wi[k] >= 0 && cq[k] < 0 && b == 0) on_invalid(wi[k]);
      nh += (cq[k] >= 0 && fid[k] % B == b);
    }
  }
  if (nn) atomicAdd(&s_n[0], nn);
  if (nh) atomicAdd(&s_n[1], nh);
  __syncthreads();
  const int n_nodes = s_n[0];
  const int n_heads = s_n[1];
  if (n_heads == 0) {
    if (tid == 0) a.route[b] = 0;
    return false;
  }
  const int words = (F + 31) >> 5;
  const size_t nf = static_cast<size_t>(n_nodes) * F;
  const int node_ints = n_nodes * (2 + words + (planes + 2) * F);
  const bool shared = node_ints + n_heads * ent <= a.smem_ints;
  const int col_base = shared ? node_ints + n_heads * ent : 0;
  const bool col_shared = col_base + nw * F <= a.smem_ints;
  if (tid == 0) a.route[b] = shared ? 1 : 2;
  int* s_node = smem;
  int* s_par = s_node + n_nodes;
  unsigned* s_blim = reinterpret_cast<unsigned*>(s_par + n_nodes);
  int* s_u = s_par + n_nodes + n_nodes * words;
  int* s_g = s_u + planes * nf;
  int* s_cap = s_g + nf;
  int* list = shared ? s_cap + nf : nullptr;
  st.shared = shared;
  st.n_heads = n_heads;
  st.col = col_shared
      ? smem + col_base + warp * F
      : a.gcol + (static_cast<size_t>(b) * nw + warp) * F;
  st.rows = SmemRows{s_par, s_u, s_g, s_cap, s_blim, F, words};
  st.planes_u = shared ? s_u : a.gusage;
  st.plane_ints = shared ? nf : static_cast<size_t>(N) * F;

  // 2. this block's nodes: local indices and rows (shared route), or
  // their usage rows in each plane of the global carry
  __syncthreads();
  if (tid == 0) s_n[2] = 0;
  __syncthreads();
  for (int base = 0; base < N; base += chunk) {
    int fid[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + tid * kItems + k;
      fid[k] = n < N ? n : -1;
    }
    forests(a, fid);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + tid * kItems + k;
      if (fid[k] < 0 || fid[k] % B != b) continue;
      if (shared) {
        const int l = atomicAdd(&s_n[2], 1);
        s_node[l] = n;
        a.gmap[n] = l;
      } else {
        for (int f = 0; f < F; ++f) {
          const size_t o = static_cast<size_t>(n) * F + f;
          for (int p = 0; p < planes; ++p) {
            a.gusage[p * static_cast<size_t>(N) * F + o] = a.usage0[o];
          }
        }
      }
    }
  }
  __syncthreads();
  if (shared) {
    for (int i = tid; i < n_nodes * F; i += blockDim.x) {
      const int n = s_node[i / F];
      const size_t o = static_cast<size_t>(n) * F + i % F;
      const int u0 = a.usage0[o];
      for (int p = 0; p < planes; ++p) s_u[p * nf + i] = u0;
      s_g[i] = a.t.guaranteed[o];
      s_cap[i] = a.t.parent[n] < 0 ? a.t.subtree[o] : a.t.borrow_cap[o];
    }
    for (int i = tid; i < n_nodes * words; i += blockDim.x) {
      const int n = s_node[i / words];
      const int f0 = (i % words) * 32;
      unsigned bitsw = 0;
      for (int f = f0; f < min(F, f0 + 32); ++f) {
        if (a.t.has_blim[static_cast<size_t>(n) * F + f]) {
          bitsw |= 1u << (f - f0);
        }
      }
      s_blim[i] = bitsw;
    }
    for (int l = tid; l < n_nodes; l += blockDim.x) {
      const int p = a.t.parent[s_node[l]];
      s_par[l] = p >= 0 ? a.gmap[p] : -1;
    }
  } else if (tid == 0) {
    s_n[2] = atomicAdd(a.gcount, n_heads);
  }
  __syncthreads();
  if (!shared) list = a.glist + static_cast<size_t>(s_n[2]) * ent;
  st.list = list;

  // 3. this block's heads in cycle order: each thread's kItems
  // consecutive positions, placed by a block scan of the counts
  int count = 0;
  for (int base = 0; base < a.W; base += chunk) {
    int wi[kItems], cq[kItems], fid[kItems];
    heads(a, base, wi, cq, fid);
    int mine = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (cq[k] >= 0 && fid[k] % B == b) mine |= 1 << k;
    }
    const int cnt = __popc(mine);
    int incl = cnt;
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += v;
    }
    if (lane == 31) s_warp[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < nw; ++w) {
      const int v = s_warp[w];
      if (w < warp) before += v;
      total += v;
    }
    int pos = count + before + incl - cnt;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (!((mine >> k) & 1)) continue;
      const int h = wi[k];
      int* e = list + static_cast<size_t>(pos++) * ent;
      e[0] = h;
      e[1] = shared ? a.gmap[cq[k]] : cq[k];
      e[2] = (((fid[k] / B) % nw) << kOwnerShift) |
             write(e, h, fid[k], shared);
    }
    count += total;
    __syncthreads();
  }
  return true;
}

// -- the flat scans: admit_scan and admit_scan_forests ----------------------

// head list entry: head, node, bits, then the head's rd decision pairs
// (columns, then amounts)
constexpr int kFlatHead = 3;

// admit_scan_forests' rank cap (max_wl = 0: none, the flat scan): a head
// whose rank within its forest, in cycle order, is max_wl or more is not
// admitted and never charged.  Each warp counts its forests' heads as it
// decides them, in per_warp counters (a forest's index among its warp's:
// fid / blocks / warps), held after the stage's working set in shared
// memory or, when `global` is set, in a global [blocks, warps, per_warp].
struct RankCap {
  int max_wl;
  int n_forests;
  int per_warp;
  int* global;
};

// The warp's entries of the list, in order: the head's pairs on the
// lanes, each lane's pair checked against available() walked up the
// chain, a warp vote for the fit, then the charge: walked up the chain
// by the pairs' lanes when the pairs name distinct columns and the head
// reserves nothing, else summed per column in the warp's column row and
// walked by the lanes that own the columns.  kCap: `rank` holds this
// warp's counters (RankCap); kShort: chains of at most four levels,
// walked from registers (chain4).
template <bool kCap, bool kShort, class Rows>
__device__ void flat_decide(const Flat& a, const Rows& rows,
                            uint8_t* admitted, const int* list, int n,
                            int* col, int max_wl, int* rank) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int F = a.t.F;
  const KqCycle& c = a.c;
  const int ent = kFlatHead + 2 * c.rd;
  for (int j = 0; j < n; ++j) {
    const int* e = list + static_cast<size_t>(j) * ent;
    int bits = e[2];
    if (((bits >> kOwnerShift) & 31) != warp) continue;
    const int wi = e[0];
    const int node = e[1];
    if constexpr (kCap) {
      const int idx = bits >> kRankShift;
      int r = max_wl;
      if (lane == 0 && idx != kNoRank) {
        r = rank[idx];
        rank[idx] = r + 1;
      }
      if (__shfl_sync(0xffffffffu, r, 0) >= max_wl) bits = 0;
    }
    const int* pfr = e + kFlatHead;
    const int* pamt = pfr + c.rd;
    const int depth = a.t.depth;
    int up[4];
    if constexpr (kShort) chain4(rows, node, depth, up);
    bool ok = true;
    if (bits & kFit) {
      for (int r = lane; r < c.rd; r += 32) {
        const int fr = pfr[r];
        if (fr < 0 || fr >= F) continue;
        int avail;
        if constexpr (kShort) {
          avail = available4(rows, up, fr);
        } else {
          avail = available(rows, node, fr, depth);
        }
        if (pamt[r] > avail) ok = false;
      }
      ok = __all_sync(0xffffffffu, ok);
    }
    const bool admit = (bits & kFit) && ok;
    if (admit && (bits & (kRes | kDistinct)) == kDistinct) {
      // pairs on distinct columns: each pair's lane walks its own column
      const int fr = lane < c.rd ? pfr[lane] : -1;
      const int d = fr >= 0 && fr < F ? pamt[lane] : 0;
      if (d != 0) {
        if constexpr (kShort) {
          walk_chain4<AddStep>(rows, up, d, fr);
        } else {
          add_chain(rows, node, d, fr, depth);
        }
      }
      __syncwarp();
    } else if (admit || (bits & kRes)) {
      // the charge summed per column, walked by the columns' lanes
      for (int f = lane; f < F; f += 32) col[f] = 0;
      __syncwarp();
      if (admit) {
        for (int r = lane; r < c.rd; r += 32) {
          const int fr = pfr[r];
          if (fr >= 0 && fr < F) atomicAdd(&col[fr], pamt[r]);
        }
      }
      if (bits & kRes) {
        // resourcesToReserve (scheduler.go:383-408) on the usage before
        // this entry's charge
        const int cq = c.wl_cq[wi];
        for (int r = lane; r < c.rr; r += 32) {
          const size_t o = static_cast<size_t>(wi) * c.rr + r;
          const int fr = c.res_fr[o];
          if (fr < 0 || fr >= F) continue;
          const size_t co = static_cast<size_t>(cq) * F + fr;
          const int cur = rows.u[static_cast<size_t>(node) * F + fr];
          const int ramt = c.res_amt[o];
          const int d = (bits & kResBorrows)
              ? min(ramt, kq_sub(c.npb_cq[co], cur))
              : max(0, min(ramt, kq_sub(c.nominal_cq[co], cur)));
          atomicAdd(&col[fr], d);
        }
      }
      __syncwarp();
      for (int f = lane; f < F; f += 32) {
        if (col[f] == 0) continue;
        if constexpr (kShort) {
          walk_chain4<AddStep>(rows, up, col[f], f);
        } else {
          add_chain(rows, node, col[f], f, depth);
        }
      }
      __syncwarp();
    }
    if (lane == 0) admitted[wi] = admit;
  }
}

// The flat scan of one launch: stage() lists each block's heads with
// their pairs (and, under a cap, their forest's counter), then every warp
// decides its own entries.
__device__ inline void flat_scan(const Flat& a, uint8_t* admitted,
                                 const RankCap& cap) {
  extern __shared__ int smem[];
  const KqCycle& c = a.c;
  const int ent = kFlatHead + 2 * c.rd;
  const int nw = blockDim.x >> 5;
  Stage st;
  const bool any = stage(
      a, 1, ent, st, [&](int wi) { admitted[wi] = 0; },
      [&](int* e, int h, int fid, bool) {
        for (int r = 0; r < c.rd; ++r) {
          const size_t o = static_cast<size_t>(h) * c.rd + r;
          e[kFlatHead + r] = c.dec_fr[o];
          e[kFlatHead + c.rd + r] = c.dec_amt[o];
        }
        int bits = (c.fit_mask[h] ? kFit : 0) | (c.res_mask[h] ? kRes : 0) |
                   (c.res_borrows[h] ? kResBorrows : 0);
        bool distinct = c.rd <= 32;
        for (int r = 1; r < c.rd && distinct; ++r) {
          const int fr = e[kFlatHead + r];
          for (int q = 0; q < r; ++q) {
            if (fr >= 0 && e[kFlatHead + q] == fr) distinct = false;
          }
        }
        if (distinct) bits |= kDistinct;
        if (cap.max_wl > 0) {
          const int raw = a.forest_of_node[c.wl_cq[h]];
          bits = (raw >= 0 && raw < cap.n_forests)
              ? bits | ((fid / static_cast<int>(gridDim.x) / nw)
                        << kRankShift)
              : kNoRank << kRankShift;   // no forest: never admitted
        }
        return bits;
      });
  if (!any) return;
  int* rank = nullptr;
  if (cap.max_wl > 0) {
    const int warp = threadIdx.x >> 5;
    rank = (cap.global != nullptr
                ? cap.global + static_cast<size_t>(blockIdx.x) * nw *
                                   cap.per_warp
                : smem + a.smem_ints) +
           static_cast<size_t>(warp) * cap.per_warp;
    for (int i = threadIdx.x & 31; i < cap.per_warp; i += 32) rank[i] = 0;
    __syncwarp();
  }
  auto decide = [&](const auto& rows) {
    const bool short_chains = a.t.depth <= 4;
    if (cap.max_wl > 0 && short_chains) {
      flat_decide<true, true>(a, rows, admitted, st.list, st.n_heads,
                              st.col, cap.max_wl, rank);
    } else if (cap.max_wl > 0) {
      flat_decide<true, false>(a, rows, admitted, st.list, st.n_heads,
                               st.col, cap.max_wl, rank);
    } else if (short_chains) {
      flat_decide<false, true>(a, rows, admitted, st.list, st.n_heads,
                               st.col, 0, nullptr);
    } else {
      flat_decide<false, false>(a, rows, admitted, st.list, st.n_heads,
                                st.col, 0, nullptr);
    }
  };
  if (st.shared) {
    decide(st.rows);
  } else {
    decide(GlobalRows{a.t.parent, a.gusage, a.t, a.t.F});
  }
}

// The flat scans' C entries: ptrs usage0, the 16 planes of admit_scan
// after it (subtree .. res_borrows), order, forest_of_node (or null),
// gmap, gusage, glist ([W, 3 + 2 rd]), gcount (or null), admitted, route,
// gcol (or null), then the global rank counters (or null); dims N, F, W,
// rd, rr, depth, blocks, threads, smem_bytes, then the cap's max_wl,
// n_forests, per_warp and its shared ints (0 when global or no cap).
template <class Kernel>
inline int flat_launch(Kernel kernel, void* const* ptrs, const int* dims,
                       int n_dims, cudaStream_t stream) {
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto B8 = [&](int i) { return static_cast<const uint8_t*>(ptrs[i]); };
  Flat a;
  a.t = KqTree{I(1), I(2), I(3), B8(4), I(5), dims[1], dims[5]};
  a.c = KqCycle{I(6), I(7), I(8), I(9), I(10), dims[3], B8(11),
                I(12), I(13), dims[4], B8(14), B8(15)};
  a.usage0 = I(0);
  a.order = I(16);
  a.forest_of_node = I(17);
  a.gmap = static_cast<int*>(ptrs[18]);
  a.gusage = static_cast<int*>(ptrs[19]);
  a.glist = static_cast<int*>(ptrs[20]);
  a.gcount = static_cast<int*>(ptrs[21]);
  uint8_t* admitted = static_cast<uint8_t*>(ptrs[22]);
  a.route = static_cast<int*>(ptrs[23]);
  a.gcol = static_cast<int*>(ptrs[24]);
  a.n_nodes = dims[0];
  a.W = dims[2];
  const int blocks = dims[6];
  const int threads = dims[7];
  const int smem_bytes = dims[8];
  RankCap cap{0, 0, 0, nullptr};
  int rank_ints = 0;
  if (n_dims > 9) {
    cap = RankCap{dims[9], dims[10], dims[11], static_cast<int*>(ptrs[25])};
    rank_ints = dims[12];
  }
  a.smem_ints = smem_bytes / static_cast<int>(sizeof(int)) - rank_ints;
  if (a.gcount != nullptr) {
    cudaMemsetAsync(a.gcount, 0, sizeof(int), stream);
  }
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kernel<<<blocks, threads, smem_bytes, stream>>>(a, admitted, cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace kq_flat
