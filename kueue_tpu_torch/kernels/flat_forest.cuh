// The forest-parallel layout shared by the flat admit_scan and
// admit_scan_preempt: cohort forests decided by warps, their rows staged
// per block.
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
// entry bits (entry word 2): decision kinds, then the owning warp
constexpr int kFit = 1, kRes = 2, kResBorrows = 4, kPre = 8;
constexpr int kOwnerShift = 4;

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

// One level of available(): node c over what its parent leaves, `avail`.
template <class Rows>
__device__ int level(const Rows& r, int c, int f, int avail) {
  const int u = r.u[static_cast<size_t>(c) * r.F + f];
  if (r.parent(c) < 0) return kq_sub(r.subtree(c, f), u);
  const int g = r.guaranteed(c, f);
  const int local = max(0, kq_sub(g, u));
  int pa = avail;
  if (r.has_blim(c, f)) {
    pa = min(kq_sub(r.borrow_cap(c, f), max(0, kq_sub(u, g))), avail);
  }
  return kq_add(local, pa);
}

// quota.cuh kq_available_at over either route's rows; chains of at most
// four levels are held in registers.
template <class Rows>
__device__ int available(const Rows& r, int node, int f, int depth) {
  int avail = 0;
  if (depth <= 4) {
    int up[4] = {node, -1, -1, -1};
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      up[i] = (i < depth && up[i - 1] >= 0) ? r.parent(up[i - 1]) : -1;
    }
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      if (up[i] >= 0) avail = level(r, up[i], f, avail);
    }
    return avail;
  }
  kq_chain_top_down(r.par, node, depth,
                    [&](int c) { avail = level(r, c, f, avail); });
  return avail;
}

// quota.cuh kq_add_usage_chain over either route's rows.
template <class Rows>
__device__ void add_chain(const Rows& r, int node, int delta, int f,
                          int depth) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < depth && cur >= 0; ++i) {
    int* u = r.u + static_cast<size_t>(cur) * r.F + f;
    const int local = max(0, kq_sub(r.guaranteed(cur, f), *u));
    *u = kq_add(*u, carry);
    carry = max(0, kq_sub(carry, local));
    cur = r.parent(cur);
  }
}

// quota.cuh kq_remove_usage_chain over either route's rows.
template <class Rows>
__device__ void remove_chain(const Rows& r, int node, int delta, int f,
                             int depth) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < depth && cur >= 0; ++i) {
    int* u = r.u + static_cast<size_t>(cur) * r.F + f;
    const int v = *u;
    const int stored_in_parent = kq_sub(v, r.guaranteed(cur, f));
    *u = kq_sub(v, carry);
    carry = stored_in_parent > 0 ? min(carry, stored_in_parent) : 0;
    cur = r.parent(cur);
  }
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

}  // namespace kq_flat
