// admit_scan: the flat admit loop of one cycle, cohort forests in
// parallel.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan (a jitted lax.scan over the
// cycle order).  Quota never flows between cohort forests, so the flat
// order only matters within a forest: the heads are grouped by forest
// (stably, in cycle order, no cap: every head is decided) and each
// forest's heads are decided by one warp.
//
// Layout: a forest is a tree of the parent plane, named by the caller's
// forest_of_node when given, else by its root (walked on the device).
// Forest f belongs to block f % gridDim.x and to its warp
// (f / gridDim.x) % warps.  A block counts its nodes and heads; when its
// working set fits in its dynamic shared memory (the shared-memory
// route) it stages its nodes there — usage, guaranteed, subtree (roots)
// or borrow cap (the others), the has-borrow-limit bits and each node's
// parent, by local index — and compacts its heads in cycle order into a
// list of (head, local node, warp | flags, the decision pairs); otherwise
// (the global route) its usage rows live in a global carry, its walks
// read the input planes, and its list lives in a global array at an
// offset taken from a counter the launch function zeroes.  Then each
// warp walks the list and decides its own entries: the head's pairs on
// the lanes, each lane's pair checked against available() walked up the
// chain (in shared memory on that route), a warp vote for the fit, the
// charge summed per column in shared memory and walked up the chain by
// the lanes that own the columns.  No block barrier per entry.
//
// Bound: latency.  Each forest's entries are sequential, each a chain of
// depth dependent shared-memory reads plus the head's pair loads; the
// forests run in parallel on the warps and blocks, after a prologue of a
// few passes over the nodes and heads.
#include <cuda_runtime.h>

#include "admit_entry.cuh"

namespace {

constexpr int kItems = 4;        // items per thread in a prologue pass
// head list entry: head, node, bits, then the head's rd decision pairs
// (columns, then amounts)
constexpr int kEntryHead = 3;
constexpr int kFit = 1, kRes = 2, kResBorrows = 4, kOwnerShift = 3;

struct FlatArgs {
  KqTree t;
  KqCycle c;
  const int* usage0;
  const int* order;
  const int* forest_of_node;   // [N] or null: forests named by roots
  int n_nodes, W, smem_ints;
  int* gmap;                   // [N] node → local index
  int* gusage;                 // [N, F] usage carry of the global route
  int* glist;                  // [W, 3 + 2 rd] lists of the global route
  int* gcount;                 // [1] zeroed per launch, or null
  uint8_t* admitted;
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

// Rows of the global route: the input planes and the global carry.
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

// One level of available(): node c over what its parent leaves, `avail`.
template <class Rows>
__device__ int flat_level(const Rows& r, int c, int f, int avail) {
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
__device__ int flat_available(const Rows& r, int node, int f, int depth) {
  int avail = 0;
  if (depth <= 4) {
    int up[4] = {node, -1, -1, -1};
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      up[i] = (i < depth && up[i - 1] >= 0) ? r.parent(up[i - 1]) : -1;
    }
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      if (up[i] >= 0) avail = flat_level(r, up[i], f, avail);
    }
    return avail;
  }
  kq_chain_top_down(r.par, node, depth,
                    [&](int c) { avail = flat_level(r, c, f, avail); });
  return avail;
}

// quota.cuh kq_add_usage_chain over either route's rows.
template <class Rows>
__device__ void flat_add_chain(const Rows& r, int node, int delta, int f,
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

// node[k] (-1: none) → its forest id: forest_of_node, or its root, the
// kItems walks advanced together so their loads overlap.
__device__ void flat_forests(const FlatArgs& a, int (&node)[kItems]) {
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

// Heads: the kItems consecutive order positions of this thread from
// `base` → head index, node (the CQ, or -1), forest id (or -1).
__device__ void flat_heads(const FlatArgs& a, int base, int (&wi)[kItems],
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
  flat_forests(a, fid);
}

// The warp's entries of the list, in order.
template <class Rows>
__device__ void flat_decide(const FlatArgs& a, const Rows& rows,
                            const int* list, int n, int* col) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int F = a.t.F;
  const KqCycle& c = a.c;
  const int ent = kEntryHead + 2 * c.rd;
  for (int j = 0; j < n; ++j) {
    const int* e = list + static_cast<size_t>(j) * ent;
    const int bits = e[2];
    if ((bits >> kOwnerShift) != warp) continue;
    const int wi = e[0];
    const int node = e[1];
    const int* pfr = e + kEntryHead;
    const int* pamt = pfr + c.rd;
    bool ok = true;
    if (bits & kFit) {
      for (int r = lane; r < c.rd; r += 32) {
        const int fr = pfr[r];
        if (fr >= 0 && fr < F &&
            pamt[r] > flat_available(rows, node, fr, a.t.depth)) {
          ok = false;
        }
      }
      ok = __all_sync(0xffffffffu, ok);
    }
    const bool admit = (bits & kFit) && ok;
    if (admit || (bits & kRes)) {
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
        if (col[f] != 0) flat_add_chain(rows, node, col[f], f, a.t.depth);
      }
      __syncwarp();
    }
    if (lane == 0) a.admitted[wi] = admit;
  }
}

__global__ void kq_admit_scan_kernel(FlatArgs a) {
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

  // 1. count this block's nodes and heads; block 0 clears the padding
  int nn = 0, nh = 0;
  for (int base = 0; base < N; base += chunk) {
    int fid[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int n = base + tid * kItems + k;
      fid[k] = n < N ? n : -1;
    }
    flat_forests(a, fid);
#pragma unroll
    for (int k = 0; k < kItems; ++k) nn += (fid[k] >= 0 && fid[k] % B == b);
  }
  for (int base = 0; base < a.W; base += chunk) {
    int wi[kItems], cq[kItems], fid[kItems];
    flat_heads(a, base, wi, cq, fid);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (wi[k] >= 0 && cq[k] < 0 && b == 0) a.admitted[wi[k]] = 0;
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
    return;
  }
  const int words = (F + 31) >> 5;
  const int ent = kEntryHead + 2 * a.c.rd;
  const int node_ints = n_nodes * (2 + words + 3 * F);
  const int col_ints = nw * F;
  const bool shared = node_ints + n_heads * ent + col_ints <= a.smem_ints;
  if (tid == 0) a.route[b] = shared ? 1 : 2;
  int* s_node = smem;
  int* s_par = s_node + n_nodes;
  unsigned* s_blim = reinterpret_cast<unsigned*>(s_par + n_nodes);
  int* s_u = s_par + n_nodes + n_nodes * words;
  int* s_g = s_u + n_nodes * F;
  int* s_cap = s_g + n_nodes * F;
  int* list = shared ? s_cap + n_nodes * F : nullptr;
  int* col = (shared ? list + n_heads * ent : smem) + warp * F;

  // 2. this block's nodes: local indices and rows (shared route), or
  // their usage rows in the global carry
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
    flat_forests(a, fid);
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
          a.gusage[o] = a.usage0[o];
        }
      }
    }
  }
  __syncthreads();
  if (shared) {
    for (int i = tid; i < n_nodes * F; i += blockDim.x) {
      const int n = s_node[i / F];
      const size_t o = static_cast<size_t>(n) * F + i % F;
      s_u[i] = a.usage0[o];
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

  // 3. this block's heads in cycle order: each thread's kItems
  // consecutive positions, placed by a block scan of the counts
  int count = 0;
  for (int base = 0; base < a.W; base += chunk) {
    int wi[kItems], cq[kItems], fid[kItems];
    flat_heads(a, base, wi, cq, fid);
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
             (a.c.fit_mask[h] ? kFit : 0) | (a.c.res_mask[h] ? kRes : 0) |
             (a.c.res_borrows[h] ? kResBorrows : 0);
      for (int r = 0; r < a.c.rd; ++r) {
        const size_t o = static_cast<size_t>(h) * a.c.rd + r;
        e[kEntryHead + r] = a.c.dec_fr[o];
        e[kEntryHead + a.c.rd + r] = a.c.dec_amt[o];
      }
    }
    count += total;
    __syncthreads();
  }

  // 4. each warp decides its forests' entries
  if (shared) {
    const SmemRows rows{s_par, s_u, s_g, s_cap, s_blim, F, words};
    flat_decide(a, rows, list, n_heads, col);
  } else {
    const GlobalRows rows{a.t.parent, a.gusage, a.t, F};
    flat_decide(a, rows, list, n_heads, col);
  }
}

}  // namespace

// ptrs: usage0, the 16 planes of admit_scan after it (subtree ..
// res_borrows), order, forest_of_node (or null), gmap, gusage, glist
// ([W, 3 + 2 rd]),
// gcount (or null), admitted, route; dims: N, F, W, rd, rr, depth,
// blocks, threads, smem_bytes.
extern "C" int kq_admit_scan(void* const* ptrs, const int* dims,
                             cudaStream_t stream) {
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto B8 = [&](int i) { return static_cast<const uint8_t*>(ptrs[i]); };
  FlatArgs a;
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
  a.admitted = static_cast<uint8_t*>(ptrs[22]);
  a.route = static_cast<int*>(ptrs[23]);
  a.n_nodes = dims[0];
  a.W = dims[2];
  const int blocks = dims[6];
  const int threads = dims[7];
  const int smem_bytes = dims[8];
  a.smem_ints = smem_bytes / static_cast<int>(sizeof(int));
  if (a.gcount != nullptr) {
    cudaMemsetAsync(a.gcount, 0, sizeof(int), stream);
  }
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_kernel<<<blocks, threads, smem_bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
