// admit_scan: the flat admit loop of one cycle, cohort forests in
// parallel.
//
// Replaces kueue_tpu/ops/cycle.py admit_scan (a jitted lax.scan over the
// cycle order).  Quota never flows between cohort forests, so the flat
// order only matters within a forest: the heads are grouped by forest
// (stably, in cycle order, no cap: every head is decided) and each
// forest's heads are decided by one warp.
//
// Layout (flat_forest.cuh, shared with admit_scan_preempt): forests are
// dealt to blocks and warps; a block stages its nodes' rows (one usage
// plane) in shared memory or keeps them in a global carry, and lists its
// heads in cycle order as (head, node, warp | flags, the decision
// pairs).  Then each warp walks the list and decides its own entries:
// the head's pairs on the lanes, each lane's pair checked against
// available() walked up the chain (in shared memory on that route), a
// warp vote for the fit, the charge summed per column in the warp's
// column row and walked up the chain by the lanes that own the columns.
// No block barrier per entry.
//
// Bound: latency.  Each forest's entries are sequential, each a chain of
// depth dependent shared-memory reads plus the head's pair loads; the
// forests run in parallel on the warps and blocks, after a prologue of a
// few passes over the nodes and heads.
#include <cuda_runtime.h>

#include "flat_forest.cuh"

namespace {

using namespace kq_flat;

// head list entry: head, node, bits, then the head's rd decision pairs
// (columns, then amounts)
constexpr int kEntryHead = 3;

// The warp's entries of the list, in order.
template <class Rows>
__device__ void flat_decide(const Flat& a, const Rows& rows,
                            uint8_t* admitted, const int* list, int n,
                            int* col) {
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
            pamt[r] > available(rows, node, fr, a.t.depth)) {
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
        if (col[f] != 0) add_chain(rows, node, col[f], f, a.t.depth);
      }
      __syncwarp();
    }
    if (lane == 0) admitted[wi] = admit;
  }
}

__global__ void kq_admit_scan_kernel(Flat a, uint8_t* admitted) {
  const KqCycle& c = a.c;
  const int ent = kEntryHead + 2 * c.rd;
  Stage st;
  const bool any = stage(
      a, 1, ent, st, [&](int wi) { admitted[wi] = 0; },
      [&](int* e, int h, int, bool) {
        for (int r = 0; r < c.rd; ++r) {
          const size_t o = static_cast<size_t>(h) * c.rd + r;
          e[kEntryHead + r] = c.dec_fr[o];
          e[kEntryHead + c.rd + r] = c.dec_amt[o];
        }
        return (c.fit_mask[h] ? kFit : 0) | (c.res_mask[h] ? kRes : 0) |
               (c.res_borrows[h] ? kResBorrows : 0);
      });
  if (!any) return;

  // 4. each warp decides its forests' entries
  if (st.shared) {
    flat_decide(a, st.rows, admitted, st.list, st.n_heads, st.col);
  } else {
    const GlobalRows rows{a.t.parent, a.gusage, a.t, a.t.F};
    flat_decide(a, rows, admitted, st.list, st.n_heads, st.col);
  }
}

}  // namespace

// ptrs: usage0, the 16 planes of admit_scan after it (subtree ..
// res_borrows), order, forest_of_node (or null), gmap, gusage, glist
// ([W, 3 + 2 rd]), gcount (or null), admitted, route, gcol (or null);
// dims: N, F, W, rd, rr, depth, blocks, threads, smem_bytes.
extern "C" int kq_admit_scan(void* const* ptrs, const int* dims,
                             cudaStream_t stream) {
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
  a.smem_ints = smem_bytes / static_cast<int>(sizeof(int));
  if (a.gcount != nullptr) {
    cudaMemsetAsync(a.gcount, 0, sizeof(int), stream);
  }
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_admit_scan_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_admit_scan_kernel<<<blocks, threads, smem_bytes, stream>>>(a, admitted);
  return static_cast<int>(cudaGetLastError());
}
