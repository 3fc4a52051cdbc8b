// minimal_preemptions_batch: every preemption search of a cycle in one
// launch, a warp per search.
//
// Replaces kueue_tpu/ops/preemption_kernel.py minimal_preemptions_batch
// (a vmap of two lax.scans; minimal_preemptions is the batch with S = 1).
// Warp w of block b runs search s = b * warps + w.  It stages the search
// in its own slice of shared memory, every row copied at once (cp.async)
// while it reads the search's scalars: the forest-local [NL, F] tree as
// flat_forest.cuh's SmemRows (parent, has-borrow-limit bits, the usage
// copy, guaranteed, the cap: subtree at roots, borrow cap below) plus the
// subtree rows the borrowing tests read, and the candidates' CQs, flags
// and delta rows, the removed candidates' bits after them.  A padding
// search (pre_cq < 0) then clears its outputs and stops.  Lanes own the
// columns f = lane, lane + 32, ...: a chain walk touches only its lane's
// columns, so the only cross-lane steps are the fit and borrowing votes
// (__all_sync / __any_sync), and no loop has a block barrier.  When a
// warp's tree does not fit its slice (the launcher decides from the
// shapes, no host sync) the walks read the input planes and carry the
// usage in a global [S, NL, F] scratch (GlobalRows); when its candidates
// do not fit, the loops read them from the inputs and keep the removed
// bits in a global [S, words] scratch.
//
// The forward loop runs up to the last real candidate and removes
// candidates in order (the dynamic borrowing skip, the borrowWithinCohort
// threshold flip) until the preemptor fits, and stops there; the reverse
// loop re-adds each removed candidate but the last, word by word of the
// removed bits from the top, and keeps it when the preemptor still fits,
// undoing the chain otherwise (the undo recomputes the overwritten cells,
// so no chain is kept).
//
// Bound: latency per search (up to K sequential steps of depth-long
// chain walks in shared memory); searches run in parallel on the warps.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include "flat_forest.cuh"

namespace {

using namespace kq_flat;

constexpr unsigned kFull = 0xffffffffu;
// candidate code word: the local CQ, other-CQ and above-threshold bits
// (-1: no candidate)
constexpr int kOther = 1 << 29, kAbove = 1 << 30, kCqMask = kOther - 1;

struct SearchArgs {
  const int* usage0;
  const int* subtree;
  const int* guaranteed;
  const int* borrow_cap;
  const uint8_t* has_blim;
  const int* parent;
  const int* pre_cq;
  const int* wl_usage;
  const uint8_t* frs_mask;
  const int* cand_cq;
  const int* cand_delta;
  const uint8_t* cand_other;
  const uint8_t* cand_above;
  const uint8_t* allow_borrowing0;
  const uint8_t* threshold_enabled;
  int S, NL, F, K, depth;
  int tree_ints;        // a warp's staged tree, or 0: the global route
  int cand_ints;        // its staged candidates and bits, or 0: global
  int* gusage;          // [S, NL, F] usage of the tree's global route
  unsigned* gbits;      // [S, words] removed bits of global candidates
  uint8_t* fitted;
  uint8_t* mask;
};

// A search's candidates, staged in its slice or its input rows: CQ,
// other-CQ and above-threshold flags [K], delta rows [K, F].
struct Cands {
  const int* cq;
  const uint8_t* other;
  const uint8_t* above;
  const int* delta;
  int F;
  // the code word of candidate k (see kOther)
  __device__ int code_at(int k) const {
    const int c = cq[k];
    return c < 0 ? -1 : c | (other[k] ? kOther : 0) | (above[k] ? kAbove : 0);
  }
  __device__ int delta_at(int k, int f) const {
    return delta[static_cast<size_t>(k) * F + f];
  }
};

// The n ints of src into the slice at dst, each lane's copies issued
// asynchronously (cp.async): the caller commits and waits.
__device__ __forceinline__ void async_row(int* dst, const int* src, int n) {
  for (int i = threadIdx.x & 31; i < n; i += 32) {
    __pipeline_memcpy_async(dst + i, src + i, sizeof(int));
  }
}

// The n bytes of src into the slice at dst as the aligned words that
// hold them, copied as async_row → the offset of src[0] in dst's bytes.
// The words' other bytes lie in the same aligned words as the row's own.
__device__ __forceinline__ int async_bytes(int* dst, const uint8_t* src,
                                           int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const int off = static_cast<int>(a & 3u);
  async_row(dst, reinterpret_cast<const int*>(a - off), (off + n + 3) >> 2);
  return off;
}

// dst[i] = src[i] for i < n in global memory (the global route's usage).
__device__ __forceinline__ void copy_row(int* dst, const int* src, int n) {
  for (int i = threadIdx.x & 31; i < n; i += 32) dst[i] = src[i];
}

// The staged tree: the rows, the subtree plane, and the has-borrow-limit
// bytes as copied, from which finish_tree sets the bits.
struct Tree {
  SmemRows rows;
  int* sub;
  const uint8_t* hb;
};

// Issue the copies of the tree's rows into the slice (see the file
// comment); the cap plane takes the borrow caps.
__device__ Tree issue_tree(const SearchArgs& p, int s, int* slice) {
  const int NL = p.NL, F = p.F;
  const int words = (F + 31) >> 5;
  const size_t plane = static_cast<size_t>(s) * NL * F;
  const int nf = NL * F;
  int* par = slice;
  unsigned* blim = reinterpret_cast<unsigned*>(par + NL);
  int* u = par + NL + NL * words;
  int* g = u + nf;
  int* cap = g + nf;
  int* sub = cap + nf;
  int* hb = sub + nf;
  async_row(par, p.parent + static_cast<size_t>(s) * NL, NL);
  async_row(u, p.usage0 + plane, nf);
  async_row(g, p.guaranteed + plane, nf);
  async_row(cap, p.borrow_cap + plane, nf);
  async_row(sub, p.subtree + plane, nf);
  const int off = async_bytes(hb, p.has_blim + plane, nf);
  return Tree{SmemRows{par, u, g, cap, blim, F, words}, sub,
              reinterpret_cast<const uint8_t*>(hb) + off};
}

// After the copies, a lane per node: a root's caps are its subtree row,
// and the has-borrow-limit bytes become bits.
__device__ void finish_tree(const Tree& t, int NL) {
  const int F = t.rows.F;
  int* cap = const_cast<int*>(t.rows.cap);
  unsigned* blim = const_cast<unsigned*>(t.rows.blim);
  for (int n = threadIdx.x & 31; n < NL; n += 32) {
    const bool root = t.rows.par[n] < 0;
    for (int w = 0; w < t.rows.words; ++w) {
      unsigned word = 0;
      for (int f = w * 32; f < min(F, w * 32 + 32); ++f) {
        if (root) cap[n * F + f] = t.sub[n * F + f];
        if (t.hb[n * F + f]) word |= 1u << (f & 31);
      }
      blim[n * t.rows.words + w] = word;
    }
  }
  __syncwarp();
}

// Issue the copies of the candidates into the slice: CQs, delta rows,
// the removed bits' words after them, then the two flag rows.
__device__ Cands issue_cands(const SearchArgs& p, int s, int* slice) {
  const int K = p.K, F = p.F;
  const size_t row = static_cast<size_t>(s) * K;
  int* cq = slice;
  int* delta = cq + K;
  int* other = delta + K * F + ((K + 31) >> 5);
  int* above = other + ((K + 3) >> 2) + 1;
  async_row(cq, p.cand_cq + row, K);
  async_row(delta, p.cand_delta + row * F, K * F);
  const int o = async_bytes(other, p.cand_other + row, K);
  const int a = async_bytes(above, p.cand_above + row, K);
  return Cands{cq, reinterpret_cast<const uint8_t*>(other) + o,
               reinterpret_cast<const uint8_t*>(above) + a, delta, F};
}

// The candidates up to the last real one.
__device__ int count_cands(const int* cq, int K) {
  int last = -1;
  for (int k = threadIdx.x & 31; k < K; k += 32) {
    if (cq[k] >= 0) last = k;
  }
  return __reduce_max_sync(kFull, last + 1);
}

// A search's scalars and this lane's first column of its request and
// of the columns needing preemption, loaded while the rows are copied.
struct Query {
  int pcq, wu0;
  bool need0, allow_b, thr;
};

__device__ Query load_query(const SearchArgs& p, int s) {
  const int lane = threadIdx.x & 31;
  const size_t o = static_cast<size_t>(s) * p.F + lane;
  return Query{p.pre_cq[s], lane < p.F ? p.wl_usage[o] : 0,
               lane < p.F && p.frs_mask[o] != 0, p.allow_borrowing0[s] != 0,
               p.threshold_enabled[s] != 0};
}

// One search on the warp (see the file comment): `rows` the tree (usage
// already copied), `sub` its subtree rows, `bits` the removed bits.
// kShort: chains of at most four levels, held in registers (chain4);
// kOne: F <= 32, a column per lane.
template <bool kShort, bool kOne, class Rows>
__device__ void search(const SearchArgs& p, int s, const Query& q,
                       const Rows& rows, const int* sub, const Cands& cands,
                       unsigned* bits, int n_k) {
  const int lane = threadIdx.x & 31;
  const int F = p.F, K = p.K, depth = p.depth;
  const int pcq = q.pcq;
  const int* wu = p.wl_usage + static_cast<size_t>(s) * F;
  const uint8_t* need = p.frs_mask + static_cast<size_t>(s) * F;
  uint8_t* mask = p.mask + static_cast<size_t>(s) * K;
  // body(f) for this lane's columns f = lane, lane + 32, ...
  auto columns = [&](auto body) {
    for (int f = lane; f < F; f += 32) {
      body(f);
      if constexpr (kOne) break;
    }
  };
  int up[4];
  if constexpr (kShort) chain4(rows, pcq, depth, up);
  // one column per lane: the preemptor chain's fixed cells in registers
  Fixed4 px{};
  int sub_p = 0;
  if constexpr (kShort && kOne) {
    if (lane < F) {
      px = fixed4(rows, up, lane);
      sub_p = sub[static_cast<size_t>(pcq) * F + lane];
    }
  }

  // workloadFits (preemption.go:552) at the preemptor's CQ
  auto fits = [&](bool allow_b) {
    bool ok = true, borrow = false;
    columns([&](int f) {
      const int w = f == lane ? q.wu0 : wu[f];
      if (w <= 0) return;
      int avail;
      if constexpr (kShort && kOne) {
        avail = available4(rows, up, px, f);
      } else if constexpr (kShort) {
        avail = available4(rows, up, f);
      } else {
        avail = available(rows, pcq, f, depth);
      }
      if (!(w <= avail)) ok = false;
      const int sub_f = kShort && kOne
          ? sub_p : sub[static_cast<size_t>(pcq) * F + f];
      if (kq_add(*rows.at(pcq, f), w) > sub_f) borrow = true;
    });
    ok = __all_sync(kFull, ok);
    borrow = __any_sync(kFull, borrow);
    return ok && (allow_b || !borrow);
  };
  // candidate k's usage walked up its CQ's chain by `step` (AddStep,
  // RemoveStep, UndoAddStep), this lane's columns
  auto walk = [&](auto step, int k, int cq) {
    using Step = decltype(step);
    int cu[4];
    if constexpr (kShort) chain4(rows, cq, depth, cu);
    columns([&](int f) {
      const int d = cands.delta_at(k, f);
      if (d == 0) return;
      if constexpr (kShort) {
        walk_chain4<Step>(rows, cu, d, f);
      } else {
        walk_chain<Step>(rows, cq, d, f, depth);
      }
    });
  };

  for (int w = lane; w < ((n_k + 31) >> 5); w += 32) bits[w] = 0;
  __syncwarp();
  bool allow_b = q.allow_b;
  bool fitted = false;
  int last = -1;
  for (int k = 0; k < n_k && !fitted; ++k) {
    const int code = cands.code_at(k);
    if (code < 0) continue;
    const int cq = code & kCqMask;
    if (code & kOther) {
      // dynamic skip: an other-CQ candidate counts only while its CQ is
      // borrowing in a resource needing preemption
      bool cb = false;
      columns([&](int f) {
        if ((f == lane ? q.need0 : need[f] != 0) &&
            *rows.at(cq, f) > sub[static_cast<size_t>(cq) * F + f]) {
          cb = true;
        }
      });
      if (!__any_sync(kFull, cb)) continue;
      if (q.thr && (code & kAbove)) allow_b = false;
    }
    walk(RemoveStep(), k, cq);
    if (lane == 0) bits[k >> 5] |= 1u << (k & 31);
    last = k;
    fitted = fits(allow_b);
  }
  __syncwarp();

  const int top = fitted ? last >> 5 : -1;
  for (int wd = top; wd >= 0; --wd) {
    const int b_last = wd == top ? (last & 31) : 32;
    unsigned word = bits[wd] & (b_last == 32 ? kFull : (1u << b_last) - 1u);
    unsigned keep = word;
    while (word != 0) {
      const int b = 31 - __clz(word);
      word &= ~(1u << b);
      const int k = wd * 32 + b;
      const int cq = cands.code_at(k) & kCqMask;
      walk(AddStep(), k, cq);
      if (fits(allow_b)) {
        keep &= ~(1u << b);   // filled back: not a target
      } else {
        walk(UndoAddStep(), k, cq);
      }
    }
    if (wd == top) keep |= 1u << (last & 31);
    const int k = wd * 32 + lane;
    if (k < K) mask[k] = (keep >> lane) & 1u;
  }
  for (int k = (top + 1) * 32 + lane; k < K; k += 32) mask[k] = 0;
  if (lane == 0) p.fitted[s] = fitted;
}

// search<kShort, kOne> for this launch's depth and F.
template <class Rows>
__device__ void search_for(const SearchArgs& p, int s, const Query& q,
                           const Rows& rows, const int* sub,
                           const Cands& cands, unsigned* bits, int n_k) {
  if (p.depth <= 4 && p.F <= 32) {
    search<true, true>(p, s, q, rows, sub, cands, bits, n_k);
  } else if (p.depth <= 4) {
    search<true, false>(p, s, q, rows, sub, cands, bits, n_k);
  } else if (p.F <= 32) {
    search<false, true>(p, s, q, rows, sub, cands, bits, n_k);
  } else {
    search<false, false>(p, s, q, rows, sub, cands, bits, n_k);
  }
}

__global__ void kq_minimal_preemptions_kernel(SearchArgs p) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = blockIdx.x * (blockDim.x >> 5) + warp;
  if (s >= p.S) return;
  // every row the warp stages is copied at once (cp.async) while the
  // search's scalars are read, then the flags and bits are set from the
  // copies in shared memory
  int* slice = smem + static_cast<size_t>(warp) * (p.tree_ints + p.cand_ints);
  const size_t plane = static_cast<size_t>(s) * p.NL * p.F;
  const size_t row = static_cast<size_t>(s) * p.K;
  Tree tree{};
  if (p.tree_ints > 0) {
    tree = issue_tree(p, s, slice);
  } else {
    copy_row(p.gusage + plane, p.usage0 + plane, p.NL * p.F);
  }
  const Cands cands = p.cand_ints > 0
      ? issue_cands(p, s, slice + p.tree_ints)
      : Cands{p.cand_cq + row, p.cand_other + row, p.cand_above + row,
              p.cand_delta + row * p.F, p.F};
  unsigned* bits = p.cand_ints > 0
      ? reinterpret_cast<unsigned*>(slice + p.tree_ints + p.K * (1 + p.F))
      : p.gbits + static_cast<size_t>(s) * ((p.K + 31) >> 5);
  __pipeline_commit();
  const Query q = load_query(p, s);
  if (q.pcq < 0) {   // a padding search
    uint8_t* mask = p.mask + row;
    for (int k = lane; k < p.K; k += 32) mask[k] = 0;
    if (lane == 0) p.fitted[s] = 0;
    __pipeline_wait_prior(0);
    return;
  }
  __pipeline_wait_prior(0);
  __syncwarp();
  const int n_k = count_cands(cands.cq, p.K);
  if (p.tree_ints > 0) {
    finish_tree(tree, p.NL);
    search_for(p, s, q, tree.rows, tree.sub, cands, bits, n_k);
  } else {
    const KqTree t{p.subtree + plane, p.guaranteed + plane,
                   p.borrow_cap + plane, p.has_blim + plane,
                   p.parent + static_cast<size_t>(s) * p.NL, p.F, p.depth};
    search_for(p, s, q, GlobalRows{t.parent, p.gusage + plane, t, p.F},
               t.subtree, cands, bits, n_k);
  }
}

}  // namespace

// ptrs: the 15 inputs (usage0 .. threshold_enabled), gusage (or null),
// gbits (or null), fitted, mask; dims: S, NL, F, K, depth, warps per
// block, tree_ints, cand_ints (per warp; 0: that part global).
extern "C" int kq_minimal_preemptions(void* const* ptrs, const int* dims,
                                      cudaStream_t stream) {
  auto I = [&](int i) { return static_cast<const int*>(ptrs[i]); };
  auto B8 = [&](int i) { return static_cast<const uint8_t*>(ptrs[i]); };
  SearchArgs p{I(0), I(1), I(2), I(3), B8(4), I(5), I(6), I(7), B8(8),
               I(9), I(10), B8(11), B8(12), B8(13), B8(14),
               dims[0], dims[1], dims[2], dims[3], dims[4], dims[6],
               dims[7], static_cast<int*>(ptrs[15]),
               static_cast<unsigned*>(ptrs[16]),
               static_cast<uint8_t*>(ptrs[17]),
               static_cast<uint8_t*>(ptrs[18])};
  const int warps = dims[5];
  const int blocks = (p.S + warps - 1) / warps;
  const int smem_bytes = static_cast<int>(
      warps * (p.tree_ints + p.cand_ints) * sizeof(int));
  if (smem_bytes > 48 * 1024) {
    cudaFuncSetAttribute(kq_minimal_preemptions_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  }
  kq_minimal_preemptions_kernel<<<blocks, warps * 32, smem_bytes, stream>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}
