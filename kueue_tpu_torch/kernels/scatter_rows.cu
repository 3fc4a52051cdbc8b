// The two kernels of the forest-sharded fused burst around burst_cycles.
//
// kq_scatter_rows replaces kueue_tpu/ops/burst.py
// BurstSolver._scatter_rows_fn (:2309-2317): one jitted
// ``a.at[rows].set(v)`` over the 13 SCATTER_PLANES of a shard-resident
// burst plan.  A fresh delta pack changes only its dirty CQs' rows, so
// only those rows cross the host boundary and are written into the
// resident planes, all planes in one launch.  The host packs the rows and
// every plane's value rows into one byte buffer (ops/packing.py
// pack_scatter_rows: rows int32 [Dp] at 0, then plane p's Dp value rows at
// a 16-byte boundary), uploaded by one copy; the launch takes a table of
// plane pointers, segment offsets and row bytes (the planes have
// different row widths and types: int32 [Cs, M, R], bool [Cs, M], ...).
// A warp copies row i of plane p, eight warps a block, loading the row
// index and the values together (one round trip): 16-byte vectors where
// the plane and its row bytes are 16-byte aligned, else 4-byte words
// where both are 4-byte aligned, else bytes (a bool plane of M-byte rows
// with M odd, strict_cq's single byte).  Padded rows repeat the last row with its own value
// (packing.scatter_pad), so two warps that write the same row write the
// same bytes and their order does not matter.  A row r in [-n_rows, 0)
// writes row n_rows + r, and a row below -n_rows or at n_rows and past
// it is dropped (NumPy indexing, which jnp's .at[].set follows).  The
// write is in place: the resident planes are updated, not copied.
//
// kq_reduce_dflags replaces the psum at kueue_tpu/ops/burst.py:789-790
// under parallel/sharded.py sharded_burst_fn: shard s's burst_cycles
// launch leaves its [K, 4] int32 dirty flags in row s of one window
// buffer [S, K, 4] (written there directly on a virtual mesh, by one peer
// copy on a real one), and the window's flags are the sum over s.  One
// thread per cycle row k reads the S rows' 16-byte int4 at k and adds
// them as unsigned (wrapping, as XLA's psum wraps); at K = 32 that is one
// warp.  The arguments are one pointer, S and K: no pointer table.
//
// Bound: bytes.  The scatter moves 2 x the distinct rows x the summed row
// bytes (values read once, rows written once) and the reduction (S + 1) x
// K x 16 bytes; both are far below a microsecond at 3.35 TB/s, so the
// launch rules: a warp a (row, plane) pair fills blocks of eight busy
// warps where a block a pair left most of its 128 threads idle.
#include <cuda_runtime.h>

#include <cstdint>

#define KQ_SCATTER_MAX_PLANES 16
#define KQ_SCATTER_WARPS 8

struct ScatterTable {
  void* planes[KQ_SCATTER_MAX_PLANES];
  int offset[KQ_SCATTER_MAX_PLANES];     // plane p's segment in the buffer
  int row_bytes[KQ_SCATTER_MAX_PLANES];
};

__global__ void __launch_bounds__(KQ_SCATTER_WARPS * 32)
kq_scatter_rows_kernel(ScatterTable tab, const char* buf, int P, int Dp,
                       int n_rows) {
  const int pair = blockIdx.x * KQ_SCATTER_WARPS + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (pair >= Dp * P) return;
  const int i = pair / P;
  const int p = pair - i * P;
  // where the values go depends on the row, what they are does not: the
  // row and the values load together, a row out of range stores nothing
  const int r = reinterpret_cast<const int*>(buf)[i];
  const int rb = tab.row_bytes[p];
  char* base = static_cast<char*>(tab.planes[p]);
  const char* src = buf + tab.offset[p] + static_cast<size_t>(i) * rb;
  const bool keep = r >= -n_rows && r < n_rows;
  const int row = r < 0 ? r + n_rows : r;
  char* dst = base + static_cast<size_t>(keep ? row : 0) * rb;
  // a plane's rows and their segment rows (segments 16-byte aligned) all
  // share the alignment of (base | rb)
  const unsigned mis = static_cast<unsigned>(
      reinterpret_cast<uintptr_t>(base) | static_cast<uintptr_t>(rb));
  if ((mis & 15) == 0) {
    for (int k = lane; k < (rb >> 4); k += 32) {
      const int4 v = reinterpret_cast<const int4*>(src)[k];
      if (keep) reinterpret_cast<int4*>(dst)[k] = v;
    }
  } else if ((mis & 3) == 0) {
    for (int k = lane; k < (rb >> 2); k += 32) {
      const int v = reinterpret_cast<const int*>(src)[k];
      if (keep) reinterpret_cast<int*>(dst)[k] = v;
    }
  } else {
    for (int k = lane; k < rb; k += 32) {
      const char v = src[k];
      if (keep) dst[k] = v;
    }
  }
}

__global__ void kq_reduce_dflags_kernel(const int4* window, int S, int K,
                                        int4* out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  unsigned x = 0, y = 0, z = 0, w = 0;
  for (int s = 0; s < S; ++s) {
    const int4 v = window[static_cast<size_t>(s) * K + k];
    x += static_cast<unsigned>(v.x);
    y += static_cast<unsigned>(v.y);
    z += static_cast<unsigned>(v.z);
    w += static_cast<unsigned>(v.w);
  }
  out[k] = make_int4(static_cast<int>(x), static_cast<int>(y),
                     static_cast<int>(z), static_cast<int>(w));
}

// p: P plane pointers, then the packed buffer (16-byte aligned); d: P,
// Dp, n_rows, then P segment offsets, then P row byte counts.
extern "C" int kq_scatter_rows(void* const* p, const int* d,
                               cudaStream_t stream) {
  const int P = d[0];
  const int Dp = d[1];
  if (P < 1 || P > KQ_SCATTER_MAX_PLANES || Dp < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ScatterTable tab;
  for (int k = 0; k < P; ++k) {
    tab.planes[k] = p[k];
    tab.offset[k] = d[3 + k];
    tab.row_bytes[k] = d[3 + P + k];
  }
  const long long pairs = static_cast<long long>(Dp) * P;
  const int blocks =
      static_cast<int>((pairs + KQ_SCATTER_WARPS - 1) / KQ_SCATTER_WARPS);
  kq_scatter_rows_kernel<<<blocks, KQ_SCATTER_WARPS * 32, 0, stream>>>(
      tab, static_cast<const char*>(p[P]), P, Dp, d[2]);
  return static_cast<int>(cudaGetLastError());
}

// window [S, K, 4] and out [K, 4] int32, both 16-byte aligned.
extern "C" int kq_reduce_dflags(const void* window, void* out, int S, int K,
                                cudaStream_t stream) {
  if (S < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  kq_reduce_dflags_kernel<<<(K + 31) / 32, 32, 0, stream>>>(
      static_cast<const int4*>(window), S, K, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
