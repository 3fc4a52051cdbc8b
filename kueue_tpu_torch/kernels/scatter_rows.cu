// The two kernels of the forest-sharded fused burst around burst_cycles.
//
// kq_scatter_rows replaces kueue_tpu/ops/burst.py
// BurstSolver._scatter_rows_fn (:2309-2317): one jitted
// ``a.at[rows].set(v)`` over the 13 SCATTER_PLANES of a shard-resident
// burst plan.  A fresh delta pack changes only its dirty CQs' rows, so
// only those rows cross the host boundary and are written into the
// resident planes, all planes in one launch.  The planes have different
// row widths and types (int32 [Cs, M, R], bool [Cs, M], ...), so the
// launch takes a table of plane pointers, value pointers and row bytes;
// block (i, p) copies row i of plane p.  Padded rows repeat the last row
// with its own value (packing.scatter_pad), so two blocks that write the
// same row write the same bytes and their order does not matter.  A row
// outside [0, n_rows) is dropped.  The write is in place: the resident
// planes are updated, not copied.
//
// kq_reduce_dflags replaces the psum at kueue_tpu/ops/burst.py:789-790
// under parallel/sharded.py sharded_burst_fn: each shard's burst_cycles
// launch leaves a [K, 4] int32 block of dirty flags, and the window's
// flags are their sum.  A thread per (cycle, flag) sums the S blocks
// (wrapping int32, as XLA's psum wraps).
//
// Bound: bytes.  The scatter moves 2 x Dp x the summed row bytes (values
// read once, rows written once) and the reduction S x K x 16 bytes; both
// are far below a microsecond at 3.35 TB/s, so launch latency rules.
#include <cuda_runtime.h>

#include <cstdint>

#define KQ_SCATTER_MAX_PLANES 16
#define KQ_REDUCE_MAX_SHARDS 256

struct ReduceTable {
  const int* blocks[KQ_REDUCE_MAX_SHARDS];
};

struct ScatterTable {
  void* planes[KQ_SCATTER_MAX_PLANES];
  const void* vals[KQ_SCATTER_MAX_PLANES];
  int row_bytes[KQ_SCATTER_MAX_PLANES];
};

__global__ void kq_scatter_rows_kernel(ScatterTable tab, const int* rows,
                                       int n_rows) {
  const int i = blockIdx.x;
  const int p = blockIdx.y;
  const int r = rows[i];
  if (r < 0 || r >= n_rows) return;
  const int rb = tab.row_bytes[p];
  if (rb % 4 == 0) {
    int* dst = reinterpret_cast<int*>(
        static_cast<char*>(tab.planes[p]) + static_cast<size_t>(r) * rb);
    const int* src = reinterpret_cast<const int*>(
        static_cast<const char*>(tab.vals[p]) + static_cast<size_t>(i) * rb);
    for (int w = threadIdx.x; w < rb / 4; w += blockDim.x) dst[w] = src[w];
  } else {
    char* dst = static_cast<char*>(tab.planes[p]) + static_cast<size_t>(r) * rb;
    const char* src =
        static_cast<const char*>(tab.vals[p]) + static_cast<size_t>(i) * rb;
    for (int b = threadIdx.x; b < rb; b += blockDim.x) dst[b] = src[b];
  }
}

__global__ void kq_reduce_dflags_kernel(ReduceTable tab, int S, int n,
                                        int* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  unsigned s = 0;
  for (int b = 0; b < S; ++b) s += static_cast<unsigned>(tab.blocks[b][i]);
  out[i] = static_cast<int>(s);
}

// p: P plane pointers, then P value pointers, then rows; d: P, Dp,
// n_rows, then P row byte counts.
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
    tab.vals[k] = p[P + k];
    tab.row_bytes[k] = d[3 + k];
  }
  const int* rows = static_cast<const int*>(p[2 * P]);
  kq_scatter_rows_kernel<<<dim3(Dp, P), 128, 0, stream>>>(tab, rows, d[2]);
  return static_cast<int>(cudaGetLastError());
}

// p: S block pointers ([K, 4] each, on this device), then out [K, 4];
// d: S, K * 4.
extern "C" int kq_reduce_dflags(void* const* p, const int* d,
                                cudaStream_t stream) {
  const int S = d[0];
  const int n = d[1];
  if (S < 1 || S > KQ_REDUCE_MAX_SHARDS || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ReduceTable tab;
  for (int b = 0; b < S; ++b) tab.blocks[b] = static_cast<const int*>(p[b]);
  kq_reduce_dflags_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      tab, S, n, static_cast<int*>(p[S]));
  return static_cast<int>(cudaGetLastError());
}
