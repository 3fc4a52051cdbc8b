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
// under parallel/sharded.py sharded_burst_fn: shard s's burst_cycles
// launch leaves its [K, 4] int32 dirty flags in row s of one window
// buffer [S, K, 4] (written there directly on a virtual mesh, by one peer
// copy on a real one), and the window's flags are the sum over s.  One
// thread per cycle row k reads the S rows' 16-byte int4 at k and adds
// them as unsigned (wrapping, as XLA's psum wraps); at K = 32 that is one
// warp.  The arguments are one pointer, S and K: no pointer table.
//
// Bound: bytes.  The scatter moves 2 x Dp x the summed row bytes (values
// read once, rows written once) and the reduction (S + 1) x K x 16 bytes;
// both are far below a microsecond at 3.35 TB/s, so the launch rules.
#include <cuda_runtime.h>

#include <cstdint>

#define KQ_SCATTER_MAX_PLANES 16

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

// window [S, K, 4] and out [K, 4] int32, both 16-byte aligned.
extern "C" int kq_reduce_dflags(const void* window, void* out, int S, int K,
                                cudaStream_t stream) {
  if (S < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  kq_reduce_dflags_kernel<<<(K + 31) / 32, 32, 0, stream>>>(
      static_cast<const int4*>(window), S, K, static_cast<int4*>(out));
  return static_cast<int>(cudaGetLastError());
}
