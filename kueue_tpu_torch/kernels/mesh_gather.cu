// The two kernels of the per-cycle mesh around the per-shard admit scans.
//
// The JAX package runs the per-cycle admit scans and the fair-sharing
// tournament as GSPMD programs over a (wl, cq) mesh
// (kueue_tpu/parallel/sharded.py admit_scan_fns :90, fs_scan_fn :137,
// sharded_cycle_fn :71); GSPMD ends each with an all-gather of the
// per-head outputs.  The port partitions whole cohort forests over the
// cq axis instead, runs the existing scan kernel per shard on that
// shard's heads (kept in ascending global index), and puts the per-shard
// outputs back into head order here.
//
// kq_gather_heads: out[p][w] = blocks[p][l][r] where the source map
// says src[w] = l << KQ_SRC_SHIFT | r (head w is row r of live shard l's
// block), and the plane's fill where src[w] = -1: what the unsharded
// kernel gives a head that belongs to no shard (False, -1 or 0).  The
// host builds src while it routes the heads (CycleShardLayout.heads),
// so the gather runs in head order: thread w reads src[w] once and
// writes every plane at w, coalesced, across as many blocks as W needs.
// No fill pass, no barrier, no loop over shards.  One launch covers every
// output plane of a scan (admitted, preempting, overlap_skip;
// solve_cycle's six).  Planes are bool (1 byte) or int32 (4 bytes, a bit
// of ``wide``).  The argument table holds the P x L block pointers, the
// L block lengths, the P outputs and the P fills; its type is the
// smallest of 8, 16, ..., 256 slots that holds them, and it is read in
// place from the parameter space (__grid_constant__).  A slot or row
// outside the table gives the fill.
//
// kq_fs_merge_order: the global winner sequence of fs_admit_scan from
// the per-shard sequences.  Each round of the reference serves the cohort
// forest of the lowest-index remaining valid head, and forests are
// independent, so the global sequence is a merge: at each step the shard
// whose lowest remaining head has the smallest global index emits its
// next winner.  Shard s gives winners[s] (local ids into its ascending
// head list head_of[s], -1 past its last round) and head_of[s] (global
// ids, all valid).  One warp, one lane per shard: the lanes pick the
// smallest remaining head by a warp argmin, lane 0 emits the winner,
// marks it done and moves that shard's cursor past done heads.  Cursors
// live in shared memory, the done flags too (or in a global scratch when
// they pass 48 KB).  Rounds past the last winner write -1.
//
// Bound: bytes.  The gather reads src and each block once and writes [W]
// per plane, the merge reads each block and map once and writes [W]: far
// below a microsecond at 3.35 TB/s, so the launch and, for the merge, its
// W dependent rounds rule.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define KQ_MESH_MAX_SHARDS 32
#define KQ_MERGE_SMEM (48 * 1024)
#define KQ_SRC_SHIFT 26
#define KQ_GATHER_THREADS 128

// P x L block pointers (plane-major), L block lengths, P output
// pointers, P fills
template <int N>
struct GatherSlots {
  long long v[N];
};

struct MergeTable {
  const int* winners[KQ_MESH_MAX_SHARDS];
  const int* head_of[KQ_MESH_MAX_SHARDS];
  int n[KQ_MESH_MAX_SHARDS];
  int off[KQ_MESH_MAX_SHARDS + 1];
};

template <int N>
__global__ void kq_gather_heads_kernel(
    const __grid_constant__ GatherSlots<N> a, const int* src, int W, int P,
    int L, unsigned wide) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int s = src[w];
  const int l = s >= 0 ? s >> KQ_SRC_SHIFT : L;
  const int r = s & ((1 << KQ_SRC_SHIFT) - 1);
  const bool hit = l < L && r < a.v[P * L + l];
  for (int p = 0; p < P; ++p) {
    void* out = reinterpret_cast<void*>(a.v[P * L + L + p]);
    const long long fill = a.v[P * L + L + P + p];
    const void* blk = hit ? reinterpret_cast<const void*>(a.v[p * L + l])
                          : nullptr;
    if ((wide >> p) & 1u) {
      static_cast<int*>(out)[w] =
          hit ? static_cast<const int*>(blk)[r] : static_cast<int>(fill);
    } else {
      static_cast<uint8_t*>(out)[w] =
          hit ? static_cast<const uint8_t*>(blk)[r]
              : static_cast<uint8_t>(fill);
    }
  }
}

template <int N>
static int launch_gather(const long long* slots, int n_slots, const int* src,
                         int W, int P, int L, unsigned wide,
                         cudaStream_t stream) {
  GatherSlots<N> a;
  for (int i = 0; i < n_slots; ++i) a.v[i] = slots[i];
  kq_gather_heads_kernel<N>
      <<<(W + KQ_GATHER_THREADS - 1) / KQ_GATHER_THREADS, KQ_GATHER_THREADS,
         0, stream>>>(a, src, W, P, L, wide);
  return static_cast<int>(cudaGetLastError());
}

__global__ void kq_fs_merge_order_kernel(MergeTable t, int S, int W,
                                         uint8_t* done_global, int* order) {
  extern __shared__ uint8_t done_shared[];
  __shared__ int cur[KQ_MESH_MAX_SHARDS];
  __shared__ int wcur[KQ_MESH_MAX_SHARDS];
  uint8_t* done = done_global != nullptr ? done_global : done_shared;
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x;
  for (int i = lane; i < t.off[S]; i += 32) done[i] = 0;
  if (lane < S) {
    cur[lane] = 0;
    wcur[lane] = 0;
  }
  __syncwarp();
  int r = 0;
  while (r < W) {
    int id = INT_MAX;
    int best = -1;
    if (lane < S && cur[lane] < t.n[lane]) {
      id = t.head_of[lane][cur[lane]];
      best = lane;
    }
    for (int o = 16; o > 0; o >>= 1) {
      const int oid = __shfl_down_sync(full, id, o);
      const int ob = __shfl_down_sync(full, best, o);
      if (oid < id) {
        id = oid;
        best = ob;
      }
    }
    best = __shfl_sync(full, best, 0);
    if (best < 0) break;
    int emitted = 0;
    if (lane == 0) {
      const int n = t.n[best];
      const int k = wcur[best];
      const int loc = k < n ? t.winners[best][k] : -1;
      if (loc < 0 || loc >= n) {
        cur[best] = n;  // the shard's sequence ended: it serves no more
      } else {
        wcur[best] = k + 1;
        order[r] = t.head_of[best][loc];
        uint8_t* d = done + t.off[best];
        d[loc] = 1;
        int c = cur[best];
        while (c < n && d[c]) ++c;
        cur[best] = c;
        emitted = 1;
      }
    }
    r += __shfl_sync(full, emitted, 0);
    __syncwarp();
  }
  for (int i = r + lane; i < W; i += 32) order[i] = -1;
}

// slots: the table (P x L block pointers, L lengths, P outputs, P
// fills), n_slots = P * L + L + 2 * P of them; src [W] int32.
extern "C" int kq_gather_heads(const long long* slots, int n_slots,
                               const void* src, int W, int P, int L,
                               unsigned wide, cudaStream_t stream) {
  if (P < 1 || P > 32 || L < 1 || L > KQ_MESH_MAX_SHARDS || W < 1 ||
      n_slots != P * L + L + 2 * P) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* s = static_cast<const int*>(src);
#define KQ_GATHER_TABLE(N)                                              \
  if (n_slots <= N) {                                                   \
    return launch_gather<N>(slots, n_slots, s, W, P, L, wide, stream); \
  }
  KQ_GATHER_TABLE(8)
  KQ_GATHER_TABLE(16)
  KQ_GATHER_TABLE(32)
  KQ_GATHER_TABLE(64)
  KQ_GATHER_TABLE(128)
  KQ_GATHER_TABLE(256)
#undef KQ_GATHER_TABLE
  return static_cast<int>(cudaErrorInvalidValue);
}

// p: S winner pointers, then S head_of pointers, then the done scratch
// (null: in shared memory), then order [W]; d: S, W, then S lengths.
extern "C" int kq_fs_merge_order(void* const* p, const int* d,
                                 cudaStream_t stream) {
  const int S = d[0];
  const int W = d[1];
  if (S < 1 || S > KQ_MESH_MAX_SHARDS || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergeTable t;
  t.off[0] = 0;
  for (int s = 0; s < S; ++s) {
    t.winners[s] = static_cast<const int*>(p[s]);
    t.head_of[s] = static_cast<const int*>(p[S + s]);
    t.n[s] = d[2 + s];
    t.off[s + 1] = t.off[s] + t.n[s];
  }
  uint8_t* done_global = static_cast<uint8_t*>(p[2 * S]);
  const int smem = done_global != nullptr ? 0 : t.off[S];
  if (smem > KQ_MERGE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  kq_fs_merge_order_kernel<<<1, 32, smem, stream>>>(
      t, S, W, done_global, static_cast<int*>(p[2 * S + 1]));
  return static_cast<int>(cudaGetLastError());
}
