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
// kq_gather_heads: out[p][head_of[s][i]] = blocks[p][s][i] for every
// plane p, shard s and local head i; rows of heads that belong to no
// shard keep the plane's fill value (what the unsharded kernel gives such
// a head: False, -1 or 0).  One launch covers every output plane of a
// scan (admitted, preempting, overlap_skip; solve_cycle's six), one
// block per plane: the block writes the fill over its [W] row, waits at
// a barrier, then scatters the S blocks.  Planes are bool (1 byte) or
// int32 (4 bytes).  A head index outside [0, W) is dropped.
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
// Bound: bytes.  Both read each block and map once and write [W] per
// plane: far below a microsecond at 3.35 TB/s, so launch latency and, for
// the merge, its W dependent rounds rule.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define KQ_GATHER_MAX_PLANES 6
#define KQ_MESH_MAX_SHARDS 32
#define KQ_MERGE_SMEM (48 * 1024)

struct GatherTable {
  const void* blocks[KQ_GATHER_MAX_PLANES][KQ_MESH_MAX_SHARDS];
  const int* head_of[KQ_MESH_MAX_SHARDS];
  int n[KQ_MESH_MAX_SHARDS];
  void* out[KQ_GATHER_MAX_PLANES];
  int elem[KQ_GATHER_MAX_PLANES];
  int fill[KQ_GATHER_MAX_PLANES];
};

struct MergeTable {
  const int* winners[KQ_MESH_MAX_SHARDS];
  const int* head_of[KQ_MESH_MAX_SHARDS];
  int n[KQ_MESH_MAX_SHARDS];
  int off[KQ_MESH_MAX_SHARDS + 1];
};

__global__ void kq_gather_heads_kernel(GatherTable t, int S, int W) {
  const int p = blockIdx.x;
  const bool wide = t.elem[p] == 4;
  int* out32 = static_cast<int*>(t.out[p]);
  uint8_t* out8 = static_cast<uint8_t*>(t.out[p]);
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    if (wide) {
      out32[w] = t.fill[p];
    } else {
      out8[w] = static_cast<uint8_t>(t.fill[p]);
    }
  }
  __syncthreads();
  for (int s = 0; s < S; ++s) {
    const int* h = t.head_of[s];
    const int n = t.n[s];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int w = h[i];
      if (w < 0 || w >= W) continue;
      if (wide) {
        out32[w] = static_cast<const int*>(t.blocks[p][s])[i];
      } else {
        out8[w] = static_cast<const uint8_t*>(t.blocks[p][s])[i];
      }
    }
  }
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

// p: P x S block pointers (plane-major), then S head_of pointers, then P
// output pointers; d: P, S, W, then S block lengths, then P element
// sizes, then P fills.
extern "C" int kq_gather_heads(void* const* p, const int* d,
                               cudaStream_t stream) {
  const int P = d[0];
  const int S = d[1];
  const int W = d[2];
  if (P < 1 || P > KQ_GATHER_MAX_PLANES || S < 0 || S > KQ_MESH_MAX_SHARDS ||
      W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherTable t;
  for (int k = 0; k < P; ++k) {
    for (int s = 0; s < S; ++s) t.blocks[k][s] = p[k * S + s];
    t.out[k] = p[P * S + S + k];
    t.elem[k] = d[3 + S + k];
    t.fill[k] = d[3 + S + P + k];
    if (t.elem[k] != 1 && t.elem[k] != 4) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  for (int s = 0; s < S; ++s) {
    t.head_of[s] = static_cast<const int*>(p[P * S + s]);
    t.n[s] = d[3 + s];
  }
  kq_gather_heads_kernel<<<P, 256, 0, stream>>>(t, S, W);
  return static_cast<int>(cudaGetLastError());
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
