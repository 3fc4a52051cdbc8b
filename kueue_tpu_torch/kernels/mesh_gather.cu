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
// ids, all valid).  Before its k-th emission shard s's lowest remaining
// local id is cur_s(k) = min(min(winners_s[k:len_s]), the least id the
// sequence never emits), where len_s ends at the first winner outside
// [0, W_s): a suffix minimum, so key_s(k) = head_of[s][cur_s(k)] does not
// decrease with k, and keys of different shards differ.  So the global
// order is a merge of S sorted key sequences by rank: emission (s, k)
// lands at k + the number of keys below key_s(k) in the other shards.
// One block: the block stages every shard's winners and heads (a head
// per thread), then a warp per shard finds len_s (a ballot), marks its
// emitted ids and finds the least one never emitted (a ballot), and
// writes the keys by a reverse running minimum over 32-wide tiles
// (shuffles); then each thread places its head's emission by binary
// searches in the other shards' keys.  The keys, winners, heads and
// marks (13 bytes a head) sit in shared memory, or in a global scratch
// past 48 KB.  Positions past W are dropped; the rest of order is -1.
// Dependent steps: W_s / 32 tiles per shard, then log W per search,
// where a merge round by round took W steps.
//
// Bound: bytes.  The gather reads src and each block once and writes [W]
// per plane, the merge reads each block and map once and writes [W]: far
// below a microsecond at 3.35 TB/s, so the launch and, for the merge,
// its tile walks and searches rule.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define KQ_MESH_MAX_SHARDS 32
#define KQ_MERGE_SMEM (48 * 1024)
#define KQ_SRC_SHIFT 26
#define KQ_GATHER_THREADS 128
#define KQ_MERGE_THREADS 1024

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

// The shard of flat index e: the last s with off[s] <= e.
__device__ __forceinline__ int merge_shard(const int* off, int S, int e) {
  int s = 0;
  while (s + 1 < S && off[s + 1] <= e) ++s;
  return s;
}

__global__ void kq_fs_merge_order_kernel(MergeTable t, int S, int W,
                                         int* scratch_global, int* order) {
  extern __shared__ int merge_smem[];
  __shared__ int s_len[KQ_MESH_MAX_SHARDS];
  __shared__ int s_off[KQ_MESH_MAX_SHARDS + 1];
  __shared__ const int* s_win[KQ_MESH_MAX_SHARDS];
  __shared__ const int* s_hd[KQ_MESH_MAX_SHARDS];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  if (threadIdx.x <= S) s_off[threadIdx.x] = t.off[threadIdx.x];
  if (threadIdx.x < S) {
    s_win[threadIdx.x] = t.winners[threadIdx.x];
    s_hd[threadIdx.x] = t.head_of[threadIdx.x];
  }
  __syncthreads();
  const int E = s_off[S];
  int* key = scratch_global != nullptr ? scratch_global : merge_smem;
  int* wins = key + E;
  int* heads = wins + E;
  uint8_t* seen = reinterpret_cast<uint8_t*>(heads + E);
  // 0. every shard's winners and heads staged, a head per thread
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int s = merge_shard(s_off, S, e);
    wins[e] = s_win[s][e - s_off[s]];
    heads[e] = s_hd[s][e - s_off[s]];
    seen[e] = 0;
  }
  __syncthreads();
  for (int s = warp; s < S; s += nw) {
    const int n = s_off[s + 1] - s_off[s];
    const int* win = wins + s_off[s];
    const int* hd = heads + s_off[s];
    uint8_t* sn = seen + s_off[s];
    int* ks = key + s_off[s];
    // 1. the valid prefix: up to the first winner outside [0, n)
    int len = n;
    for (int base = 0; base < n; base += 32) {
      const int k = base + lane;
      const int w = k < n ? win[k] : 0;
      const unsigned bad = __ballot_sync(full, k < n && (w < 0 || w >= n));
      if (bad) {
        len = base + __ffs(bad) - 1;
        break;
      }
    }
    // 2. the emitted ids marked; the least never emitted
    for (int k = lane; k < len; k += 32) sn[win[k]] = 1;
    __syncwarp();
    int never = n;
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      const unsigned un = __ballot_sync(full, i < n && !sn[i]);
      if (un) {
        never = base + __ffs(un) - 1;
        break;
      }
    }
    // 3. key[k] = head_of[min(min(winners[k:len]), never)], tiles from
    // the end, each an inclusive suffix minimum by shuffles
    int carry = never;
    for (int base = ((len - 1) >> 5) << 5; base >= 0; base -= 32) {
      const int k = base + lane;
      int v = k < len ? win[k] : INT_MAX;
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_down_sync(full, v, o);
        if (lane + o < 32) v = min(v, u);
      }
      v = min(v, carry);
      if (k < len) ks[k] = hd[v];
      carry = __shfl_sync(full, v, 0);
    }
    if (lane == 0) s_len[s] = len;
  }
  __syncthreads();
  // 4. each emission's position: its rank in its shard plus the keys
  // below its key in the other shards (a head per thread)
  int total = 0;
  for (int s = 0; s < S; ++s) total += s_len[s];
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int s = merge_shard(s_off, S, e);
    const int k = e - s_off[s];
    if (k >= s_len[s]) continue;
    const int kv = key[e];
    int pos = k;
    for (int q = 0; q < S; ++q) {
      if (q == s) continue;
      const int* kq = key + s_off[q];
      int lo = 0, hi = s_len[q];
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (kq[mid] < kv) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      pos += lo;
    }
    if (pos < W) order[pos] = heads[s_off[s] + wins[e]];
  }
  for (int i = total + threadIdx.x; i < W; i += blockDim.x) order[i] = -1;
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

// p: S winner pointers, then S head_of pointers, then the scratch of
// the keys, winners, heads and marks (null: in shared memory; else 13 E
// bytes for E heads in all), then order [W]; d: S, W, then S lengths.
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
  int* scratch = static_cast<int*>(p[2 * S]);
  const int smem = scratch != nullptr ? 0 : 13 * t.off[S];
  if (smem > KQ_MERGE_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  kq_fs_merge_order_kernel<<<1, KQ_MERGE_THREADS, smem, stream>>>(
      t, S, W, scratch, static_cast<int*>(p[2 * S + 1]));
  return static_cast<int>(cudaGetLastError());
}
