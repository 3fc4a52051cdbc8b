// drs_components: the two tensors of every node's DominantResourceShare.
//
// Replaces kueue_tpu/ops/fairsharing_kernel.py drs_components (:33; two
// one-hot int32 matmuls over [N, F] in JAX).  For node n and resource r:
//   borrowing[n, r] = the sum over r's columns f of
//                     max(0, usage + wl_req - subtree)[n, f];
//   lendable[n, r]  = the sum over the same columns of the parent's
//                     potential availability (available() on an all-zero
//                     usage plane, quota_kernel.available_all), 0 for a
//                     root.
//
// Lanes cover (node, column) pairs with a node's columns adjacent: for
// F <= 32 a warp holds `per` nodes (at most 32 / F; lane l on column l % F
// of node warp * per + l / F), for wider F a warp holds one node and takes
// its columns 32 at a time.  Each lane computes its column's two terms and
// adds them into its (node, resource)'s two cells of the warp's [per, R]
// sums in shared memory: atomicAdd on unsigned words wraps, and a
// wrapping add is associative and commutative, so any order gives XLA's
// int32 one-hot product bit for bit.  (__match_any_sync with
// __reduce_add_sync per group cost 3.9 us a block at F = 1, where every
// lane is its own group: the two serialise over distinct keys.)  The warp
// then writes its nodes' cells, each once (a resource with no column
// writes 0), adjacent in memory: no fill of the outputs and no [N, F]
// zero plane.
//
// The potential needs no usage plane: on zero usage the recurrence of
// quota_kernel.available_all is, top-down, subtree at a root and
// max(0, g) + (has_blim ? min(borrow_cap - max(0, -g), above) : above)
// below it (quota.cuh kq_potential_step).  The parent's chain runs in
// segments of S levels (the depth rounded up to 1, 2, 4, 8 or 16), each
// level's four cells loaded with its parent pointer.  The walk (depth <=
// 2, or N past KQ_DRS_STAGE_MAX): the lane reads its parent with its own
// cells, then one round trip a level, the level's cells riding along, so
// phase 9's call (every parent a root) costs two round trips and no
// barrier.  Staged (deeper chains): each block copies parent[] into
// shared memory by cp.async while the lanes load their own cells, the
// chain resolves there and every level's loads are in flight together:
// two round trips and a barrier whatever the depth.
//
// Bound: bytes.  The [N, F] planes read once and the two [N, R] outputs
// written once are ~15 KB at phase 9's 1,200 nodes (F = R = 1), a few ns
// at 3.35 TB/s; a launch is latency: the round trips, the adds and the
// stores.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "quota.cuh"

#define KQ_DRS_STAGE_MAX 12288   // parent[] staged: 4 N bytes

struct KqDrs {
  const int* usage;        // [N, F]
  const int* wl_req;       // [N, F] or null
  const int* subtree;      // [N, F]
  const int* guaranteed;   // [N, F]
  const int* borrow_cap;   // [N, F]
  const uint8_t* has_blim; // [N, F]
  const int* parent;       // [N]
  const int* fr_to_r;      // [F]
  int* borrowing;          // [N, R]
  int* lendable;           // [N, R]
  int N, F, R, depth;
  int per;                 // nodes a warp (F <= 32), else 1
};

// The parent p's potential availability in column f: its chain in
// segments of S levels, the top segment first.  Each level's four cells
// load with its parent pointer, so only the pointer reads are on the
// chain: from the staged parent[] (kStaged) they resolve in shared memory
// and every level's loads are in flight together; from global memory
// (the walk) a level costs one round trip that brings its cells along.
template <int S, bool kStaged>
__device__ __forceinline__ int kq_drs_potential(const KqDrs& k,
                                                const int* s_par, int p,
                                                int f) {
  auto up_of = [&](int n) {
    return kStaged ? s_par[n] : __ldg(k.parent + n);
  };
  int pot = 0;
  for (int lo = ((k.depth - 1) / S) * S; lo >= 0; lo -= S) {
    const int n_seg = min(k.depth - lo, S);
    int n = p;
    for (int j = 0; j < lo && n >= 0; ++j) n = up_of(n);
    int node[S], sub[S], g[S], bc[S];
    bool root[S];
    uint8_t hb[S];
#pragma unroll
    for (int i = 0; i < S; ++i) {
      if (i >= n_seg) break;
      node[i] = n;
      sub[i] = g[i] = bc[i] = 0;
      hb[i] = 0;
      root[i] = true;
      if (n >= 0) {
        const size_t o = static_cast<size_t>(n) * k.F + f;
        sub[i] = __ldg(k.subtree + o);
        g[i] = __ldg(k.guaranteed + o);
        bc[i] = __ldg(k.borrow_cap + o);
        hb[i] = __ldg(k.has_blim + o);
        n = up_of(n);
        root[i] = n < 0;
      }
    }
#pragma unroll
    for (int i = S - 1; i >= 0; --i) {
      if (i < n_seg && node[i] >= 0) {
        kq_potential_step(root[i], sub[i], g[i], bc[i], hb[i] != 0, pot);
      }
    }
  }
  return pot;
}

// S: the chain's segment length; kStaged: parent[] staged in shared
// memory (else read from global memory, the walk).  Shared memory: each
// warp's [2, per, R] sums, then (staged) parent[].
template <int S, bool kStaged>
__global__ void __launch_bounds__(256)
kq_drs_components_kernel(KqDrs k) {
  extern __shared__ int smem[];
  const int F = k.F, R = k.R, per = k.per;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * warps + (threadIdx.x >> 5);
  const int cells = per * R;
  unsigned* acc = reinterpret_cast<unsigned*>(smem) +
                  static_cast<size_t>(threadIdx.x >> 5) * 2 * cells;
  int* s_par = smem + static_cast<size_t>(warps) * 2 * cells;
  if constexpr (kStaged) {
    const int* par = k.parent;
    if (((reinterpret_cast<uintptr_t>(par) |
          reinterpret_cast<uintptr_t>(s_par)) & 15) == 0) {
      const int n4 = k.N >> 2;
      for (int j = threadIdx.x; j < n4; j += blockDim.x) {
        __pipeline_memcpy_async(s_par + 4 * j, par + 4 * j, 16);
      }
      for (int j = (n4 << 2) + threadIdx.x; j < k.N; j += blockDim.x) {
        __pipeline_memcpy_async(s_par + j, par + j, sizeof(int));
      }
    } else {
      for (int j = threadIdx.x; j < k.N; j += blockDim.x) {
        __pipeline_memcpy_async(s_par + j, par + j, sizeof(int));
      }
    }
    __pipeline_commit();
  }
  for (int j = lane; j < 2 * cells; j += 32) acc[j] = 0;
  const int n0 = warp * per;                 // the warp's first node
  const int chunks = F <= 32 ? 1 : (F + 31) >> 5;
  // chunk c's lane: its node, column and resource (-1: none, or out of
  // [0, R)), its parent (the walk reads it with the own cells) and the
  // borrowed term; the loads do not wait for the resource, so they are
  // one round trip
  int n = 0, f = 0, r = -1, p = -1;
  unsigned b = 0;
  auto own = [&](int c) {
    bool live;
    if (F <= 32) {
      const int q = F > 0 ? lane / F : 0;
      n = n0 + q;
      f = lane - q * F;
      live = lane < per * F && n < k.N;
    } else {
      n = n0;
      f = c * 32 + lane;
      live = f < F && n < k.N;
    }
    r = -1;
    b = 0;
    if (live) {
      const size_t o = static_cast<size_t>(n) * F + f;
      r = __ldg(k.fr_to_r + f);
      int u = __ldg(k.usage + o);
      if (k.wl_req != nullptr) u = kq_add(u, __ldg(k.wl_req + o));
      b = static_cast<unsigned>(max(0, kq_sub(u, __ldg(k.subtree + o))));
      if constexpr (!kStaged) p = __ldg(k.parent + n);
      if (r >= R) r = -1;
    }
  };
  own(0);                                    // while parent[] stages
  if constexpr (kStaged) {
    __pipeline_wait_prior(0);
    __syncthreads();
  } else {
    __syncwarp();
  }
  for (int c = 0; c < chunks; ++c) {
    if (c > 0) own(c);
    unsigned l = 0;
    if (r >= 0) {
      if constexpr (kStaged) p = s_par[n];
      if (p >= 0) {
        l = static_cast<unsigned>(kq_drs_potential<S, kStaged>(k, s_par, p,
                                                               f));
      }
    }
    // the (node, resource) sums: shared-memory adds on unsigned words
    // wrap, and in any order give XLA's int32 one-hot product bit for bit
    if (r >= 0) {
      const int key = (n - n0) * R + r;
      atomicAdd(acc + key, b);
      atomicAdd(acc + cells + key, l);
    }
    __syncwarp();
  }
  for (int j = lane; j < cells; j += 32) {
    const int node = n0 + j / R;
    if (node < k.N) {
      const size_t o = static_cast<size_t>(n0) * R + j;
      k.borrowing[o] = static_cast<int>(acc[j]);
      k.lendable[o] = static_cast<int>(acc[cells + j]);
    }
  }
}

template <int S, bool kStaged>
static int kq_drs_launch(const KqDrs& k, int warps, size_t smem,
                         cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kq_drs_components_kernel<S, kStaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long n_warps =
      k.F <= 32 ? (k.N + k.per - 1) / k.per : static_cast<long long>(k.N);
  const int blocks = static_cast<int>((n_warps + warps - 1) / warps);
  kq_drs_components_kernel<S, kStaged><<<blocks, warps * 32, smem,
                                         stream>>>(k);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged>
static int kq_drs_dispatch(const KqDrs& k, int S, int warps, size_t smem,
                           cudaStream_t stream) {
  switch (S) {
    case 1: return kq_drs_launch<1, kStaged>(k, warps, smem, stream);
    case 2: return kq_drs_launch<2, kStaged>(k, warps, smem, stream);
    case 4: return kq_drs_launch<4, kStaged>(k, warps, smem, stream);
    case 8: return kq_drs_launch<8, kStaged>(k, warps, smem, stream);
    case KQ_CHAIN_SEG:
      return kq_drs_launch<KQ_CHAIN_SEG, kStaged>(k, warps, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ptrs: usage, wl_req (or null), subtree, guaranteed, borrow_cap,
//       has_blim, parent, fr_to_r, borrowing [N, R], lendable [N, R];
// dims: N, F, R, depth, S (the chain's segment length: 1, 2, 4, 8 or
//       KQ_CHAIN_SEG), staged (parent[] in shared memory, N <=
//       KQ_DRS_STAGE_MAX; 0: the walk), per (nodes a warp), warps (a
//       block), shared bytes.
extern "C" int kq_drs_components(void* const* ptrs, const int* dims,
                                 cudaStream_t stream) {
  KqDrs k{static_cast<const int*>(ptrs[0]),
          static_cast<const int*>(ptrs[1]),
          static_cast<const int*>(ptrs[2]),
          static_cast<const int*>(ptrs[3]),
          static_cast<const int*>(ptrs[4]),
          static_cast<const uint8_t*>(ptrs[5]),
          static_cast<const int*>(ptrs[6]),
          static_cast<const int*>(ptrs[7]),
          static_cast<int*>(ptrs[8]),
          static_cast<int*>(ptrs[9]),
          dims[0], dims[1], dims[2], dims[3], dims[6]};
  const int S = dims[4], staged = dims[5], warps = dims[7];
  const size_t smem = static_cast<size_t>(dims[8]);
  if ((staged && k.N > KQ_DRS_STAGE_MAX) || warps < 1 || warps > 8 ||
      k.per < 1 || (k.F > 32 && k.per != 1) ||
      (k.F <= 32 && k.per * k.F > 32) || k.R < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return staged ? kq_drs_dispatch<true>(k, S, warps, smem, stream)
                : kq_drs_dispatch<false>(k, S, warps, smem, stream);
}
