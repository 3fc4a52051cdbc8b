// drs_components: the two tensors of every node's DominantResourceShare.
//
// Replaces kueue_tpu/ops/fairsharing_kernel.py drs_components (two
// one-hot int32 matmuls over [N, F] in JAX).  One thread per (node,
// resource): it sums, over the flavor-resource columns of its resource,
// the usage borrowed above subtree quota (usage + wl_req - subtree,
// floored at 0) and, for a node with a parent, the parent's potential
// availability (kq_available_at over an all-zero usage plane: the
// parent's ancestor chain, walked per column).
//
// Bound: bytes.  Each thread reads its node's row and its parent's chain
// once; at N x R threads the launch is a few waves of independent
// threads, so the floor is the [N, F] planes read once plus the two
// [N, R] outputs; the chain walks add depth dependent reads per column.
#include <cuda_runtime.h>

#include "quota.cuh"

__global__ void kq_drs_components_kernel(KqTree t, const int* usage,
                                         const int* wl_req, const int* zeros,
                                         const int* fr_to_r, int N, int R,
                                         int* borrowing, int* lendable) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= N * R) return;
  const int n = idx / R;
  const int r = idx % R;
  const int p = t.parent[n];
  int b = 0;
  int lend = 0;
  for (int f = 0; f < t.F; ++f) {
    if (fr_to_r[f] != r) continue;
    const size_t o = static_cast<size_t>(n) * t.F + f;
    int u = usage[o];
    if (wl_req != nullptr) u = kq_add(u, wl_req[o]);
    b = kq_add(b, max(0, kq_sub(u, t.subtree[o])));
    if (p >= 0) lend = kq_add(lend, kq_available_at(t, zeros, p, f));
  }
  borrowing[idx] = b;
  lendable[idx] = lend;
}

extern "C" int kq_drs_components(
    const int* usage, const int* subtree, const int* guaranteed,
    const int* borrow_cap, const uint8_t* has_blim, const int* parent,
    const int* fr_to_r, const int* wl_req, const int* zeros, int* borrowing,
    int* lendable, int N, int F, int R, int depth, cudaStream_t stream) {
  KqTree t{subtree, guaranteed, borrow_cap, has_blim, parent, F, depth};
  const int threads = 128;
  const int blocks = (N * R + threads - 1) / threads;
  kq_drs_components_kernel<<<blocks, threads, 0, stream>>>(
      t, usage, wl_req, zeros, fr_to_r, N, R, borrowing, lendable);
  return static_cast<int>(cudaGetLastError());
}
