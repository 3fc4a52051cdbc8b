// Hierarchical quota recurrences as per-column device helpers.
//
// Replaces the JAX recurrence kueue_tpu/ops/quota_kernel.py
// available_at; the usage walks (add_usage_chain and the two
// remove_usage_chain copies, kueue_tpu/ops/cycle.py _remove_usage_chain
// and ops/preemption_kernel.py remove_usage_chain) are flat_forest.cuh's
// AddStep / RemoveStep / UndoAddStep.  Every recurrence is independent per
// flavor-resource column f, so the kernels give each thread of a block the
// columns f = tid, tid + blockDim.x, ... (any F): a thread walks the
// ancestor chain of a node for its own columns only, and no two threads
// ever touch the same usage cell.  Cross-column decisions (a fit over all
// pairs) are block reductions in the kernels.
//
// Arithmetic: XLA's int32 adds and subtracts wrap; signed overflow is
// undefined in C++, so every add and subtract goes through unsigned.
//
// Chains of any depth: no walk needs its whole chain in a fixed array.
// The top-down available() holds the chain in register segments of
// KQ_CHAIN_SEG levels (kq_chain_top_down).
#pragma once

#include <cstdint>

__device__ __forceinline__ int kq_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

__device__ __forceinline__ int kq_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

// Wrapping int32 product (XLA's int32 multiply wraps).
__device__ __forceinline__ int kq_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

// jnp ``//``: floor division.  C++ ``/`` truncates toward zero, so a
// negative quotient with a remainder is one too large (-1000 / 4000 is 0,
// -1000 // 4000 is -1).  b != 0; the callers divide by max(x, 1).
__device__ __forceinline__ int kq_floordiv(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// Static quota planes of one node forest: [N, F] row-major, parent [N].
struct KqTree {
  const int* subtree;
  const int* guaranteed;
  const int* borrow_cap;
  const uint8_t* has_blim;
  const int* parent;
  int F;
  int depth;
};

#define KQ_CHAIN_SEG 16

// The i-th ancestor of node (i = 0: the node itself), -1 past the root.
__device__ __forceinline__ int kq_ancestor(const int* parent, int node,
                                           int i) {
  int n = node;
  for (int k = 0; k < i && n >= 0; ++k) n = parent[n];
  return n;
}

// Calls visit(c) for each ancestor c >= 0 of node below level `depth`,
// top-down: the depth-1-th ancestor first, the node last.  The chain sits
// in registers KQ_CHAIN_SEG levels at a time, the topmost segment first,
// and each segment's first node is found by walking up from the node: a
// chain of at most KQ_CHAIN_SEG levels costs `depth` parent reads, a
// deeper one about depth^2 / (2 KQ_CHAIN_SEG) more.
template <typename Visit>
__device__ __forceinline__ void kq_chain_top_down(const int* parent,
                                                  int node, int depth,
                                                  Visit visit) {
  for (int lo = ((depth - 1) / KQ_CHAIN_SEG) * KQ_CHAIN_SEG; lo >= 0;
       lo -= KQ_CHAIN_SEG) {
    int chain[KQ_CHAIN_SEG];
    const int n_seg = min(depth - lo, KQ_CHAIN_SEG);
    int n = kq_ancestor(parent, node, lo);
    for (int i = 0; i < n_seg; ++i) {
      chain[i] = n;
      n = (n >= 0) ? parent[n] : -1;
    }
    for (int i = n_seg - 1; i >= 0; --i) {
      if (chain[i] >= 0) visit(chain[i]);
    }
  }
}

// available() of one node in column f (resource_node.go:89): the chain
// form of quota_kernel.available_at, walked from the depth-1-th ancestor
// down to the node.  node = -1 gives 0.
__device__ __forceinline__ int kq_available_at(const KqTree& t,
                                               const int* usage, int node,
                                               int f) {
  int avail = 0;
  kq_chain_top_down(t.parent, node, t.depth, [&](int c) {
    const size_t o = static_cast<size_t>(c) * t.F + f;
    const int u = usage[o];
    if (t.parent[c] < 0) {
      avail = kq_sub(t.subtree[o], u);
    } else {
      const int g = t.guaranteed[o];
      const int local = max(0, kq_sub(g, u));
      int pa = avail;
      if (t.has_blim[o]) {
        const int used_in_parent = max(0, kq_sub(u, g));
        pa = min(kq_sub(t.borrow_cap[o], used_in_parent), avail);
      }
      avail = kq_add(local, pa);
    }
  });
  return avail;
}
