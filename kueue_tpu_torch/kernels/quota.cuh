// Hierarchical quota recurrences as per-column device helpers.
//
// Replaces the JAX recurrences in kueue_tpu/ops/quota_kernel.py
// (available_at, add_usage_chain) and the two remove_usage_chain copies
// (kueue_tpu/ops/cycle.py _remove_usage_chain, ops/preemption_kernel.py
// remove_usage_chain).  Every recurrence is independent per
// flavor-resource column f, so the kernels give each thread of a block one
// column: thread f walks the ancestor chain of a node for column f only,
// and no two threads ever touch the same usage cell.  Cross-column
// decisions (a fit over all pairs) are block reductions in the kernels.
//
// Arithmetic: XLA's int32 adds and subtracts wrap; signed overflow is
// undefined in C++, so every add and subtract goes through unsigned.
#pragma once

#include <cstdint>

#define KQ_MAX_DEPTH 16

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

// available() of one node in column f (resource_node.go:89): the chain
// form of quota_kernel.available_at.  node = -1 gives 0.
__device__ __forceinline__ int kq_available_at(const KqTree& t,
                                               const int* usage, int node,
                                               int f) {
  int chain[KQ_MAX_DEPTH];
  int n = node;
  for (int i = 0; i < t.depth; ++i) {
    chain[i] = n;
    n = (n >= 0) ? t.parent[n] : -1;
  }
  int avail = 0;
  for (int i = t.depth - 1; i >= 0; --i) {
    const int c = chain[i];
    if (c < 0) continue;
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
  }
  return avail;
}

// addUsage() up one ancestor chain in column f (resource_node.go:123).
// When `old` is given, the overwritten cells are saved for kq_restore_chain.
__device__ __forceinline__ void kq_add_usage_chain(const KqTree& t,
                                                   int* usage, int node,
                                                   int delta, int f,
                                                   int* old = nullptr) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < t.depth && cur >= 0; ++i) {
    const size_t o = static_cast<size_t>(cur) * t.F + f;
    const int u = usage[o];
    if (old != nullptr) old[i] = u;
    const int local_avail = max(0, kq_sub(t.guaranteed[o], u));
    usage[o] = kq_add(u, carry);
    carry = max(0, kq_sub(carry, local_avail));
    cur = t.parent[cur];
  }
}

// Undo a kq_add_usage_chain that saved into `old`.
__device__ __forceinline__ void kq_restore_chain(const KqTree& t, int* usage,
                                                 int node, int f,
                                                 const int* old) {
  int cur = node;
  for (int i = 0; i < t.depth && cur >= 0; ++i) {
    usage[static_cast<size_t>(cur) * t.F + f] = old[i];
    cur = t.parent[cur];
  }
}

// remove_usage() up one ancestor chain in column f (resource_node.go:135).
__device__ __forceinline__ void kq_remove_usage_chain(const KqTree& t,
                                                      int* usage, int node,
                                                      int delta, int f) {
  int cur = node;
  int carry = delta;
  for (int i = 0; i < t.depth && cur >= 0; ++i) {
    const size_t o = static_cast<size_t>(cur) * t.F + f;
    const int u = usage[o];
    const int stored_in_parent = kq_sub(u, t.guaranteed[o]);
    usage[o] = kq_sub(u, carry);
    carry = stored_in_parent > 0 ? min(carry, stored_in_parent) : 0;
    cur = t.parent[cur];
  }
}
