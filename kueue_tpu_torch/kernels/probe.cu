// kq_add_one replaces the round-trip probe of the JAX solver's router,
// kueue_tpu/ops/solver.py:367 ``jax.jit(lambda x: x + 1)``: warm-up
// uploads eight int32, runs the program and reads the result back,
// and the wall time of that round trip is the solver's ``rtt_s``.  The
// port times the same round trip through its own launch path (the
// launcher's checks, the ctypes call, the current stream), which is what
// every routed dispatch pays.
//
// out[i] = x[i] + 1, added through ``unsigned`` (XLA's int32 add wraps).
// One thread an element; the probe's eight elements are one block.
//
// Bound: bytes, 8 bytes an element; far below a microsecond, so the
// launch is the whole cost, as it should be for a probe.
#include <cuda_runtime.h>

#define KQ_ADD_ONE_THREADS 256

__global__ void kq_add_one_kernel(const int* x, int* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    out[i] = static_cast<int>(static_cast<unsigned>(x[i]) + 1u);
  }
}

// x and out [n] int32 on one device.
extern "C" int kq_add_one(const void* x, void* out, int n,
                          cudaStream_t stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n + KQ_ADD_ONE_THREADS - 1) / KQ_ADD_ONE_THREADS;
  kq_add_one_kernel<<<blocks, KQ_ADD_ONE_THREADS, 0, stream>>>(
      static_cast<const int*>(x), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
