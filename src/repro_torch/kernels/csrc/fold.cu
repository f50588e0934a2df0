// Strict left fold of float64 increments for Hopper (sm_90a): `chain_fold`.
//
// Replaces the JAX package's `lax.scan` bus chain
// (src/repro/pimsys/fastpath/jax_backend.py, `_scan_chain`), which is not a
// Pallas kernel but the fastpath's one sequential recurrence:
// out[0] = b0, out[i + 1] = out[i] + inc[i].  Each value must carry exactly
// the float adds the interpreted arbiter performs, in its order, so the
// fold is bit-identical to `np.cumsum`.  A parallel scan (`torch.cumsum` on
// CUDA) reassociates the adds and is not.
// Bound on the H100: the chain of dependent adds, one after another: its
// time is the add's latency times the length, whatever the card's rates.
// The design is one thread that walks the chain in order (no reassociation
// by construction; nvcc contracts no add, since there is no multiply), with
// the next increments loaded ahead of the adds that need them.
#include <cuda_runtime.h>

namespace {

__global__ void chain_fold_kernel(const double* __restrict__ inc, double* __restrict__ out,
                                  long long count, double b0) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  double acc = b0;
  out[0] = acc;
  long long i = 0;
  for (; i + 4 <= count; i += 4) {
    const double a0 = inc[i], a1 = inc[i + 1], a2 = inc[i + 2], a3 = inc[i + 3];
    acc = acc + a0;
    out[i + 1] = acc;
    acc = acc + a1;
    out[i + 2] = acc;
    acc = acc + a2;
    out[i + 3] = acc;
    acc = acc + a3;
    out[i + 4] = acc;
  }
  for (; i < count; ++i) {
    acc = acc + inc[i];
    out[i + 1] = acc;
  }
}

}  // namespace

extern "C" int chain_fold_launch(const double* inc, double* out, long long count, double b0,
                                 void* stream) {
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  chain_fold_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(inc, out, count, b0);
  return static_cast<int>(cudaGetLastError());
}
