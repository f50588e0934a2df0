// Element-wise modular multiply for Hopper (sm_90a): B3 `modmul`.
//
// Replaces the Pallas kernel `_modmul_kernel` (src/repro/kernels/modmul.py):
// out = a * b mod q as the Montgomery round trip REDC(REDC(a*b) * R^2),
// the formula of `mulmod_u32` (src/repro/core/modmath.py), with the high
// words from `__umulhi`.
// Bound on the H100: device-memory bytes (two words read and one written
// per element, ~10 integer ops).  The design is a grid-stride loop in
// which neighbouring threads take neighbouring words, so every load and
// store is coalesced; nothing is staged, since nothing is reused.
#include <cuda_runtime.h>

#include <cstdint>

#include "modmath.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void modmul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, long long count, uint32_t q,
                              uint32_t qprime, uint32_t r2) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < count;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[i] = repro_torch::mulmod(a[i], b[i], q, qprime, r2);
  }
}

}  // namespace

extern "C" int modmul_launch(const uint32_t* a, const uint32_t* b, uint32_t* out, long long count,
                             uint32_t q, uint32_t qprime, uint32_t r2, void* stream) {
  if (count < 1) return static_cast<int>(cudaErrorInvalidValue);
  long long grid = (count + kThreads - 1) / kThreads;
  if (grid > (1LL << 20)) grid = 1LL << 20;  // grid-stride beyond this
  modmul_kernel<<<static_cast<unsigned>(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, out, count, q, qprime, r2);
  return static_cast<int>(cudaGetLastError());
}
