// The CUDA built-ins the port's kernels use, for compiling `csrc/*.cu` as
// plain C++20 on a machine without a card (tests/test_torch_emulated.py).
//
// A launch `emu_launch(kernel, grid, block, smem, stream, args...)` runs
// the CTAs one after another; the threads of a CTA run as std::threads
// that share one dynamic shared-memory buffer (filled with 0xDEADBEEF, so
// that a word read before it is written shows in the result), with a
// std::barrier for __syncthreads().  Device intrinsics become their
// arithmetic definitions; cudaFuncSetAttribute and cudaGetLastError
// succeed; device and host memory are one, so a copy is a memcpy, and
// streams, events and devices have nothing to do.
#pragma once

#include <math.h>

#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct EmuDim {
  unsigned x = 0, y = 1, z = 1;
};
inline thread_local EmuDim threadIdx, blockIdx, blockDim, gridDim;
inline thread_local std::barrier<>* emu_barrier = nullptr;
inline thread_local uint32_t* emu_shared = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }

struct alignas(16) uint4 {
  uint32_t x, y, z, w;
};
struct alignas(8) uint2 {
  uint32_t x, y;
};
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
struct alignas(16) double2 {
  double x, y;
};
inline double2 make_double2(double x, double y) { return {x, y}; }

typedef int cudaError_t;
typedef void* cudaStream_t;
typedef void* cudaEvent_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaMemcpyKind { cudaMemcpyHostToDevice = 1, cudaMemcpyDeviceToHost = 2 };
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* device) {
  *device = 0;
  return cudaSuccess;
}
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaMemcpyAsync(void* dst, const void* src, size_t bytes, cudaMemcpyKind,
                                   cudaStream_t) {
  std::memcpy(dst, src, bytes);
  return cudaSuccess;
}
inline cudaError_t cudaStreamSynchronize(cudaStream_t) { return cudaSuccess; }
inline cudaError_t cudaEventRecord(cudaEvent_t, cudaStream_t) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated launch error"; }

// The float and double intrinsics: the host's IEEE operations, which g++ does
// not contract on x86-64 without -mfma; std::fma rounds once, as an FMA does.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __fma_rn(double a, double b, double c) { return std::fma(a, b, c); }
inline int __float2int_rz(float v) { return static_cast<int>(v); }
inline float __int_as_float(int v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline int __float_as_int(float v) {
  int i;
  std::memcpy(&i, &v, sizeof i);
  return i;
}

template <typename... P, typename... A>
void emu_launch(void (*kernel)(P...), unsigned grid, int block, size_t smem, cudaStream_t,
                A... args) {
  for (unsigned b = 0; b < grid; ++b) {
    std::vector<uint4> shared(smem / sizeof(uint4) + 1, uint4{0xDEADBEEF, 0xDEADBEEF, 0xDEADBEEF, 0xDEADBEEF});
    std::barrier<> barrier(block);
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t) {
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        blockIdx.x = b;
        blockDim.x = block;
        gridDim.x = grid;
        emu_barrier = &barrier;
        emu_shared = reinterpret_cast<uint32_t*>(shared.data());
        kernel(static_cast<P>(args)...);
      });
    }
    for (auto& th : threads) th.join();
  }
}
