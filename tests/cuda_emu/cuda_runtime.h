// The CUDA built-ins the port's kernels use, for compiling `csrc/*.cu` as
// plain C++20 on a machine without a card (tests/test_torch_emulated.py).
//
// A launch `emu_launch(kernel, grid, block, smem, stream, args...)` runs
// the CTAs one after another on `block` std::threads, one a thread of the
// CTA, which share one dynamic shared-memory buffer (filled with
// 0xDEADBEEF before each CTA, so that a word read before it is written
// shows in the result), with a
// std::barrier for __syncthreads() (and an atomic count for
// __syncthreads_count).  Device intrinsics become their arithmetic
// definitions; cudaFuncSetAttribute and cudaGetLastError
// succeed; device and host memory are one, so a copy is a memcpy, and
// streams, events and devices have nothing to do.
#pragma once

#include <math.h>

#include <algorithm>
#include <atomic>
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
inline thread_local std::atomic<int>* emu_count = nullptr;

inline void __syncthreads() { emu_barrier->arrive_and_wait(); }
// The count of the CTA's threads whose `pred` is not 0, to each of them.
inline int __syncthreads_count(int pred) {
  emu_barrier->arrive_and_wait();  // the last call's count read by every thread
  emu_count->fetch_add(pred != 0);
  emu_barrier->arrive_and_wait();
  const int n = emu_count->load();
  emu_barrier->arrive_and_wait();
  if (threadIdx.x == 0) emu_count->store(0);
  return n;
}
inline unsigned long long atomicAdd(unsigned long long* p, unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * b) >> 32);
}
inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
// Bytes of the eight of {y, x} (x's the low four) that the low three bits of each of
// s's nibbles select, from the result's low byte up.
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (static_cast<uint64_t>(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= static_cast<uint32_t>((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}

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
inline float __uint_as_float(uint32_t v) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  return f;
}
inline uint32_t __float_as_uint(float v) {
  uint32_t u;
  std::memcpy(&u, &v, sizeof u);
  return u;
}

template <typename... P, typename... A>
void emu_launch(void (*kernel)(P...), unsigned grid, int block, size_t smem, cudaStream_t,
                A... args) {
  const uint4 fill{0xDEADBEEF, 0xDEADBEEF, 0xDEADBEEF, 0xDEADBEEF};
  std::vector<uint4> shared(smem / sizeof(uint4) + 1, fill);
  std::barrier<> barrier(block);
  std::atomic<int> count{0};
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t) {  // one thread a CTA thread, running the CTAs in turn
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      blockDim.x = block;
      gridDim.x = grid;
      emu_barrier = &barrier;
      emu_count = &count;
      emu_shared = reinterpret_cast<uint32_t*>(shared.data());
      for (unsigned b = 0; b < grid; ++b) {
        blockIdx.x = b;
        kernel(static_cast<P>(args)...);
        barrier.arrive_and_wait();  // the CTA done: a fresh shared buffer for the next
        if (t == 0) std::fill(shared.begin(), shared.end(), fill);
        barrier.arrive_and_wait();
      }
    });
  }
  for (auto& th : threads) th.join();
}
