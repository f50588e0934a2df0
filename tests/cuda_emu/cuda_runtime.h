// The CUDA built-ins the port's kernels use, for compiling `csrc/*.cu` as
// plain C++20 on a machine without a card (tests/test_torch_emulated.py).
//
// A launch `emu_launch(kernel, grid, block, smem, stream, args...)` runs
// the CTAs one after another; the threads of a CTA run as std::threads
// that share one dynamic shared-memory buffer (filled with 0xDEADBEEF, so
// that a word read before it is written shows in the result), with a
// std::barrier for __syncthreads().  Device intrinsics become their
// arithmetic definitions; cudaFuncSetAttribute and cudaGetLastError
// succeed.
#pragma once

#include <barrier>
#include <cstdint>
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

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
inline cudaError_t cudaFuncSetAttribute(const void*, int, int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated launch error"; }

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
