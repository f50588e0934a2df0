// SiLU and its gradient for Hopper (sm_90a), rounded as the reference rounds them.
//
// Replaces no Pallas kernel: the JAX package calls `jax.nn.silu` on bf16 in the MLP,
// both MoE expert paths and the Mamba mixer (src/repro/models/layers.py, ssm.py).  Its
// jaxpr is `x * logistic(x)`, lowered to five ops: negate, exp, add 1, divide 1 by it,
// multiply by x; `jax.grad` adds d = logistic(a), e = 1 - d, c = d * e, j = a * h,
// k = h * d, l = j * c, grad = k + l.  XLA rounds to the operand type after every op
// and, on the CPU, flushes subnormals (a subnormal operand reads as a zero of its sign,
// a subnormal result becomes one before it is rounded).  `torch.nn.functional.silu`
// rounds once, so it differs from the reference in many bf16 elements.
//   silu_fwd:  y    = silu(a)
//   silu_bwd:  grad = the VJP of silu at a, applied to h
// each op here computed in f32, its result flushed and rounded to T: the plain torch
// version (kernels/silu.py) does the same ops, so the two agree bit for bit.  `expf`
// and the correctly rounded reciprocal, as torch's CUDA `exp` and `reciprocal` give
// them; every product and sum goes through __fmul_rn / __fadd_rn, which nvcc never
// contracts into an FMA.
//
// Bound on the H100: device-memory bytes (per element one read and one write forward,
// two reads and one write backward; ~40 instructions an element forward).  The design
// walks rows of unit-stride elements with a row stride of their own (a column slice
// of a projection, as the mixer's `z`, is read where it lies), in tiles of
// kThreads x kPerThread elements of one row, neighbouring threads on neighbouring
// elements; the output is dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kTile = static_cast<long long>(kThreads) * kPerThread;
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN

// The reference's CPU flush: a subnormal becomes a zero of its sign.
__device__ __forceinline__ float flush(float v) {
  return fabsf(v) < kMinNormal ? copysignf(0.0f, v) : v;
}

template <class T>
struct Io;

template <>
struct Io<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) { return __bfloat162float(v); }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) { return __float2bfloat16_rn(v); }
};

template <>
struct Io<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

// One op's f32 result rounded to T; `keep` flushes it first, as the reference
// keeps it, where the result can be subnormal.
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return Io<T>::load(Io<T>::store(v));
}

template <class T>
__device__ __forceinline__ float keep(float v) {
  return round_to<T>(flush(v));
}

// 1 + e >= 1 is normal; __frcp_rn is 1 / t correctly rounded, as IEEE division gives it.
template <class T>
__device__ __forceinline__ float logistic(float x) {
  const float e = keep<T>(expf(-x));
  const float t = round_to<T>(__fadd_rn(1.0f, e));
  return keep<T>(__frcp_rn(t));
}

template <class T>
__device__ __forceinline__ T silu_one(T av) {
  const float a = flush(Io<T>::load(av));
  return Io<T>::store(keep<T>(__fmul_rn(a, logistic<T>(a))));
}

template <class T>
__device__ __forceinline__ T silu_grad_one(T av, T hv) {
  const float a = flush(Io<T>::load(av));
  const float h = flush(Io<T>::load(hv));
  const float d = logistic<T>(a);
  const float e = round_to<T>(__fsub_rn(1.0f, d));  // 0, or >= 2^-24: never subnormal
  const float c = keep<T>(__fmul_rn(d, e));
  const float j = keep<T>(__fmul_rn(a, h));
  const float k = keep<T>(__fmul_rn(h, d));
  const float l = keep<T>(__fmul_rn(j, c));
  return Io<T>::store(keep<T>(__fadd_rn(k, l)));
}

// Tile t covers row t / tiles_per_row, columns from (t % tiles_per_row) * kTile.
template <class T>
__global__ void __launch_bounds__(kThreads)
    silu_fwd_kernel(const T* __restrict__ a, long long sa, T* __restrict__ y, long long cols,
                    long long tiles_per_row, long long tiles) {
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / tiles_per_row;
    const long long c0 = (t - r * tiles_per_row) * kTile + threadIdx.x;
    const T* ar = a + r * sa;
    T* yr = y + r * cols;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long c = c0 + static_cast<long long>(k) * kThreads;
      if (c < cols) yr[c] = silu_one<T>(ar[c]);
    }
  }
}

template <class T>
__global__ void __launch_bounds__(kThreads)
    silu_bwd_kernel(const T* __restrict__ a, long long sa, const T* __restrict__ h, long long sh,
                    T* __restrict__ out, long long cols, long long tiles_per_row, long long tiles) {
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / tiles_per_row;
    const long long c0 = (t - r * tiles_per_row) * kTile + threadIdx.x;
    const T* ar = a + r * sa;
    const T* hr = h + r * sh;
    T* outr = out + r * cols;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const long long c = c0 + static_cast<long long>(k) * kThreads;
      if (c < cols) outr[c] = silu_grad_one<T>(ar[c], hr[c]);
    }
  }
}

// The tiles of rows x cols, and a grid that strides over them past 2^20 blocks.
bool tiling(long long rows, long long cols, long long* tiles_per_row, long long* tiles,
            unsigned* grid) {
  if (rows < 1 || cols < 1) return false;
  *tiles_per_row = (cols + kTile - 1) / kTile;
  *tiles = rows * *tiles_per_row;
  *grid = static_cast<unsigned>(*tiles < (1LL << 20) ? *tiles : (1LL << 20));
  return true;
}

}  // namespace

// dtype: 0 bf16, 1 f32.  a: rows of cols elements, row r at a + r * sa (sa >= cols
// where rows > 1); y dense, rows x cols.
extern "C" int silu_fwd_launch(const void* a, long long sa, void* y, long long rows, long long cols,
                               int dtype, void* stream) {
  long long tiles_per_row, tiles;
  unsigned grid;
  if (!tiling(rows, cols, &tiles_per_row, &tiles, &grid) || (rows > 1 && sa < cols))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    silu_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), sa, static_cast<__nv_bfloat16*>(y), cols, tiles_per_row,
        tiles);
  } else if (dtype == 1) {
    silu_fwd_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(a), sa,
                                                     static_cast<float*>(y), cols, tiles_per_row, tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// As silu_fwd_launch, with h's rows at h + r * sh.
extern "C" int silu_bwd_launch(const void* a, long long sa, const void* h, long long sh, void* out,
                               long long rows, long long cols, int dtype, void* stream) {
  long long tiles_per_row, tiles;
  unsigned grid;
  if (!tiling(rows, cols, &tiles_per_row, &tiles, &grid) || (rows > 1 && (sa < cols || sh < cols)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    silu_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), sa, static_cast<const __nv_bfloat16*>(h), sh,
        static_cast<__nv_bfloat16*>(out), cols, tiles_per_row, tiles);
  } else if (dtype == 1) {
    silu_bwd_kernel<float><<<grid, kThreads, 0, s>>>(static_cast<const float*>(a), sa,
                                                     static_cast<const float*>(h), sh,
                                                     static_cast<float*>(out), cols, tiles_per_row,
                                                     tiles);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
