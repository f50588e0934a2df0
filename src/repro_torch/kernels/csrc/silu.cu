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
// two reads and one write backward).  The forward is issue-bound if it spends more than
// ~40 instructions an element, so its design (redesigned for the card) moves 16 bytes an
// access, 8 bf16 or 4 f32, with 32-bit column indices and a scalar head and tail wherever
// a row's start is not 16-byte aligned; bf16 silu is a function of one 16-bit input, so it
// reads a table of all 65,536 results (128 KiB, built on the card by `silu_one` itself,
// exact by construction) through the read-only cache.  (Fast intrinsics with `expf`
// re-done near a bf16 rounding midpoint were exact too, and slower at every LM shape.)
// The f32 forward keeps `silu_one<float>`.  The backward walks rows of unit-stride
// elements with a row stride of their own (a column slice of a projection, as the mixer's
// `z`, is read where it lies), in tiles of kThreads x kPerThread elements of one row,
// neighbouring threads on neighbouring elements; both outputs are dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr long long kTile = static_cast<long long>(kThreads) * kPerThread;
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN
// The forward: 16-byte vectors a thread, and the longest row one launch walks with
// 32-bit column indices (a longer one goes as pieces of it).
constexpr int kVecs = 2;
constexpr int kTileVecs = kThreads * kVecs;
constexpr long long kMaxCols = 1LL << 30;

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

using Bf16 = __nv_bfloat16;

// The forward's element functions, raw bits in and out (a bf16 in the low 16 bits).
struct SiluTable {
  const unsigned short* table;
  __device__ __forceinline__ uint32_t operator()(uint32_t bits) const { return __ldg(table + bits); }
};

struct SiluF32 {
  __device__ __forceinline__ uint32_t operator()(uint32_t bits) const {
    return __float_as_uint(silu_one<float>(__uint_as_float(bits)));
  }
};

// A 16-byte vector's word i (i known at compile time once unrolled).
__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <class E, class Op>
__device__ __forceinline__ uint4 map_vec(const uint4& v, const Op& op) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t x = word(v, i);
    w[i] = sizeof(E) == 2 ? op(x & 0xFFFFu) | (op(x >> 16) << 16) : op(x);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Tile t covers row t / tiles_per_row, its vectors from (t % tiles_per_row) * kTileVecs.
// A row r reads a + r * sa and writes y + r * cols: its elements before a's first 16-byte
// boundary (head) and after its last whole vector (tail) go one by one, by tile 0's
// threads; the vectors between are stored whole where y's row lies at the same phase.
template <class E, class Op>
__global__ void __launch_bounds__(kThreads)
    silu_fwd_kernel(const E* __restrict__ a, long long sa, E* __restrict__ y, int cols, int tiles_per_row,
                    long long tiles, Op op) {
  constexpr int kV = 16 / sizeof(E);
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / tiles_per_row;
    const int tile = static_cast<int>(t - r * tiles_per_row);
    const E* ar = a + r * sa;
    E* yr = y + r * cols;
    const int lead = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(ar) & 15)) & 15) / static_cast<int>(sizeof(E));
    const int head = lead < cols ? lead : cols;
    const int nvec = (cols - head) / kV;
    const int body_end = head + nvec * kV;
    if (tile == 0 && static_cast<int>(threadIdx.x) < head + cols - body_end) {
      const int c = static_cast<int>(threadIdx.x) < head ? threadIdx.x : body_end + threadIdx.x - head;
      yr[c] = static_cast<E>(op(ar[c]));
    }
    const bool whole = ((reinterpret_cast<uintptr_t>(yr + head)) & 15) == 0;
    const int v0 = tile * kTileVecs + threadIdx.x;
    uint4 in[kVecs];
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = v0 + k * kThreads;
      if (v < nvec) in[k] = __ldg(reinterpret_cast<const uint4*>(ar + head + v * kV));
    }
#pragma unroll
    for (int k = 0; k < kVecs; ++k) {
      const int v = v0 + k * kThreads;
      if (v >= nvec) continue;
      const uint4 out = map_vec<E>(in[k], op);
      E* dst = yr + head + v * kV;
      if (whole) {
        *reinterpret_cast<uint4*>(dst) = out;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t x = word(out, i);
          if (sizeof(E) == 2) {
            dst[2 * i] = static_cast<E>(x & 0xFFFFu);
            dst[2 * i + 1] = static_cast<E>(x >> 16);
          } else {
            dst[i] = static_cast<E>(x);
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) silu_table_kernel(unsigned short* __restrict__ table) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  table[i] = __bfloat16_as_ushort(silu_one<Bf16>(__ushort_as_bfloat16(static_cast<unsigned short>(i))));
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

// One forward launch over rows x cols (cols <= kMaxCols).
template <class E, class Op>
void fwd_launch(const void* a, long long sa, void* y, long long rows, long long cols, Op op, cudaStream_t s) {
  constexpr long long kV = 16 / sizeof(E);
  const long long tiles_per_row = ((cols + kV - 1) / kV + kTileVecs - 1) / kTileVecs;
  const long long tiles = rows * tiles_per_row;
  const unsigned grid = static_cast<unsigned>(tiles < (1LL << 20) ? tiles : (1LL << 20));
  silu_fwd_kernel<E, Op><<<grid, kThreads, 0, s>>>(static_cast<const E*>(a), sa, static_cast<E*>(y),
                                                   static_cast<int>(cols), static_cast<int>(tiles_per_row),
                                                   tiles, op);
}

// The forward over rows x cols; a row longer than kMaxCols as pieces of kMaxCols (a
// multiple of 8 elements, so each piece keeps the row's phase), one launch each.
template <class E, class Op>
int fwd(const void* a, long long sa, void* y, long long rows, long long cols, Op op, cudaStream_t s) {
  if (cols <= kMaxCols) {
    fwd_launch<E>(a, sa, y, rows, cols, op, s);
    return static_cast<int>(cudaGetLastError());
  }
  for (long long r = 0; r < rows; ++r) {
    for (long long c = 0; c < cols; c += kMaxCols) {
      const long long n = cols - c < kMaxCols ? cols - c : kMaxCols;
      fwd_launch<E>(static_cast<const E*>(a) + r * sa + c, n, static_cast<E*>(y) + r * cols + c, 1, n, op, s);
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
  }
  return 0;
}

}  // namespace

// dtype: 0 bf16, 1 f32.  a: rows of cols elements, row r at a + r * sa (sa >= cols
// where rows > 1); y dense, rows x cols.  bf16 reads `table` (silu_table_launch's).
extern "C" int silu_fwd_launch(const void* a, long long sa, void* y, long long rows, long long cols,
                               int dtype, const void* table, void* stream) {
  if (rows < 1 || cols < 1 || (rows > 1 && sa < cols) || (dtype == 0 && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<uint16_t>(a, sa, y, rows, cols, SiluTable{static_cast<const unsigned short*>(table)}, s);
  if (dtype == 1) return fwd<uint32_t>(a, sa, y, rows, cols, SiluF32{}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// silu of every bf16 bit pattern into `table` (65,536 bf16), as silu_fwd reads it.
extern "C" int silu_table_launch(void* table, void* stream) {
  silu_table_kernel<<<(1 << 16) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned short*>(table));
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
