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
// The f32 forward keeps `silu_one<float>`.
// The backward (redesigned for the card) moves three streams in the same 16-byte accesses,
// one vector a thread (more warps in flight than with two or four, which were slower), a's
// vectors setting the phase: h's row is read in vectors where it lies at a's phase (else
// one element at a time), the output stored whole where it does.  For bf16 a table
// of (d, c) for every a (256 KiB, built on the card by `logistic` and today's ops, exact
// by construction) leaves four rounded ops, j = a h, k = h d, l = j c, grad = k + l,
// computed as packed bf16x2 FMAs (`__hfma2`: a product plus -0, a sum as k * 1 + l), one
// rounding each.  A product of two bf16 values is exact in f32, and a sum of two is exact
// in f32 where their exponents differ by 16 or less and rounds to the larger otherwise,
// so one rounding to bf16 equals the reference's f32 op and rounding everywhere but where
// its flush acts: an element where a, h or a result lies in (0, 2^-126] is computed again
// by the reference's ops (on the table's d and c); a zero, exact or flushed, carries the
// same sign either way.  (The reference's ops on the same table, exact too, were slower at
// every LM shape.)  The f32 backward keeps
// `silu_grad_one<float>`.  Both walk rows of unit-stride elements with row strides of
// their own (a column slice of a projection, as the mixer's `z`, is read where it lies);
// the output is dense.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr float kMinNormal = 1.17549435e-38f;  // FLT_MIN
// The forward's 16-byte vectors a thread (the backward's one), and the longest row one
// launch walks with 32-bit column indices (a longer one goes as pieces of it).
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

__device__ __forceinline__ float bf16_bits(uint32_t bits) { return __uint_as_float(bits << 16); }

// The reference's last four ops on one bf16 element, d and c given: raw bits in and out.
__device__ __forceinline__ uint32_t grad_exact(uint32_t abits, uint32_t hbits, uint32_t dc) {
  const float a = flush(bf16_bits(abits));
  const float h = flush(bf16_bits(hbits));
  const float d = __uint_as_float(dc << 16);
  const float c = __uint_as_float(dc & 0xFFFF0000u);
  const float j = keep<Bf16>(__fmul_rn(a, h));
  const float k = keep<Bf16>(__fmul_rn(h, d));
  const float l = keep<Bf16>(__fmul_rn(j, c));
  return __bfloat16_as_ushort(Io<Bf16>::store(keep<Bf16>(__fadd_rn(k, l))));
}

__device__ __forceinline__ __nv_bfloat162 pair(uint32_t w) { return *reinterpret_cast<const __nv_bfloat162*>(&w); }
__device__ __forceinline__ uint32_t pair_bits(__nv_bfloat162 v) { return *reinterpret_cast<const uint32_t*>(&v); }

// Bit 15 of each 16-bit lane set where the lane's bf16 magnitude lies in (0, 2^-126]
// (0x0001-0x0080): m + 0x7FFF carries into bit 15 from 1, m + 0x7F7F from 0x81, and no
// lane carries into the next.
__device__ __forceinline__ uint32_t tiny_lanes(uint32_t w) {
  const uint32_t m = w & 0x7FFF7FFFu;
  return (m + 0x7FFF7FFFu) & ~(m + 0x7F7F7F7Fu);
}

// The backward's element functions on one 32-bit word of a and of h: two bf16 lanes (a
// scalar element in the low one) or one f32.
struct GradTable {
  const uint32_t* table;
  __device__ __forceinline__ uint32_t operator()(uint32_t wa, uint32_t wh) const {
    const uint32_t t0 = __ldg(table + (wa & 0xFFFFu));
    const uint32_t t1 = __ldg(table + (wa >> 16));
    const __nv_bfloat162 a = pair(wa), h = pair(wh);
    const __nv_bfloat162 d = pair(__byte_perm(t0, t1, 0x5410)), c = pair(__byte_perm(t0, t1, 0x7632));
    const __nv_bfloat162 neg_zero = pair(0x80008000u), one = pair(0x3F803F80u);
    const __nv_bfloat162 j = __hfma2(a, h, neg_zero);
    const __nv_bfloat162 k = __hfma2(h, d, neg_zero);
    const __nv_bfloat162 l = __hfma2(j, c, neg_zero);
    const uint32_t g = pair_bits(__hfma2(k, one, l));
    const uint32_t tiny = (tiny_lanes(wa) | tiny_lanes(wh) | tiny_lanes(pair_bits(j)) | tiny_lanes(pair_bits(k)) |
                           tiny_lanes(pair_bits(l)) | tiny_lanes(g)) & 0x80008000u;
    if (tiny == 0) return g;
    return grad_exact(wa & 0xFFFFu, wh & 0xFFFFu, t0) | (grad_exact(wa >> 16, wh >> 16, t1) << 16);
  }
};

struct GradF32 {
  __device__ __forceinline__ uint32_t operator()(uint32_t wa, uint32_t wh) const {
    return __float_as_uint(silu_grad_one<float>(__uint_as_float(wa), __uint_as_float(wh)));
  }
};

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

// The (d, c) table of every bf16 a: d = logistic(a) and c = d (1 - d) as the reference
// rounds them, d in the low 16 bits.
__global__ void __launch_bounds__(kThreads) silu_grad_table_kernel(uint32_t* __restrict__ table) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float a = flush(bf16_bits(static_cast<uint32_t>(i)));
  const float d = logistic<Bf16>(a);
  const float e = round_to<Bf16>(__fsub_rn(1.0f, d));
  const float c = keep<Bf16>(__fmul_rn(d, e));
  table[i] = (__float_as_uint(d) >> 16) | (__float_as_uint(c) & 0xFFFF0000u);
}

// A word of E elements at p, read one element at a time (p need not be aligned).
template <class E>
__device__ __forceinline__ uint32_t word_at(const E* p) {
  return sizeof(E) == 2 ? static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 16)
                        : static_cast<uint32_t>(p[0]);
}

// As silu_fwd_kernel, over a and h, one 16-byte vector a thread (tiles of kThreads
// vectors): row r reads a + r * sa and h + r * sh and writes out + r * cols.  a's 16-byte
// boundaries set the head, the vectors and the tail; h's vector is read whole where h's
// row lies at a's phase, else one element at a time; the output's is stored whole where
// it lies at that phase.
template <class E, class Op>
__global__ void __launch_bounds__(kThreads)
    silu_bwd_kernel(const E* __restrict__ a, long long sa, const E* __restrict__ h, long long sh,
                    E* __restrict__ out, int cols, int tiles_per_row, long long tiles, Op op) {
  constexpr int kV = 16 / sizeof(E);
  constexpr int kW = 4 / sizeof(E);  // elements a word
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / tiles_per_row;
    const int tile = static_cast<int>(t - r * tiles_per_row);
    const E* ar = a + r * sa;
    const E* hr = h + r * sh;
    E* outr = out + r * cols;
    const int lead = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(ar) & 15)) & 15) / static_cast<int>(sizeof(E));
    const int head = lead < cols ? lead : cols;
    const int nvec = (cols - head) / kV;
    const int body_end = head + nvec * kV;
    if (tile == 0 && static_cast<int>(threadIdx.x) < head + cols - body_end) {
      const int c = static_cast<int>(threadIdx.x) < head ? threadIdx.x : body_end + threadIdx.x - head;
      outr[c] = static_cast<E>(op(ar[c], hr[c]));
    }
    const int v = tile * kThreads + threadIdx.x;
    if (v >= nvec) continue;
    const uint4 va = __ldg(reinterpret_cast<const uint4*>(ar + head + v * kV));
    const E* hv = hr + head + v * kV;
    const uint4 vh = ((reinterpret_cast<uintptr_t>(hr + head)) & 15) == 0
                         ? __ldg(reinterpret_cast<const uint4*>(hv))
                         : make_uint4(word_at(hv), word_at(hv + kW), word_at(hv + 2 * kW), word_at(hv + 3 * kW));
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = op(word(va, i), word(vh, i));
    E* dst = outr + head + v * kV;
    if (((reinterpret_cast<uintptr_t>(outr + head)) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (sizeof(E) == 2) {
          dst[2 * i] = static_cast<E>(w[i] & 0xFFFFu);
          dst[2 * i + 1] = static_cast<E>(w[i] >> 16);
        } else {
          dst[i] = static_cast<E>(w[i]);
        }
      }
    }
  }
}

// Tiles of rows x cols elements of E (cols <= kMaxCols), `per_tile` 16-byte vectors of a
// row each, and a grid that strides over them past 2^20 blocks.
template <class E>
unsigned vec_tiles(long long rows, long long cols, long long per_tile, long long* tiles_per_row, long long* tiles) {
  constexpr long long kV = 16 / sizeof(E);
  *tiles_per_row = ((cols + kV - 1) / kV + per_tile - 1) / per_tile;
  *tiles = rows * *tiles_per_row;
  return static_cast<unsigned>(*tiles < (1LL << 20) ? *tiles : (1LL << 20));
}

// Runs launch(rows, cols, r, c) over rows x cols: once (r = c = 0) where cols <= kMaxCols,
// else over each row in pieces of kMaxCols (a multiple of 8 elements, so each piece keeps
// the row's phase), piece (r, c) as one row; the first launch error stops it.
template <class Launch>
int walk(long long rows, long long cols, Launch launch) {
  if (cols <= kMaxCols) {
    launch(rows, cols, 0LL, 0LL);
    return static_cast<int>(cudaGetLastError());
  }
  for (long long r = 0; r < rows; ++r) {
    for (long long c = 0; c < cols; c += kMaxCols) {
      launch(1LL, cols - c < kMaxCols ? cols - c : kMaxCols, r, c);
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
  }
  return 0;
}

template <class E, class Op>
int fwd(const void* a, long long sa, void* y, long long rows, long long cols, Op op, cudaStream_t s) {
  return walk(rows, cols, [&](long long nr, long long nc, long long r, long long c) {
    long long tiles_per_row, tiles;
    const unsigned grid = vec_tiles<E>(nr, nc, kTileVecs, &tiles_per_row, &tiles);
    silu_fwd_kernel<E, Op><<<grid, kThreads, 0, s>>>(static_cast<const E*>(a) + r * sa + c, sa,
                                                     static_cast<E*>(y) + r * cols + c, static_cast<int>(nc),
                                                     static_cast<int>(tiles_per_row), tiles, op);
  });
}

template <class E, class Op>
int bwd(const void* a, long long sa, const void* h, long long sh, void* out, long long rows, long long cols, Op op,
        cudaStream_t s) {
  return walk(rows, cols, [&](long long nr, long long nc, long long r, long long c) {
    long long tiles_per_row, tiles;
    const unsigned grid = vec_tiles<E>(nr, nc, kThreads, &tiles_per_row, &tiles);
    silu_bwd_kernel<E, Op><<<grid, kThreads, 0, s>>>(static_cast<const E*>(a) + r * sa + c, sa,
                                                     static_cast<const E*>(h) + r * sh + c, sh,
                                                     static_cast<E*>(out) + r * cols + c, static_cast<int>(nc),
                                                     static_cast<int>(tiles_per_row), tiles, op);
  });
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

// (d, c) of every bf16 bit pattern into `table` (65,536 words), as silu_bwd reads it.
extern "C" int silu_grad_table_launch(void* table, void* stream) {
  silu_grad_table_kernel<<<(1 << 16) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(table));
  return static_cast<int>(cudaGetLastError());
}

// As silu_fwd_launch, with h's rows at h + r * sh (sh >= cols where rows > 1); bf16 reads
// `table` (silu_grad_table_launch's).
extern "C" int silu_bwd_launch(const void* a, long long sa, const void* h, long long sh, void* out,
                               long long rows, long long cols, int dtype, const void* table, void* stream) {
  if (rows < 1 || cols < 1 || (rows > 1 && (sa < cols || sh < cols)) || (dtype == 0 && table == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd<uint16_t>(a, sa, h, sh, out, rows, cols, GradTable{static_cast<const uint32_t*>(table)},
                                       s);
  if (dtype == 1) return bwd<uint32_t>(a, sa, h, sh, out, rows, cols, GradF32{}, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
