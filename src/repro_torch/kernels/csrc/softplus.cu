// softplus and its gradient for Hopper (sm_90a), rounded as the reference's CPU rounds them.
//
// Replaces no Pallas kernel: the JAX package calls `jax.nn.softplus` on f32 in the SSD
// mixer (src/repro/models/ssm.py:224, :263): `logaddexp(x, 0)`, that is
// select(isnan(x), x, max(x, 0) + log1p(exp(-|x|))), and `jax.grad` gives
// g * exp(ri(x) - ri(out)), ri replacing +inf by 0.  XLA's CPU emits `exp` and `log1p`
// as polynomials, and LLVM fuses many of their products with the following add into an
// FMA; the CPU reads subnormal operands as zero and flushes results that are below 2^-126
// after rounding to 24 bits.  This file repeats that machine code op by op:
// __fmaf_rn where the CPU has an FMA, __fmul_rn / __fadd_rn / __fdiv_rn where it has a
// separate op (nvcc never contracts those), and the CPU's flush after every op whose
// result can be tiny, so the kernels agree bit for bit with the plain torch versions
// (kernels/softplus.py), which do the same in f32 / f64 IEEE arithmetic.
//   softplus_fwd:  out = softplus(x)
//   softplus_bwd:  dx  = g * exp(ri(x) - ri(out))
//
// Bound on the H100: ~60 dependent f32 operations an element against 8 bytes (forward)
// or 16 (backward) moved; the SSD's dt tensors are small (mamba2-780m's train dt is
// 4 x 512 x 48 f32, 384 KiB; decode's 4 x 48), so a launch is bound by its latency.
// Both walk rows of unit-stride elements with their own row strides (a contiguous
// tensor is one row), neighbouring threads on neighbouring elements; the output is dense.
// Both (redesigned for the card) cover the latency with warps: one element a thread in
// CTAs of kThreads (768 CTAs, ~6 an SM, at the train shape), its chain in plain f32 ops
// (`Fast`), which note whether any result had |r| <= 2^-126; only such an element, rare
// (subnormal, tiny or huge inputs, NaN; for the grad also a zero cotangent or
// x - out = 0), is computed again by the CPU's ops (`Cpu`).  That is exact: `Cpu::mul`,
// `Cpu::fma` and `Cpu::add` return the plain op's r whenever |r| > 2^-126.  Of log1p's
// two branches only the one selected runs.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr long long kMaxGrid = 1 << 14;  // the most CTAs; more tiles are strided over
constexpr long long kMaxCols = 1LL << 30;
constexpr float kMinNormal = 1.17549435e-38f;  // 2^-126
// The least |v| whose rounding to 24 bits (exponent unbounded) is 2^-126 or more.
constexpr double kTiny = 0x1.ffffffp-127;  // 2^-126 - 2^-151

__device__ __forceinline__ float f32(uint32_t bits) { return __int_as_float(static_cast<int>(bits)); }

// An operand as the CPU reads it: a subnormal is a zero of its sign.
__device__ __forceinline__ float daz(float v) { return fabsf(v) < kMinNormal ? copysignf(0.0f, v) : v; }

// r, the rounded result of a product or an FMA whose exact value `exact` carries, as the
// CPU keeps it: zero of r's sign where the exact value rounded to 24 bits is below 2^-126.
// Only a result of magnitude <= 2^-126 needs the exact value (a subnormal one is tiny).
__device__ __forceinline__ float flushed(float r, double exact) {
  return fabsf(r) <= kMinNormal && fabs(exact) < kTiny ? copysignf(0.0f, r) : r;
}

// The CPU's ops.
struct Cpu {
  __device__ __forceinline__ float mul(float a, float b) {
    const float r = __fmul_rn(a, b);
    return fabsf(r) <= kMinNormal ? flushed(r, __dmul_rn(a, b)) : r;  // the product is exact in f64
  }
  __device__ __forceinline__ float fma(float a, float b, float c) {
    const float r = __fmaf_rn(a, b, c);
    return fabsf(r) <= kMinNormal ? flushed(r, __fma_rn(a, b, c)) : r;
  }
  // A sum that is subnormal is exact, and flushed.
  __device__ __forceinline__ float add(float a, float b) {
    const float r = __fadd_rn(a, b);
    return fabsf(r) < kMinNormal ? copysignf(0.0f, r) : r;
  }
};

// The plain ops, and whether any result had |r| <= 2^-126 (where the CPU's might differ).
struct Fast {
  bool tiny = false;
  __device__ __forceinline__ float note(float r) {
    tiny |= fabsf(r) <= kMinNormal;
    return r;
  }
  __device__ __forceinline__ float mul(float a, float b) { return note(__fmul_rn(a, b)); }
  __device__ __forceinline__ float fma(float a, float b, float c) { return note(__fmaf_rn(a, b, c)); }
  __device__ __forceinline__ float add(float a, float b) { return note(__fadd_rn(a, b)); }
};

// XLA's CPU expf: clamp, n = floor(v log2(e) + 1/2) in [-127, 127], a two-constant
// reduction, a degree-5 polynomial, 2^n in the exponent bits (2^-127 comes out as 0).
template <class Ops>
__device__ __forceinline__ float xla_exp(float v, Ops& op) {
  v = v < f32(0xC2AF999Au) ? f32(0xC2AF999Au) : v;
  v = v > f32(0x42B1999Au) ? f32(0x42B1999Au) : v;
  float n = floorf(op.fma(v, f32(0x3FB8AA3Bu), 0.5f));
  n = n < -127.0f ? -127.0f : n;
  n = n > 127.0f ? 127.0f : n;
  float r = op.fma(-n, f32(0x3F318000u), v);
  r = op.fma(-n, f32(0xB95E8083u), r);
  float p = op.fma(r, f32(0x39506967u), f32(0x3AB743CEu));
  p = op.fma(p, r, f32(0x3C088908u));
  p = op.fma(p, r, f32(0x3D2AA9C1u));
  p = op.fma(p, r, f32(0x3E2AAAAAu));
  p = op.fma(p, r, 0.5f);
  const float e = op.add(op.fma(p, op.mul(r, r), r), 1.0f);
  const int ni = n != n ? 0 : __float2int_rz(n);
  return op.mul(e, __int_as_float(static_cast<int>((static_cast<uint32_t>(ni) << 23) + 0x3F800000u)));
}

// XLA's CPU logf for u in [1, 2] (its cases for u <= 0 and u = inf never arise here).
template <class Ops>
__device__ __forceinline__ float xla_log(float u, Ops& op) {
  u = u > kMinNormal ? u : kMinNormal;
  const uint32_t bits = static_cast<uint32_t>(__float_as_int(u));
  const float m = f32((bits & 0x7FFFFFu) | 0x3F000000u);
  const bool small = m < f32(0x3F3504F3u);
  const float x = op.add(op.add(m, -1.0f), small ? m : 0.0f);
  float e = op.add(static_cast<float>(static_cast<int>(bits >> 23) - 127), 1.0f);
  e = small ? op.add(e, -1.0f) : e;
  const float z = op.mul(x, x);
  const float x3 = op.mul(z, x);
  const float a = op.fma(x, op.fma(x, f32(0x3D9021BBu), f32(0xBDEBD1B8u)), f32(0x3DEF251Au));
  const float b = op.fma(x, op.fma(x, f32(0xBDFE5D4Fu), f32(0x3E11E9BFu)), f32(0xBE2AAE50u));
  const float c = op.fma(x, op.fma(x, f32(0x3E4CCEACu), f32(0xBE7FFFFCu)), f32(0x3EAAAAAAu));
  const float y = op.fma(x3, op.fma(x3, op.fma(x3, a, b), c), op.mul(e, f32(0xB95E8083u)));
  return op.fma(e, f32(0x3F318000u), op.add(op.fma(-0.5f, z, x), y));
}

// XLA's CPU log1p for e in [0, 1]: a rational function below 0.41421357, else logf(1 + e);
// only the branch selected is computed (a NaN selects the second).
template <class Ops>
__device__ __forceinline__ float xla_log1p(float e, Ops& op) {
  if (!(fabsf(e) < f32(0x3ED413CDu))) return xla_log(op.add(e, 1.0f), op);
  const float zero = __fmul_rn(e, 0.0f);
  float q = op.add(zero, 1.0f);
  q = op.fma(e, q, f32(0x417101ADu));
  q = op.fma(e, q, f32(0x42A6185Bu));
  q = op.fma(e, q, f32(0x435DC32Du));
  q = op.fma(e, q, f32(0x439A8CA3u));
  q = op.fma(e, q, f32(0x43586D8Au));
  q = op.fma(e, q, f32(0x42707982u));
  float p = op.add(zero, f32(0x383DE04Bu));
  p = op.fma(e, p, f32(0x3EFF40C5u));
  p = op.fma(e, p, f32(0x40D284FAu));
  p = op.fma(e, p, f32(0x41EF4B9Cu));
  p = op.fma(e, p, f32(0x4273CC76u));
  p = op.fma(e, p, f32(0x426473ADu));
  p = op.fma(e, p, f32(0x41A05101u));
  const float sq = op.mul(e, e);
  return op.add(e, op.fma(-0.5f, sq, op.mul(op.mul(sq, e), __fdiv_rn(p, q))));
}

template <class Ops>
__device__ __forceinline__ float softplus_one(float xv, Ops& op) {
  const float x = daz(xv);
  const float out = op.add(x > 0.0f ? x : 0.0f, xla_log1p(xla_exp(-fabsf(x), op), op));
  return xv != xv ? xv : out;
}

__device__ __forceinline__ float pos_inf_as_zero(float v) { return v == __int_as_float(0x7F800000) ? 0.0f : v; }

template <class Ops>
__device__ __forceinline__ float softplus_grad_one(float x, float out, float g, Ops& op) {
  const float d = op.add(pos_inf_as_zero(daz(x)), -pos_inf_as_zero(out));
  return op.mul(daz(g), xla_exp(d, op));
}

// The forward's element: softplus of x (`o` and `g` unread).
struct Forward {
  static constexpr bool kGrad = false;
  template <class Ops>
  __device__ __forceinline__ float operator()(float x, float, float, Ops& op) const {
    return softplus_one(x, op);
  }
};

// The backward's: the grad at x, whose softplus is o, applied to g.
struct Backward {
  static constexpr bool kGrad = true;
  template <class Ops>
  __device__ __forceinline__ float operator()(float x, float o, float g, Ops& op) const {
    return softplus_grad_one(x, o, g, op);
  }
};

// Tile t covers row t / tiles_per_row, columns from (t % tiles_per_row) * kThreads, one
// element a thread: x's at x + r * sx + c (and the backward's o and g likewise); with
// `flagged`, each CTA adds its count of elements that took the CPU's ops.
template <class F>
__global__ void __launch_bounds__(kThreads)
    softplus_kernel(const float* __restrict__ x, long long sx, const float* __restrict__ o, long long so,
                    const float* __restrict__ g, long long sg, float* __restrict__ out, int cols,
                    int tiles_per_row, long long tiles, unsigned long long* __restrict__ flagged, F f) {
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r = t / tiles_per_row;
    const int c = static_cast<int>(t - r * tiles_per_row) * kThreads + threadIdx.x;
    bool slow = false;
    if (c < cols) {
      const float xv = x[r * sx + c];
      const float ov = F::kGrad ? o[r * so + c] : 0.0f;
      const float gv = F::kGrad ? g[r * sg + c] : 0.0f;
      Fast fast;
      float v = f(xv, ov, gv, fast);
      slow = fast.tiny;
      if (slow) {
        Cpu cpu;
        v = f(xv, ov, gv, cpu);
      }
      out[r * cols + c] = v;
    }
    if (flagged != nullptr) {  // the same for every thread of the grid
      const int n = __syncthreads_count(slow);
      if (threadIdx.x == 0 && n > 0) atomicAdd(flagged, static_cast<unsigned long long>(n));
    }
  }
}

// The kernel over rows x cols; a row past 32-bit columns (kMaxCols) in pieces, one
// launch each, as one row.
template <class F>
int launch(const void* x, long long sx, const void* o, long long so, const void* g, long long sg, void* out,
           long long rows, long long cols, void* flagged, void* stream, F f) {
  auto s = static_cast<cudaStream_t>(stream);
  auto count = static_cast<unsigned long long*>(flagged);
  auto at = [](const void* p, long long off) { return p == nullptr ? nullptr : static_cast<const float*>(p) + off; };
  auto one = [&](long long nr, long long nc, long long r, long long c) {
    const long long tiles_per_row = (nc + kThreads - 1) / kThreads;
    const long long tiles = nr * tiles_per_row;
    const unsigned grid = static_cast<unsigned>(tiles < kMaxGrid ? tiles : kMaxGrid);
    softplus_kernel<F><<<grid, kThreads, 0, s>>>(at(x, r * sx + c), sx, at(o, r * so + c), so, at(g, r * sg + c),
                                                 sg, static_cast<float*>(out) + r * cols + c, static_cast<int>(nc),
                                                 static_cast<int>(tiles_per_row), tiles, count, f);
  };
  if (cols <= kMaxCols) {
    one(rows, cols, 0, 0);
    return static_cast<int>(cudaGetLastError());
  }
  for (long long r = 0; r < rows; ++r) {
    for (long long c = 0; c < cols; c += kMaxCols) {
      one(1, cols - c < kMaxCols ? cols - c : kMaxCols, r, c);
      const int err = static_cast<int>(cudaGetLastError());
      if (err) return err;
    }
  }
  return 0;
}

__global__ void empty_kernel() {}

}  // namespace

// x: rows of cols f32 elements, row r at x + r * sx (sx >= cols where rows > 1); out dense.
// `flagged`, where not null, gains the count of elements that took the CPU's ops.
extern "C" int softplus_fwd_launch(const void* x, long long sx, void* out, long long rows, long long cols,
                                   void* flagged, void* stream) {
  if (rows < 1 || cols < 1 || (rows > 1 && sx < cols)) return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, sx, nullptr, 0, nullptr, 0, out, rows, cols, flagged, stream, Forward{});
}

// As softplus_fwd_launch, with out's rows at o + r * so and g's at g + r * sg.
extern "C" int softplus_bwd_launch(const void* x, long long sx, const void* o, long long so, const void* g,
                                   long long sg, void* dx, long long rows, long long cols, void* flagged,
                                   void* stream) {
  if (rows < 1 || cols < 1 || (rows > 1 && (sx < cols || so < cols || sg < cols)) || o == nullptr || g == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch(x, sx, o, so, g, sg, dx, rows, cols, flagged, stream, Backward{});
}

// An empty kernel on `blocks` CTAs of `threads`: the floor under a launch that small.
extern "C" int empty_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
