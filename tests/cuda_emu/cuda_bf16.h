// The bf16 types of `csrc/silu.cu`, for compiling the port's CUDA sources as
// plain C++20 on a machine without a card (tests/test_torch_emulated.py): a
// bf16 is the upper half of a float's bits, rounded to nearest even (a NaN
// kept quiet); a bf16x2 two of them, x in the low half.  `__hfma2` rounds
// each lane's a * b + c once, as the card's `fma.rn.bf16x2` does (a NaN
// comes out as the canonical 0x7FFF).  The float intrinsics are in
// cuda_runtime.h.
#pragma once

#include <math.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = static_cast<uint32_t>(v.bits) << 16;
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof u);
  if (std::isnan(f)) return {static_cast<uint16_t>((u >> 16) | 0x40)};
  u += 0x7FFF + ((u >> 16) & 1);
  return {static_cast<uint16_t>(u >> 16)};
}


inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 v) { return v.bits; }
inline __nv_bfloat16 __ushort_as_bfloat16(unsigned short v) { return {v}; }

struct alignas(4) __nv_bfloat162 {
  __nv_bfloat16 x, y;
};

// `v` rounded once to bf16, to nearest even: v as an integer count of the quantum of
// its binade (2^-133 at the least, bf16's subnormal spacing), then back.
inline __nv_bfloat16 emu_bf16_of_double(double v) {
  if (std::isnan(v)) return {0x7FFF};
  if (v == 0 || std::isinf(v)) return __float2bfloat16_rn(static_cast<float>(v));
  int k;
  std::frexp(v, &k);  // |v| in [2^(k-1), 2^k)
  const double q = std::ldexp(1.0, std::max(k - 1, -126) - 7);
  const double r = std::nearbyint(v / q) * q;  // exact: at most 9 significant bits
  return __float2bfloat16_rn(static_cast<float>(r));  // 2^128 and past become inf
}

// One lane: the exact a * b (16 bits at most) plus c, rounded once to double (exact
// for every product and sum of bf16 values that the kernels compute), then to bf16.
inline __nv_bfloat16 emu_fma_bf16(__nv_bfloat16 a, __nv_bfloat16 b, __nv_bfloat16 c) {
  return emu_bf16_of_double(std::fma(static_cast<double>(__bfloat162float(a)),
                                     static_cast<double>(__bfloat162float(b)),
                                     static_cast<double>(__bfloat162float(c))));
}

inline __nv_bfloat162 __hfma2(__nv_bfloat162 a, __nv_bfloat162 b, __nv_bfloat162 c) {
  return {emu_fma_bf16(a.x, b.x, c.x), emu_fma_bf16(a.y, b.y, c.y)};
}
