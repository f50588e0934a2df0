// The bf16 type and the float intrinsics of `csrc/silu.cu`, for compiling the
// port's CUDA sources as plain C++20 on a machine without a card
// (tests/test_torch_emulated.py): a bf16 is the upper half of a float's
// bits, rounded to nearest even (a NaN kept quiet); the *_rn operations are
// the host's IEEE float operations, which g++ does not contract on x86-64
// without -mfma.
#pragma once

#include <math.h>

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

inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __frcp_rn(float a) { return 1.0f / a; }
