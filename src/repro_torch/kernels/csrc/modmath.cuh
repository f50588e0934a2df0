// uint32 modular arithmetic shared by the NTT and modmul kernels.
//
// Device counterpart of the uint32 ops in `repro/core/modmath.py`
// (`addmod_u32`, `submod_u32`, `shoup_mulmod_u32`, `mont_mul_u32`,
// `mulmod_u32`).  The TPU version emulates the 32x32->64 product with
// 16-bit limbs; here the high word comes from `__umulhi`.  The int64 twins
// in `repro_torch/core/modmath.py` follow these formulas line for line.
//
// All residues are in [0, q) with q < 2^31, so a + b never wraps and the
// Shoup remainder's [0, 2q) range fits in 32 bits.
#pragma once

#include <cstdint>

namespace repro_torch {

// x in [0, 2q) -> x mod q.  x - q wraps above x when x < q, so the unsigned
// minimum picks the reduced value: two instructions, no compare and select.
__device__ __forceinline__ uint32_t reduce_once(uint32_t x, uint32_t q) { return min(x, x - q); }

__device__ __forceinline__ uint32_t addmod(uint32_t a, uint32_t b, uint32_t q) {
  return reduce_once(a + b, q);
}

__device__ __forceinline__ uint32_t submod(uint32_t a, uint32_t b, uint32_t q) {
  return reduce_once(a + q - b, q);
}

// a * w mod q with w_sh = floor(w * 2^32 / q): quotient estimate from the
// high word, remainder from the wrapping low words, one conditional subtract.
__device__ __forceinline__ uint32_t shoup_mulmod(uint32_t a, uint32_t w, uint32_t w_sh,
                                                 uint32_t q) {
  const uint32_t quot = __umulhi(a, w_sh);
  return reduce_once(a * w - quot * q, q);  // a*w - quot*q is in [0, 2q)
}

// Montgomery REDC(a * b) = a * b * 2^-32 mod q, qprime = -q^-1 mod 2^32.
__device__ __forceinline__ uint32_t mont_mul(uint32_t a, uint32_t b, uint32_t q,
                                             uint32_t qprime) {
  const uint32_t t_lo = a * b;
  const uint32_t t_hi = __umulhi(a, b);
  const uint32_t m = t_lo * qprime;
  const uint32_t mq_hi = __umulhi(m, q);
  // t_lo + (m*q)_lo == 0 mod 2^32 by construction; carry iff t_lo != 0.
  const uint32_t r = t_hi + mq_hi + (t_lo != 0u);  // < 2q
  return r >= q ? r - q : r;
}

// a * b mod q for two variables: REDC(REDC(a*b) * R^2), r2 = 2^64 mod q.
__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t b, uint32_t q, uint32_t qprime,
                                           uint32_t r2) {
  return mont_mul(mont_mul(a, b, q, qprime), r2, q, qprime);
}

// Cooley-Tukey (gs = false): (u + w v, u - w v).
// Gentleman-Sande (gs = true): (u + v, (u - v) w).
__device__ __forceinline__ void butterfly(uint32_t& u, uint32_t& v, uint32_t w, uint32_t w_sh,
                                          uint32_t q, bool gs) {
  if (gs) {
    const uint32_t s = addmod(u, v, q);
    v = shoup_mulmod(submod(u, v, q), w, w_sh, q);
    u = s;
  } else {
    const uint32_t wv = shoup_mulmod(v, w, w_sh, q);
    const uint32_t s = addmod(u, wv, q);
    v = submod(u, wv, q);
    u = s;
  }
}

}  // namespace repro_torch
