"""Modular arithmetic for NTT: host-side (python int / numpy int64) helpers
and int64 torch twins of the uint32 device arithmetic the CUDA kernels run.

The host side is a copy of `repro.core.modmath` (that module imports
`jax.numpy` at its top, so the port cannot import it).

The device side of the port is CUDA C++ (`kernels/csrc/modmath.cuh`).  The
`*_u32` functions here are its plain torch twins: they take int64 tensors
holding uint32 values, follow the same formulas (Shoup quotient from the
high word, Montgomery REDC with a carry word) and mask with `& 0xFFFFFFFF`
wherever uint32 arithmetic wraps.  torch's uint32 has no `+`, `>>` or `>=`,
so every twin works in int64 and converts at the boundary
(`as_i64` / `to_u32`).

Conventions: all residues are in [0, q), q < 2^31 so that a+b never wraps
uint32 and Shoup reduction's 2q intermediate fits.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Host-side: primes, roots of unity, parameter precomputation (python ints)
# ---------------------------------------------------------------------------

#: Default 31-bit NTT-friendly prime: 15 * 2^27 + 1 (supports N | 2^27).
DEFAULT_Q = 2013265921
#: A generator of (Z/DEFAULT_Q)^*.
DEFAULT_GENERATOR = 31

_SMALL_PRIMES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit)."""
    if n < 2:
        return False
    for p in _SMALL_PRIMES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _SMALL_PRIMES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_ntt_prime(two_n: int, bits: int = 31) -> int:
    """Smallest prime q < 2^bits with q ≡ 1 (mod two_n), searching downward."""
    if two_n & (two_n - 1):
        raise ValueError("two_n must be a power of two")
    q = ((1 << bits) - 1) // two_n * two_n + 1
    while q > two_n:
        if is_prime(q):
            return q
        q -= two_n
    raise ValueError(f"no NTT prime below 2^{bits} for order {two_n}")


def primitive_root(q: int) -> int:
    """Smallest primitive root modulo prime q."""
    factors = []
    phi = q - 1
    m = phi
    d = 2
    while d * d <= m:
        if m % d == 0:
            factors.append(d)
            while m % d == 0:
                m //= d
        d += 1
    if m > 1:
        factors.append(m)
    for g in range(2, q):
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
    raise ValueError("no primitive root (q not prime?)")


@functools.lru_cache(maxsize=None)
def root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod prime q (requires order | q-1)."""
    if (q - 1) % order:
        raise ValueError(f"{order} does not divide q-1={q - 1}")
    g = primitive_root(q)
    w = pow(g, (q - 1) // order, q)
    if pow(w, order, q) != 1 or pow(w, order // 2, q) == 1:
        raise ValueError(f"no primitive {order}-th root of unity mod {q}")
    return w


def inv_mod(a: int, q: int) -> int:
    """a^-1 mod q for any modulus with gcd(a, q) == 1 (extended Euclid)."""
    return pow(a, -1, q)


def shoup(w: int, q: int) -> int:
    """Shoup precomputed companion: floor(w * 2^32 / q).  Requires w < q < 2^31."""
    return (w << 32) // q


def mont_params(q: int):
    """Montgomery parameters for R = 2^32: (qprime = -q^-1 mod 2^32, R mod q, R^2 mod q)."""
    qprime = (-inv_mod(q, 1 << 32)) % (1 << 32)
    r_mod_q = (1 << 32) % q
    r2_mod_q = (1 << 64) % q
    return qprime, r_mod_q, r2_mod_q


# ---------------------------------------------------------------------------
# Host-side vectorized oracle ops (numpy, int64 intermediates are exact
# because q < 2^31 => products < 2^62)
# ---------------------------------------------------------------------------


def np_mulmod(a, b, q: int):
    return (np.asarray(a, np.int64) * np.asarray(b, np.int64)) % q


def np_addmod(a, b, q: int):
    return (np.asarray(a, np.int64) + np.asarray(b, np.int64)) % q


def np_submod(a, b, q: int):
    return (np.asarray(a, np.int64) - np.asarray(b, np.int64)) % q


def np_powmod(base: int, exps, q: int):
    exps = np.asarray(exps, np.int64)
    out = np.empty_like(exps)
    flat = exps.reshape(-1)
    res = out.reshape(-1)
    for i, e in enumerate(flat):  # host-side precompute only; not perf critical
        res[i] = pow(int(base), int(e), q)
    return out


def powers_of(w: int, n: int, q: int) -> np.ndarray:
    """[w^0, w^1, ..., w^(n-1)] mod q as uint32."""
    out = np.empty(n, np.uint32)
    acc = 1
    for i in range(n):
        out[i] = acc
        acc = acc * w % q
    return out


def bit_reverse_indices(n: int) -> np.ndarray:
    """Permutation p with p[i] = bit-reversal of i in log2(n) bits."""
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


# ---------------------------------------------------------------------------
# uint32 tensors <-> int64 working values, numpy <-> device
# ---------------------------------------------------------------------------

MASK32 = 0xFFFFFFFF
_U16 = 0xFFFF


def as_i64(x: torch.Tensor) -> torch.Tensor:
    """uint32 tensor -> int64 tensor of the same values in [0, 2^32).

    Goes through the int32 view, whose conversion to int64 every device
    has; the mask undoes the sign extension of words >= 2^31.
    """
    if x.dtype == torch.int64:
        return x
    if x.dtype != torch.uint32:
        raise TypeError(f"expected a uint32 or int64 tensor, got {x.dtype}")
    return x.view(torch.int32).to(torch.int64) & MASK32


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor with values in [0, 2^32) -> uint32 tensor."""
    wrapped = torch.where(x >= (1 << 31), x - (1 << 32), x)
    return wrapped.to(torch.int32).view(torch.uint32)


def to_device_u32(a, device) -> torch.Tensor:
    """numpy array -> contiguous uint32 tensor on `device` (copied through
    the int32 view, which every device can copy)."""
    arr = np.ascontiguousarray(a, np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(device).view(torch.uint32)


def to_numpy_u32(x: torch.Tensor) -> np.ndarray:
    """uint32 tensor on any device -> numpy uint32 array."""
    return x.view(torch.int32).cpu().numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# int64 twins of the uint32 device arithmetic (kernels/csrc/modmath.cuh).
# Arguments are int64 tensors (or python ints) holding uint32 values.
# ---------------------------------------------------------------------------


def mulhi_u32(a, b):
    """High 32 bits of the 64-bit product, as CUDA's `__umulhi`.

    Exact in int64 for any uint32 a, b: with a = a_hi*2^16 + a_lo,
    (a*b) >> 32 = (a_hi*b + ((a_lo*b) >> 16)) >> 16, every term < 2^49.
    """
    a_lo, a_hi = a & _U16, a >> 16
    return (a_hi * b + ((a_lo * b) >> 16)) >> 16


def mullo_u32(a, b):
    """Low 32 bits of the product (uint32 multiply wraps); terms < 2^49."""
    a_lo, a_hi = a & _U16, a >> 16
    return (a_lo * b + ((a_hi * (b & _U16)) << 16)) & MASK32


def addmod_u32(a, b, q):
    """(a + b) mod q for a,b in [0,q), q < 2^31."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def submod_u32(a, b, q):
    """(a - b) mod q for a,b in [0,q)."""
    d = a + q - b
    return torch.where(d >= q, d - q, d)


def shoup_mulmod_u32(a, w, w_shoup, q):
    """a * w mod q with precomputed w_shoup = floor(w*2^32/q).

    One mulhi (the approximate quotient), two mullo, one conditional
    subtract: the twiddle multiplication of every butterfly.
    """
    quot = mulhi_u32(a, w_shoup)
    r = (mullo_u32(a, w) - mullo_u32(quot, q)) & MASK32  # in [0, 2q)
    return torch.where(r >= q, r - q, r)


def mont_mul_u32(a, b, q, qprime):
    """Montgomery product REDC(a*b): returns a*b*2^-32 mod q, inputs in [0,q)."""
    t_lo = mullo_u32(a, b)
    t_hi = mulhi_u32(a, b)
    m = mullo_u32(t_lo, qprime)
    mq_hi = mulhi_u32(m, q)
    # t_lo + (m*q)_lo == 0 mod 2^32 by construction; carry iff t_lo != 0.
    carry = (t_lo != 0).to(torch.int64)
    r = t_hi + mq_hi + carry  # < 2q
    return torch.where(r >= q, r - q, r)


def to_mont_u32(a, q, qprime, r2_mod_q):
    return mont_mul_u32(a, r2_mod_q, q, qprime)


def from_mont_u32(a, q, qprime):
    return mont_mul_u32(a, 1, q, qprime)


def mulmod_u32(a, b, q, qprime, r2_mod_q):
    """General a*b mod q via Montgomery round-trip (for variable x variable)."""
    return mont_mul_u32(mont_mul_u32(a, b, q, qprime), r2_mod_q, q, qprime)
