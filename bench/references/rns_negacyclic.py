"""The plain reference for RNS products: per tower, a * b mod (X^N + 1, q_i).

Independent of the program: it finds each tower's roots from the modulus
alone, and multiplies through its own transform, a radix-2 cyclic NTT of
bit-reversed input wrapped by the psi twist, in int64 torch ops on the
operands' device.  Every product of two residues below 2^31 fits int64, so
the result is exact.  It imports torch, numpy and the standard library,
nothing of the program.

`precision="float64"` does every modular product in float64 instead, whose
53-bit mantissa cannot hold a 62-bit product: the benchmark's control, the
step below the configuration's exact integer arithmetic.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

PRECISIONS = ("int64", "float64")


def is_prime(q: int) -> bool:
    """Miller-Rabin with the bases 2, 7 and 61: exact below 4,759,123,141."""
    if q < 2:
        return False
    for p in (2, 3, 5, 7, 61):
        if q % p == 0:
            return q == p
    d, s = q - 1, 0
    while d % 2 == 0:
        d, s = d // 2, s + 1
    for a in (2, 7, 61):
        x = pow(a, d, q)
        if x in (1, q - 1):
            continue
        for _ in range(s - 1):
            x = x * x % q
            if x == q - 1:
                break
        else:
            return False
    return True


def _prime_factors(m: int) -> list[int]:
    out, d = [], 2
    while d * d <= m:
        if m % d == 0:
            out.append(d)
            while m % d == 0:
                m //= d
        d += 1
    return out + ([m] if m > 1 else [])


def root_2n(q: int, n: int) -> int:
    """A primitive 2n-th root of unity modulo the prime q (q = 1 mod 2n)."""
    if q >= 1 << 31 or not is_prime(q) or (q - 1) % (2 * n):
        raise ValueError(f"{q} is not a prime below 2^31 with q = 1 mod {2 * n}")
    factors = _prime_factors(q - 1)
    g = next(g for g in range(2, q) if all(pow(g, (q - 1) // f, q) != 1 for f in factors))
    psi = pow(g, (q - 1) // (2 * n), q)
    if pow(psi, n, q) != q - 1:
        raise ValueError(f"no primitive {2 * n}-th root modulo {q}")
    return psi


def _powers(bases: list[int], moduli: tuple[int, ...], count: int) -> np.ndarray:
    """[L, count] int64: row i holds bases[i]^k mod moduli[i] for k < count."""
    q = np.array(moduli, np.int64)[:, None]
    out = np.ones((len(moduli), 1), np.int64)
    step = np.array(bases, np.int64)[:, None] % q
    while out.shape[1] < count:
        out = np.concatenate([out, out * step % q], axis=1)
        step = step * step % q
    return out[:, :count]


@dataclasses.dataclass(frozen=True)
class Tables:
    q: torch.Tensor  # [L] int64
    twist: torch.Tensor  # [L, n]: psi^k
    untwist: torch.Tensor  # [L, n]: psi^-k * n^-1
    omega: torch.Tensor  # [L, n/2]: omega^k, omega = psi^2
    omega_inv: torch.Tensor  # [L, n/2]
    bitrev: torch.Tensor  # [n] int64


@functools.lru_cache(maxsize=8)
def tables(moduli: tuple[int, ...], n: int, device: str) -> Tables:
    if n < 1 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    psi = [root_2n(q, n) for q in moduli]
    psi_inv = [pow(p, -1, q) for p, q in zip(psi, moduli)]
    n_inv = np.array([pow(n, -1, q) for q in moduli], np.int64)[:, None]
    qs = np.array(moduli, np.int64)[:, None]
    bits = n.bit_length() - 1
    rev = np.array([int(f"{k:0{bits}b}"[::-1], 2) if bits else 0 for k in range(n)], np.int64)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    return Tables(
        q=put(np.array(moduli, np.int64)),
        twist=put(_powers(psi, moduli, n)),
        untwist=put(_powers(psi_inv, moduli, n) * n_inv % qs),
        omega=put(_powers([p * p % q for p, q in zip(psi, moduli)], moduli, n // 2)),
        omega_inv=put(_powers([p * p % q for p, q in zip(psi_inv, moduli)], moduli, n // 2)),
        bitrev=put(rev),
    )


def _mulmod(x: torch.Tensor, y: torch.Tensor, q: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int64":
        return x * y % q
    return torch.remainder(x.double() * y.double(), q.double()).long()


def _cyclic_ntt(x: torch.Tensor, roots: torch.Tensor, q: torch.Tensor, precision: str) -> torch.Tensor:
    """X_k = sum_j x_j w^(jk) over the last axis, for x given in bit-reversed
    order; `roots` [L, n/2] holds w^k.  Iterative radix-2, decimation in time."""
    s, towers, n = x.shape
    qq = q.view(1, towers, 1, 1)
    h = 1
    while h < n:
        x = x.reshape(s, towers, n // (2 * h), 2, h)
        tw = roots[:, :: n // (2 * h)][:, :h].reshape(1, towers, 1, h)
        u = x[:, :, :, 0]
        v = _mulmod(x[:, :, :, 1], tw, qq, precision)
        x = torch.stack(((u + v) % qq, (u - v) % qq), dim=3)
        h *= 2
    return x.reshape(s, towers, n)


def poly_mul(a: torch.Tensor, b: torch.Tensor, moduli, precision: str = "int64") -> torch.Tensor:
    """Per tower, the negacyclic product of int64 residues [S, L, n] (b may
    have one row, shared): c = a * b mod (X^n + 1, q_i), int64 [S, L, n]."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    moduli = tuple(int(q) for q in moduli)
    s, towers, n = a.shape
    if towers != len(moduli) or b.shape[-2:] != a.shape[-2:]:
        raise ValueError(f"operands {tuple(a.shape)}, {tuple(b.shape)} do not fit {len(moduli)} towers")
    t = tables(moduli, n, str(a.device))
    q = t.q.view(1, towers, 1)
    fa = _cyclic_ntt(_mulmod(a, t.twist, q, precision)[..., t.bitrev], t.omega, t.q, precision)
    fb = _cyclic_ntt(_mulmod(b, t.twist, q, precision)[..., t.bitrev], t.omega, t.q, precision)
    c = _cyclic_ntt(_mulmod(fa, fb, q, precision)[..., t.bitrev], t.omega_inv, t.q, precision)
    return _mulmod(c, t.untwist, q, precision)


def as_system(moduli, precision: str = "float64", block: int = 16):
    """The reference in the program's place: a callable with
    `poly_mul_towers`'s signature (basis, a, b) on uint32 [B, L, n]
    operands, computed in `precision`, `block` products at a time."""
    moduli = tuple(int(q) for q in moduli)

    def system(basis, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a64 = a.view(torch.int32).long()
        b64 = b.view(torch.int32).long()
        out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
        for lo in range(0, a.shape[0], block):
            sl = slice(lo, lo + block)
            rows = b64 if b64.shape[0] == 1 else b64[sl]
            out[sl] = poly_mul(a64[sl], rows, moduli, precision).to(torch.int32)
        return out.view(torch.uint32)

    return system
