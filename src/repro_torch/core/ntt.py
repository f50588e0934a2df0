"""Reference NTT algorithms (host oracles + a batched torch stage loop).

The port's copy of `repro.core.ntt`, which imports `jax.numpy` at its top.
Two flavours are provided:

* **cyclic** NTT  X[k] = sum_j a[j] w^{jk} mod q  (w a primitive N-th root)
  — matches the textbook DFT-over-Z_q and the O(N^2) oracle.

* **negacyclic** ψ-merged NTT pair (Longa–Naehrig style): forward is
  Cooley–Tukey (natural order in → bit-reversed out, strides N/2..1),
  inverse is Gentleman–Sande (bit-reversed in → natural out, strides
  1..N/2).  ``INTT(NTT(a) ⊙ NTT(b))`` is negacyclic convolution, i.e.
  multiplication in Z_q[X]/(X^N+1), with no explicit bit reversal
  anywhere (the paper's §II-B observation).

All stage loops operate on the LAST axis; leading axes are batch.

Beyond the reference module this one holds `context_from_reference`
(carries a `repro.core.ntt.NttContext` across without importing `repro`)
and `device_tables`, the per-(q, n, device) cache of the twiddle tables
as uint32 tensors, so a kernel call copies no table from the host.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import modmath as mm

# ---------------------------------------------------------------------------
# Twiddle context
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash
# (make_context is lru_cached, so equal (q, n) share one instance).
class NttContext:
    """Precomputed tables for a (q, n) negacyclic NTT.

    psi_brv[i]      = psi^brv(i)        (forward stage twiddles, slice [m:2m])
    psi_inv_brv[i]  = psi^-brv(i)       (inverse stage twiddles, slice [h:2h])
    *_shoup         = floor(w * 2^32 / q) companions for device-side Shoup mult
    """

    q: int
    n: int
    psi: int
    psi_inv: int
    n_inv: int
    psi_brv: np.ndarray
    psi_brv_shoup: np.ndarray
    psi_inv_brv: np.ndarray
    psi_inv_brv_shoup: np.ndarray
    n_inv_shoup: int
    qprime: int  # -q^-1 mod 2^32 (Montgomery)
    r2_mod_q: int  # 2^64 mod q

    @property
    def omega(self) -> int:
        return self.psi * self.psi % self.q


_TABLE_FIELDS = ("psi_brv", "psi_brv_shoup", "psi_inv_brv", "psi_inv_brv_shoup")
_INT_FIELDS = ("q", "n", "psi", "psi_inv", "n_inv", "n_inv_shoup", "qprime", "r2_mod_q")


@functools.lru_cache(maxsize=None)
def make_context(q: int, n: int) -> NttContext:
    if n & (n - 1):
        raise ValueError("n must be a power of two")
    psi = mm.root_of_unity(q, 2 * n)
    psi_inv = mm.inv_mod(psi, q)
    n_inv = mm.inv_mod(n, q)
    brv = mm.bit_reverse_indices(n)
    psi_pows = mm.powers_of(psi, n, q)
    psi_inv_pows = mm.powers_of(psi_inv, n, q)
    psi_brv = psi_pows[brv].astype(np.uint32)
    psi_inv_brv = psi_inv_pows[brv].astype(np.uint32)
    sh = np.vectorize(lambda w: mm.shoup(int(w), q), otypes=[np.uint32])
    qprime, _, r2 = mm.mont_params(q)
    return NttContext(
        q=q,
        n=n,
        psi=psi,
        psi_inv=psi_inv,
        n_inv=n_inv,
        psi_brv=psi_brv,
        psi_brv_shoup=sh(psi_brv),
        psi_inv_brv=psi_inv_brv,
        psi_inv_brv_shoup=sh(psi_inv_brv),
        n_inv_shoup=mm.shoup(n_inv, q),
        qprime=qprime,
        r2_mod_q=r2,
    )


def context_from_reference(ctx) -> NttContext:
    """The port's `NttContext` from the JAX package's one.

    `ctx` is read duck-typed (python ints and numpy arrays under the
    reference's field names), so nothing of `repro` is imported.  The
    tables are copied as uint32 and checked for shape.
    """
    ints = {f: int(getattr(ctx, f)) for f in _INT_FIELDS}
    n = ints["n"]
    if n <= 0 or n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    tables = {}
    for f in _TABLE_FIELDS:
        arr = np.array(getattr(ctx, f), np.uint32)
        if arr.shape != (n,):
            raise ValueError(f"{f} has shape {arr.shape}, expected ({n},)")
        tables[f] = arr
    return NttContext(**ints, **tables)


class DeviceTables(NamedTuple):
    """A context's twiddle tables as contiguous uint32 tensors on one device."""

    psi_brv: torch.Tensor
    psi_brv_shoup: torch.Tensor
    psi_inv_brv: torch.Tensor
    psi_inv_brv_shoup: torch.Tensor

    def for_direction(self, forward: bool) -> tuple[torch.Tensor, torch.Tensor]:
        if forward:
            return self.psi_brv, self.psi_brv_shoup
        return self.psi_inv_brv, self.psi_inv_brv_shoup


_DEVICE_TABLES: dict[tuple[int, int, str], DeviceTables] = {}
_DEVICE_TABLES_LOCK = threading.Lock()


def device_tables(ctx: NttContext, device) -> DeviceTables:
    """`ctx`'s tables on `device`, copied there once per (q, n, device).

    The key is (q, n) rather than the context object: the tables are a
    function of (q, n), so a context carried across from the reference
    shares the entry of `make_context(q, n)`.
    """
    device = torch.device(device)
    key = (ctx.q, ctx.n, str(device))
    with _DEVICE_TABLES_LOCK:
        tabs = _DEVICE_TABLES.get(key)
        if tabs is None:
            tabs = _DEVICE_TABLES[key] = DeviceTables(
                *(mm.to_device_u32(getattr(ctx, f), device) for f in _TABLE_FIELDS)
            )
    return tabs


# ---------------------------------------------------------------------------
# O(N^2) oracles (numpy; small N only)
# ---------------------------------------------------------------------------


def naive_cyclic_ntt(a: np.ndarray, q: int, omega: int) -> np.ndarray:
    a = np.asarray(a, np.int64)
    n = a.shape[-1]
    jk = (np.arange(n)[:, None] * np.arange(n)[None, :]) % n
    w_pows = mm.powers_of(omega, n, q).astype(np.int64)
    mat = w_pows[jk]  # [k, j] = w^{jk}
    # Reduce each product mod q BEFORE summing (a plain matmul would
    # overflow int64 for n >= 4), then sum residues (< n * 2^31 << 2^63).
    prods = (a[..., None, :] * mat) % q  # [..., k, j]
    return np.asarray(prods.sum(axis=-1) % q, np.uint32)


def naive_negacyclic_ntt(a: np.ndarray, ctx: NttContext) -> np.ndarray:
    """X[k] = sum_j a[j] psi^j w^{jk}  (natural-order output)."""
    scaled = mm.np_mulmod(a, mm.powers_of(ctx.psi, ctx.n, ctx.q), ctx.q)
    return naive_cyclic_ntt(scaled, ctx.q, ctx.omega)


def schoolbook_negacyclic(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """a*b mod (X^N + 1) by O(N^2) schoolbook — polymul oracle."""
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    n = a.shape[-1]
    out = np.zeros(n, np.int64)
    for i in range(n):
        prod = a[i] * b % q
        wrap = n - i
        out[i:] = (out[i:] + prod[:wrap]) % q
        out[:i] = (out[:i] - prod[wrap:]) % q  # X^N = -1
    return np.asarray(out % q, np.uint32)


# ---------------------------------------------------------------------------
# Stage plans (shared by the numpy/torch loops and the CUDA kernels' plans)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Stage:
    """One butterfly stage over the last axis.

    blocks   : number of independent blocks (each has one twiddle)
    stride   : distance between butterfly partners
    tw_lo    : twiddle table slice start (table[tw_lo : tw_lo + blocks])
    gs       : True = Gentleman–Sande butterfly (a+b, (a-b)*w),
               False = Cooley–Tukey (a + w*b, a - w*b)
    """

    blocks: int
    stride: int
    tw_lo: int
    gs: bool


@functools.lru_cache(maxsize=None)
def forward_stages(n: int) -> tuple[Stage, ...]:
    """CT forward, natural in -> bit-reversed out; strides N/2, N/4, ..., 1.

    Cached, as a tuple: building the frozen `Stage`s costs more host time
    than a kernel launch, and every transform reads the plan.
    """
    stages = []
    t, m = n, 1
    while m < n:
        t //= 2
        stages.append(Stage(blocks=m, stride=t, tw_lo=m, gs=False))
        m *= 2
    return tuple(stages)


@functools.lru_cache(maxsize=None)
def inverse_stages(n: int) -> tuple[Stage, ...]:
    """GS inverse, bit-reversed in -> natural out; strides 1, 2, ..., N/2.

    This is the paper's Algorithm 1/2 dataflow orientation (m increasing).
    Cached, as a tuple, like `forward_stages`.
    """
    stages = []
    t, m = 1, n
    while m > 1:
        h = m // 2
        stages.append(Stage(blocks=h, stride=t, tw_lo=h, gs=True))
        t *= 2
        m //= 2
    return tuple(stages)


def _np_stage(a: np.ndarray, stage: Stage, table: np.ndarray, q: int) -> np.ndarray:
    """Apply one stage over the last axis (numpy int64 exact)."""
    lead = a.shape[:-1]
    n = a.shape[-1]
    tw = table[stage.tw_lo : stage.tw_lo + stage.blocks].astype(np.int64)
    x = a.reshape(*lead, stage.blocks, 2, stage.stride).astype(np.int64)
    u, v = x[..., 0, :], x[..., 1, :]
    w = tw[:, None]
    if stage.gs:
        out0 = (u + v) % q
        out1 = (u - v) * w % q
    else:
        wv = v * w % q
        out0 = (u + wv) % q
        out1 = (u - wv) % q
    out = np.stack([out0, out1], axis=-2) % q
    return np.asarray(out.reshape(*lead, n), np.uint32)


def ntt_forward_np(a: np.ndarray, ctx: NttContext) -> np.ndarray:
    """Negacyclic forward NTT, natural in -> bit-reversed out."""
    x = np.asarray(a, np.uint32)
    for st in forward_stages(ctx.n):
        x = _np_stage(x, st, ctx.psi_brv, ctx.q)
    return x


def ntt_inverse_np(a: np.ndarray, ctx: NttContext) -> np.ndarray:
    """Negacyclic inverse NTT, bit-reversed in -> natural out (scaled by 1/N)."""
    x = np.asarray(a, np.uint32)
    for st in inverse_stages(ctx.n):
        x = _np_stage(x, st, ctx.psi_inv_brv, ctx.q)
    return np.asarray(mm.np_mulmod(x, ctx.n_inv, ctx.q), np.uint32)


def polymul_negacyclic_np(a, b, ctx: NttContext) -> np.ndarray:
    """a*b in Z_q[X]/(X^N+1) via eq. (1) of the paper."""
    ah = ntt_forward_np(a, ctx)
    bh = ntt_forward_np(b, ctx)
    return ntt_inverse_np(mm.np_mulmod(ah, bh, ctx.q), ctx)


# -- cyclic wrappers (match the naive DFT oracle) ---------------------------


def cyclic_ntt_np(a: np.ndarray, q: int, n: int | None = None) -> np.ndarray:
    """Cyclic NTT (natural in -> natural out); equals naive_cyclic_ntt.

    Scaling the input by psi^{-j} turns the negacyclic transform into the
    plain cyclic one; the forward pass emits bit-reversed order, which is
    undone at the end.
    """
    a = np.asarray(a, np.uint32)
    n = n or a.shape[-1]
    ctx = make_context(q, n)
    psi_inv_pows = mm.powers_of(ctx.psi_inv, n, q)
    scaled = np.asarray(mm.np_mulmod(a, psi_inv_pows, q), np.uint32)
    brv = mm.bit_reverse_indices(n)
    out = ntt_forward_np(scaled, ctx)
    inv_perm = np.argsort(brv)
    return out[..., inv_perm]


# ---------------------------------------------------------------------------
# torch batched implementation (int64 twins of the kernels' uint32
# arithmetic) — the kernels' plain versions and the torch oracle
# ---------------------------------------------------------------------------


def butterfly_torch(u, v, w, w_sh, q: int, gs: bool):
    """One CT or GS butterfly on int64 tensors, Shoup twiddle multiply."""
    if gs:
        out0 = mm.addmod_u32(u, v, q)
        out1 = mm.shoup_mulmod_u32(mm.submod_u32(u, v, q), w, w_sh, q)
    else:
        wv = mm.shoup_mulmod_u32(v, w, w_sh, q)
        out0 = mm.addmod_u32(u, wv, q)
        out1 = mm.submod_u32(u, wv, q)
    return out0, out1


def torch_stage(x, stage: Stage, w, w_sh, q: int):
    """One stage over the last axis of an int64 tensor.

    `w`/`w_sh` hold the stage's twiddles shaped to broadcast against
    (..., blocks, stride), e.g. (blocks, 1).
    """
    shape = x.shape
    xr = x.reshape(*shape[:-1], stage.blocks, 2, stage.stride)
    out0, out1 = butterfly_torch(xr[..., 0, :], xr[..., 1, :], w, w_sh, q, stage.gs)
    return torch.stack([out0, out1], dim=-2).reshape(shape)


def _run_stages(x, stages, table, table_sh, q: int):
    tw = mm.as_i64(mm.to_device_u32(table, x.device))
    tw_sh = mm.as_i64(mm.to_device_u32(table_sh, x.device))
    for st in stages:
        sl = slice(st.tw_lo, st.tw_lo + st.blocks)
        x = torch_stage(x, st, tw[sl, None], tw_sh[sl, None], q)
    return x


def ntt_forward_torch(a: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """Negacyclic forward NTT of a uint32 tensor on its own device."""
    x = _run_stages(mm.as_i64(a), forward_stages(ctx.n), ctx.psi_brv, ctx.psi_brv_shoup, ctx.q)
    return mm.to_u32(x)


def ntt_inverse_torch(a: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    """Negacyclic inverse NTT of a uint32 tensor (scaled by 1/N)."""
    x = _run_stages(
        mm.as_i64(a), inverse_stages(ctx.n), ctx.psi_inv_brv, ctx.psi_inv_brv_shoup, ctx.q
    )
    return mm.to_u32(mm.shoup_mulmod_u32(x, ctx.n_inv, ctx.n_inv_shoup, ctx.q))


def polymul_negacyclic_torch(a: torch.Tensor, b: torch.Tensor, ctx: NttContext) -> torch.Tensor:
    ah = mm.as_i64(ntt_forward_torch(a, ctx))
    bh = mm.as_i64(ntt_forward_torch(b, ctx))
    prod = mm.mulmod_u32(ah, bh, ctx.q, ctx.qprime, ctx.r2_mod_q)
    return ntt_inverse_torch(mm.to_u32(prod), ctx)


# ---------------------------------------------------------------------------
# Four-step (transpose) decomposition
# ---------------------------------------------------------------------------


def four_step_cyclic_np(a: np.ndarray, q: int, n1: int, n2: int) -> np.ndarray:
    """Cyclic NTT of size n1*n2 as: columns-NTT(n2), twiddle, rows-NTT(n1), T.

    Input read as a (n1 x n2) row-major matrix:
      X[k2*n1 + k1] = NTT1_{n1, rows->k1}( w_N^{j1*k2} * NTT2_{n2, cols j1} )
    """
    n = n1 * n2
    a = np.asarray(a, np.uint32).reshape(n1, n2)
    step1 = cyclic_ntt_np(a.T, q, n1)  # (n2, n1), rows are columns of a
    w = mm.root_of_unity(q, n)
    k1 = np.arange(n1)[None, :]
    j2 = np.arange(n2)[:, None]
    tw = mm.np_powmod(w, (k1 * j2) % n, q)
    step2 = mm.np_mulmod(step1, tw, q)
    step3 = cyclic_ntt_np(step2.T, q, n2)  # (n1, n2)
    return np.asarray(step3.T.reshape(n), np.uint32)
