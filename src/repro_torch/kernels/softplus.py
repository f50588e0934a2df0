"""softplus and its gradient rounded as the reference's CPU rounds them, on the H100.

The JAX package's SSD mixer calls `jax.nn.softplus` on f32 (`dt + dt_bias`,
`src/repro/models/ssm.py:224`, :263).  It is `jnp.logaddexp(x, 0)`:
``select(isnan(x), x, max(x, 0) + log1p(exp(-|x|)))``, and its `jax.grad`
is ``g * exp(ri(x) - ri(out))``, where `ri` replaces +inf by 0.  XLA's CPU
writes `exp` and `log1p` out as polynomials (a Cephes-style `expf`: the
argument clamped to [-87.8, 88.8], ``n = floor(x * log2(e) + 1/2)`` clamped
to [-127, 127], a two-constant reduction, a degree-5 polynomial, the power
2^n built in the exponent bits, so that 2^-127 is 0; `log1p(e)` as
``e + (-e^2 / 2 + e^3 * P(e) / Q(e))`` below |e| < 0.41421357, else a
Cephes `logf` of 1 + e).  LLVM fuses many of their products with the
following add into one FMA, and the CPU runs with denormals read as zero
and results flushed to zero.  Neither torch's `logaddexp` nor any other
composition of torch's math calls rounds the same: it differs in ~7% of
forward values and ~65% of grads on a normal grid.

`softplus_fwd(x)` and `softplus_bwd(x, out, g)` launch the kernels of
`csrc/softplus.cu` on CUDA tensors (f32), and run the plain versions on CPU
(and meta) tensors.  The plain versions repeat XLA's machine code op by op
with nothing but IEEE adds, multiplies, divides, compares, selects and
integer bit operations, so they give the same bits on the CPU and on the
card: a fused multiply-add is its exact product in f64 plus the addend,
rounded to odd in f64 and then to nearest in f32 (one rounding, as an FMA
rounds), and every product or FMA that can underflow is flushed as the CPU
flushes it (zero where the result rounded to 24 bits is below 2^-126).  The
grad's NaN outputs carry no particular payload.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.silu import _rows

#: Kernel launches made by `softplus_fwd` and `softplus_bwd`; the plain versions add nothing.
LAUNCHES = {"softplus_fwd": 0, "softplus_bwd": 0}

F32, F64 = torch.float32, torch.float64


def _bits(*hexes: int) -> tuple:
    """f32 constants from their bit patterns, as XLA's code holds them."""
    return tuple(float(np.array(h, dtype=np.uint32).view(np.float32)) for h in hexes)


EXP_LO, EXP_HI, LOG2E, LN2_HI, LN2_LO = _bits(0xC2AF999A, 0x42B1999A, 0x3FB8AA3B, 0x3F318000, 0xB95E8083)
EXP_P = _bits(0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA)
SQRT_HALF, LOG1P_SMALL = _bits(0x3F3504F3, 0x3ED413CD)
LOG_A = _bits(0x3D9021BB, 0xBDEBD1B8, 0x3DEF251A)
LOG_B = _bits(0xBDFE5D4F, 0x3E11E9BF, 0xBE2AAE50)
LOG_C = _bits(0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
LOG1P_Q = _bits(0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982)
LOG1P_P = _bits(0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD, 0x41A05101)
MIN_NORMAL = float(np.finfo(np.float32).tiny)
#: The least |v| whose rounding to 24 bits (exponent unbounded) is 2^-126 or more:
#: a product or FMA result below it is flushed.
TINY = 2.0**-126 - 2.0**-151


# ---------------------------------------------------------------------------
# the CPU's arithmetic, op by op
# ---------------------------------------------------------------------------


def _daz(v: torch.Tensor) -> torch.Tensor:
    """A subnormal operand as a zero of its sign (denormals read as zero)."""
    return torch.where(v.abs() < MIN_NORMAL, v * 0, v)


def _round(s: torch.Tensor) -> torch.Tensor:
    """f64 `s`, the result of one op held to at least 26 bits, as the f32
    result with flush to zero."""
    return torch.where(s.abs() < TINY, (s * 0).to(F32), s.to(F32))


def _mul(a, b) -> torch.Tensor:
    """a * b in f32 (the product of two f32 values is exact in f64)."""
    return _round(torch.as_tensor(a, dtype=F64) * torch.as_tensor(b, dtype=F64))


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c with one rounding: the exact product plus c in f64, rounded
    to odd (a result that is not exact keeps an odd last bit, so that the
    rounding to f32 after it is the one rounding of the exact value)."""
    p = torch.as_tensor(a, dtype=F64) * torch.as_tensor(b, dtype=F64)
    c = torch.as_tensor(c, dtype=F64)
    s = p + c
    pp = s - c
    err = (p - pp) + (c - (s - pp))  # TwoSum: s + err == p + c exactly
    bits = s.view(torch.int64)
    inexact = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    away = (err > 0) == (s > 0)  # the exact value lies beyond s, away from zero
    bits = torch.where(inexact, bits + torch.where(away, 1, -1), bits)
    return _round(bits.view(F64))


def _add(a, b) -> torch.Tensor:
    """a + b in f32; a sum that is subnormal is exact, and flushed."""
    s = a + b
    return torch.where(s.abs() < MIN_NORMAL, s * 0, s)


def _exp(v: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `exp` of f32 `v` (operands already read as by the CPU)."""
    v = torch.where(v < EXP_LO, EXP_LO, v)
    v = torch.where(v > EXP_HI, EXP_HI, v)
    n = torch.floor(_fma(v, LOG2E, 0.5))
    n = torch.where(n < -127, -127.0, n)
    n = torch.where(n > 127, 127.0, n)
    r = _fma(-n, LN2_HI, v)
    r = _fma(-n, LN2_LO, r)
    p = _fma(r, EXP_P[0], EXP_P[1])
    for k in (*EXP_P[2:], 0.5):
        p = _fma(p, r, k)
    e = _add(_fma(p, _mul(r, r), r), 1.0)
    n_int = torch.where(torch.isnan(n), 0.0, n).to(torch.int32)
    scale = ((n_int << 23) + 0x3F800000).view(F32)  # 2^n; 2^-127 comes out as 0
    return _mul(e, scale)


def _log(u: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `log` of f32 `u`, for u in [1, 2] (its special cases for
    u <= 0 and u = inf never arise here; NaN is handled by the caller)."""
    u = torch.where(u > MIN_NORMAL, u, MIN_NORMAL)
    bits = u.view(torch.int32)
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(F32)
    small = m < SQRT_HALF
    x = _add(_add(m, -1.0), torch.where(small, m, 0.0))
    e = _add(((bits >> 23) - 127).to(F32), 1.0)
    e = torch.where(small, _add(e, -1.0), e)
    z = _mul(x, x)
    x3 = _mul(z, x)
    a = _fma(x, _fma(x, LOG_A[0], LOG_A[1]), LOG_A[2])
    b = _fma(x, _fma(x, LOG_B[0], LOG_B[1]), LOG_B[2])
    c = _fma(x, _fma(x, LOG_C[0], LOG_C[1]), LOG_C[2])
    y = _fma(x3, _fma(x3, _fma(x3, a, b), c), _mul(e, LN2_LO))
    return _fma(e, LN2_HI, _add(_fma(-0.5, z, x), y))


def _log1p(e: torch.Tensor) -> torch.Tensor:
    """XLA's CPU `log1p` of f32 `e` in [0, 1]."""
    zero = e * 0.0
    q = _add(zero, 1.0)
    for k in LOG1P_Q:
        q = _fma(e, q, k)
    p = _add(zero, LOG1P_P[0])
    for k in LOG1P_P[1:]:
        p = _fma(e, p, k)
    sq = _mul(e, e)
    near = _add(e, _fma(-0.5, sq, _mul(_mul(sq, e), p / q)))
    return torch.where(e.abs() < LOG1P_SMALL, near, _log(_add(e, 1.0)))


def _pos_inf_as_zero(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v == float("inf"), 0.0, v)


def softplus_fwd_plain(x: torch.Tensor) -> torch.Tensor:
    """`softplus_fwd`'s plain version, on any device."""
    v = _daz(x)
    out = _add(torch.where(v > 0, v, 0.0), _log1p(_exp(-v.abs())))
    return torch.where(torch.isnan(x), x, out)


def softplus_bwd_plain(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """`softplus_bwd`'s plain version: ``g * exp(ri(x) - ri(out))``, `out`
    softplus(x)."""
    d = _add(_pos_inf_as_zero(_daz(x)), -_pos_inf_as_zero(out))
    return _mul(_daz(g), _exp(d))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(name: str, t, like: torch.Tensor | None = None) -> None:
    """Raises unless `t` is an f32 tensor like `like`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.dtype != F32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if like is not None and (t.device != like.device or t.shape != like.shape):
        raise ValueError(f"{name} is {tuple(t.shape)} on {t.device}, expected {tuple(like.shape)} on {like.device}")


def _on_card(x: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU one and a meta one (the
    dry-run's shapes), which take the plain versions."""
    if x.is_cuda:
        return True
    if x.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"softplus runs on CUDA, CPU or meta tensors, not {x.device}")


def _layout(t: torch.Tensor):
    """(t, rows, cols, row stride) for a launch over `t`: one row where it
    is contiguous, else rows of its last dim's unit-stride elements, else
    a contiguous copy."""
    if not t.is_contiguous():
        rows = _rows(t)
        if rows is not None:
            return t, rows[0], t.shape[-1], rows[1]
        t = t.contiguous()
    return t, 1, t.numel(), t.numel()


def _like_rows(t: torch.Tensor, rows: int, cols: int):
    """(t, row stride) with `t` read as `rows` rows of `cols` elements."""
    if rows > 1:
        got = _rows(t)
        if got is not None and got[0] == rows:
            return t, got[1]
    return t.contiguous(), cols if rows > 1 else t.numel()


def _check_flagged(flagged: torch.Tensor | None, x: torch.Tensor) -> None:
    """Raises unless `flagged` is None or one int64 on x's card."""
    if flagged is not None and (flagged.dtype != torch.int64 or flagged.device != x.device or flagged.numel() != 1):
        raise ValueError(f"flagged must be one int64 on {x.device}, got {flagged.dtype} {tuple(flagged.shape)} "
                         f"on {flagged.device}")


def softplus_fwd(x: torch.Tensor, flagged: torch.Tensor | None = None) -> torch.Tensor:
    """softplus(x) as the reference's CPU rounds it, into a fresh dense
    tensor.  On the card, `flagged` (one int64 on x's card) gains the count
    of elements that the kernel computed again by the CPU's ops."""
    _check("x", x)
    if not _on_card(x):
        return softplus_fwd_plain(x)
    _check_flagged(flagged, x)
    out = torch.empty(x.shape, dtype=F32, device=x.device)
    if x.numel() == 0:
        return out
    x, rows, cols, sx = _layout(x)
    index = x.get_device()
    with _build.on_device(index):
        err = _build.load().softplus_fwd_launch(x.data_ptr(), sx, out.data_ptr(), rows, cols,
                                                None if flagged is None else flagged.data_ptr(),
                                                _build.stream_handle(index))
    _build.check(err, "softplus_fwd")
    LAUNCHES["softplus_fwd"] += 1
    return out


def softplus_bwd(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
                 flagged: torch.Tensor | None = None) -> torch.Tensor:
    """The grad of softplus at `x` (whose softplus is `out`) applied to `g`,
    as `jax.grad` rounds it on the CPU, into a fresh dense tensor.  On the
    card, `flagged` as for `softplus_fwd`."""
    _check("x", x)
    _check("out", out, x)
    _check("g", g, x)
    if not _on_card(x):
        return softplus_bwd_plain(x, out, g)
    _check_flagged(flagged, x)
    dx = torch.empty(x.shape, dtype=F32, device=x.device)
    if x.numel() == 0:
        return dx
    x, rows, cols, sx = _layout(x)
    (out, so), (g, sg) = _like_rows(out, rows, cols), _like_rows(g, rows, cols)
    lib = _build.load()
    with _build.on_device(x.device):
        err = lib.softplus_bwd_launch(x.data_ptr(), sx, out.data_ptr(), so, g.data_ptr(), sg, dx.data_ptr(),
                                      rows, cols, None if flagged is None else flagged.data_ptr(),
                                      _build.stream_handle(x.device))
    _build.check(err, "softplus_bwd")
    LAUNCHES["softplus_bwd"] += 1
    return dx


class Softplus(torch.autograd.Function):
    """softplus with the reference's rounding forward and backward."""

    @staticmethod
    def forward(ctx, x):
        out = softplus_fwd(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return softplus_bwd(x, out, g)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """`jax.nn.softplus(x)` for f32 `x`, rounded as the reference rounds it;
    differentiable, through `softplus_bwd`."""
    if torch.is_grad_enabled() and x.requires_grad:
        return Softplus.apply(x)
    return softplus_fwd(x)
