"""SiLU and its gradient rounded as the reference rounds them, on the H100.

The JAX package's `jax.nn.silu` is ``x * logistic(x)``, which XLA computes as
five ops (negate, exp, add 1, divide 1 by it, multiply by x), each rounded
to the operand's dtype; its `jax.grad` is ``d = logistic(a); e = 1 - d;
c = d * e; j = a * h; k = h * d; l = j * c; grad = k + l``, each op rounded
too.  On the CPU, where the tests compare the packages, XLA also flushes
subnormals: an operand that is subnormal reads as a zero of its sign, and a
result that is subnormal in f32 becomes one before it is rounded.
`torch.nn.functional.silu` rounds once, so on bf16 it differs from the
reference in many elements, and over the Mamba mixer's layers that compounds.

`silu_fwd(a)` and `silu_bwd(a, h)` launch `silu_fwd` / `silu_bwd`
(`csrc/silu.cu`) on a CUDA tensor, bf16 or f32, and run the plain versions
on a CPU tensor (and a meta one, for shapes): the same ops in torch, each
computed in f32, flushed and rounded to the input's dtype.  The kernel reads a tensor where it lies when
its elements fill their memory (contiguous, or permuted as an einsum's
output, whose strides the output takes) or when it is rows of unit-stride
elements (a column slice of a projection); any other layout is copied
first.  The output is dense.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels import _build

#: Kernel launches made by `silu_fwd` and `silu_bwd`; the plain versions add nothing.
LAUNCHES = {"silu_fwd": 0, "silu_bwd": 0}

_DTYPES = {torch.bfloat16: 0, torch.float32: 1}
_MIN_NORMAL = torch.finfo(torch.float32).tiny


def _flush(v: torch.Tensor) -> torch.Tensor:
    """A subnormal f32 value as a zero of its sign, as XLA's CPU keeps one."""
    return torch.where(v.abs() < _MIN_NORMAL, v * 0, v)


def _keep(v: torch.Tensor, dtype) -> torch.Tensor:
    """One op's f32 result as the reference keeps it: flushed and rounded to `dtype`."""
    return _flush(v).to(dtype).float()


def _exp(v: torch.Tensor) -> torch.Tensor:
    """exp of f32 `v`: torch's on the card (CUDA's `expf`, as the kernels');
    on the CPU numpy's in f64, rounded to f32.  Torch's CPU exp (MKL's
    vector exp, split over OpenMP workers) has given another value for the
    same input on a process's first call."""
    if v.device.type != "cpu":
        return torch.exp(v)
    with np.errstate(over="ignore", invalid="ignore"):
        return torch.from_numpy(np.exp(v.detach().numpy().astype(np.float64)).astype(np.float32))


def _logistic(a32: torch.Tensor, dtype) -> torch.Tensor:
    e = _keep(_exp(-a32), dtype)
    t = _keep(1 + e, dtype)
    return _keep(torch.reciprocal(t), dtype)


def silu_fwd_plain(a: torch.Tensor) -> torch.Tensor:
    """`silu_fwd`'s plain version: ``a * logistic(a)`` op by op, on any device."""
    x = _flush(a.float())
    return _flush(x * _logistic(x, a.dtype)).to(a.dtype)


def silu_bwd_plain(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """`silu_bwd`'s plain version: `jax.grad`'s ops for silu at `a`, applied to `h`."""
    dt = a.dtype
    x, g = _flush(a.float()), _flush(h.float())
    d = _logistic(x, dt)
    c = _keep(d * _keep(1 - d, dt), dt)
    k = _keep(g * d, dt)
    l = _keep(_keep(x * g, dt) * c, dt)
    return _flush(k + l).to(dt)


def _dense(t: torch.Tensor) -> bool:
    """Whether the elements of `t` fill t.numel() consecutive slots in some order."""
    expected = 1
    for size, stride in sorted(zip(t.shape, t.stride()), key=lambda p: p[1]):
        if size == 1:
            continue
        if stride != expected:
            return False
        expected *= size
    return True


def _rows(t: torch.Tensor):
    """`t` as rows of its last dim's unit-stride elements: (rows, row stride),
    or None where its layout has no such view (or its rows overlap)."""
    if t.dim() == 0 or (t.stride(-1) != 1 and t.shape[-1] != 1):
        return None
    lead = [(n, s) for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n != 1]
    if not lead:
        return 1, t.shape[-1]
    if any(s0 != s1 * n1 for (_, s0), (n1, s1) in zip(lead, lead[1:])) or lead[-1][1] < t.shape[-1]:
        return None
    return math.prod(n for n, _ in lead), lead[-1][1]


def _walk(a: torch.Tensor):
    """(a, dense, rows, cols, row stride, out) for a launch over `a`: rows of
    its last dim, into a dense output; else a dense `a` as one row, its
    output taking its strides; else a dense copy."""
    rows = None if a.is_contiguous() else _rows(a)
    if rows is not None:
        return a, False, rows[0], a.shape[-1], rows[1], torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if not (a.is_contiguous() or _dense(a)):
        a = a.contiguous()
    return a, True, 1, a.numel(), a.numel(), torch.empty_like(a)


def _check(name: str, t: torch.Tensor, like: torch.Tensor | None = None) -> None:
    """Raises unless `t` is a tensor (on the card, bf16 or f32) like `like`."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.is_cuda and t.dtype not in _DTYPES:
        raise TypeError(f"{name} must be bfloat16 or float32 on the card, got {t.dtype}")
    if like is not None and (t.dtype != like.dtype or t.device != like.device or t.shape != like.shape):
        raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                         f"{like.dtype} {tuple(like.shape)} on {like.device}")


def _on_card(a: torch.Tensor) -> bool:
    """True for a CUDA tensor; False for a CPU one and a meta one (the
    dry-run's shapes), which take the plain versions."""
    if a.is_cuda:
        return True
    if a.device.type in ("cpu", "meta"):
        return False
    raise ValueError(f"silu runs on CUDA, CPU or meta tensors, not {a.device}")


def silu_fwd(a: torch.Tensor) -> torch.Tensor:
    """silu(a) as the reference rounds it, into a fresh tensor."""
    _check("a", a)
    if not _on_card(a):
        return silu_fwd_plain(a)
    a, _, rows, cols, sa, y = _walk(a)
    if a.numel() == 0:
        return y
    lib = _build.load()
    with _build.on_device(a.device):
        err = lib.silu_fwd_launch(a.data_ptr(), sa, y.data_ptr(), rows, cols, _DTYPES[a.dtype],
                                  _build.stream_handle(a.device))
    _build.check(err, "silu_fwd")
    LAUNCHES["silu_fwd"] += 1
    return y


def silu_bwd(a: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """The grad of silu at `a` applied to `h` (same dtype and shape), as
    `jax.grad` rounds it, into a fresh tensor."""
    _check("a", a)
    _check("h", h, a)
    if not _on_card(a):
        return silu_bwd_plain(a, h)
    a, dense, rows, cols, sa, out = _walk(a)
    if a.numel() == 0:
        return out
    if dense:  # h read in a's order
        if h.stride() != a.stride():
            h = torch.empty_like(a).copy_(h)
        sh = sa
    else:
        hr = _rows(h)
        if hr is None:
            h = h.contiguous()
            hr = (rows, cols)
        sh = hr[1]
    lib = _build.load()
    with _build.on_device(a.device):
        err = lib.silu_bwd_launch(a.data_ptr(), sa, h.data_ptr(), sh, out.data_ptr(), rows, cols,
                                  _DTYPES[a.dtype], _build.stream_handle(a.device))
    _build.check(err, "silu_bwd")
    LAUNCHES["silu_bwd"] += 1
    return out
