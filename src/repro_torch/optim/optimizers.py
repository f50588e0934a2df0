"""Optimizers: AdamW with dtype-configurable moments and Adafactor (factored
second moment), plus the cosine schedule with linear warmup and global-norm
clipping.  The port of the JAX package's `repro/optim/optimizers.py`.

Param, grad and state trees are nested dicts and lists of tensors
(`repro_torch.tree`).  The reference's update is a pure function whose
inputs `jit` donates, so that XLA fuses its f32 temporaries away; here the
update writes params and state in place and returns them.  It walks each
leaf in slices along its leading dim (`SLICE_ELEMS` values at a time), so
that its f32 temporaries stay a few slices' worth whatever the leaf's size,
and folds the clip scale into each slice's update instead of making a
scaled copy of every grad.  The AdamW update is elementwise, so slicing
changes no value.  The schedule and the bias corrections are f32, as in
the reference; every division is between tensors on one device (a CUDA
division by a host scalar multiplies by its reciprocal instead).
"""
from __future__ import annotations

import dataclasses
import functools
import operator
from typing import Literal

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_path, tree_map

F32 = torch.float32
#: Values of a leaf that an update or norm takes at once: 2^26 (256 MiB in f32).
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class OptConfig:
    optimizer: Literal["adamw", "adafactor"] = "adamw"
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"  # "bfloat16" halves optimizer memory


def schedule(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at `step` (an int or a 0-dim tensor): a 0-dim f32
    tensor on the CPU."""
    step = torch.as_tensor(step).to("cpu", F32)
    warm = cfg.lr_peak * step / float(max(1.0, cfg.warmup_steps))
    frac = (step - cfg.warmup_steps) / float(max(1.0, cfg.total_steps - cfg.warmup_steps))
    frac = torch.clamp(frac, 0.0, 1.0)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(np.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def _slices(*ts, leading: bool = True):
    """Tuples of views of the same-shaped `ts` along dim 0, at most
    `SLICE_ELEMS` values each (at least one row); the whole tensors where
    they are smaller or `leading` is false."""
    t = ts[0]
    if not leading or t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        yield ts
        return
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    for i in range(0, t.shape[0], rows):
        yield tuple(x[i : i + rows] for x in ts)


def _scalar(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=F32).to(device)


def square_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of one leaf, in f32."""
    return sum(torch.sum(torch.square(s.to(F32))) for (s,) in _slices(x))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in f32."""
    return torch.sqrt(torch.sum(torch.stack([square_sum(x) for x in leaves(tree)])))


def _clip_scale(grads, max_norm, norm=None):
    """(the factor every grad is scaled by, the global norm): the reference's
    `_clip` without the scaled copy of the grads."""
    norm = global_norm(grads) if norm is None else norm
    return torch.clamp(_scalar(max_norm, norm.device) / (norm + 1e-9), max=1.0), norm


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params, cfg: OptConfig):
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def _adamw_leaf(g, m, v, p, scale, lr, bc1, bc2, cfg: OptConfig) -> None:
    b1, b2 = cfg.b1, cfg.b2
    decay = p.dim() >= 2  # no decay on norms/biases
    for gs, ms, vs, ps in _slices(g, m, v, p):
        g32 = gs.to(F32) * scale
        m32 = ms.to(F32).mul_(b1).add_(g32 * (1 - b1))  # ms itself when f32
        v32 = vs.to(F32).mul_(b2).add_((g32 * g32).mul_(1 - b2))
        delta = (m32 / bc1).div_((v32 / bc2).sqrt_().add_(cfg.eps))
        if decay:
            delta.add_(cfg.weight_decay * ps.to(F32))
        delta.mul_(lr)
        if ps.dtype == F32:
            ps.sub_(delta)
        else:
            ps.copy_(ps.to(F32) - delta)
        for s, s32 in ((ms, m32), (vs, v32)):
            if s is not s32:
                s.copy_(s32)


def _adamw_update(grads, state, params, step, cfg: OptConfig, norm=None):
    """One AdamW step, params and state updated in place and returned."""
    lr = schedule(cfg, step)
    t = torch.as_tensor(step).to("cpu", F32) + 1.0
    bc1 = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32), t)
    bc2 = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32), t)
    flat_p = leaves(params)
    scale, gnorm = _clip_scale(grads, cfg.grad_clip, norm)
    for g, m, v, p in zip(leaves(grads), leaves(state["m"]), leaves(state["v"]), flat_p):
        d = p.device
        _adamw_leaf(g, m, v, p, scale.to(d), lr.to(d), bc1.to(d), bc2.to(d), cfg)
    return params, state, {"lr": lr, "grad_norm": gnorm}


# ---------------------------------------------------------------------------
# Adafactor (factored second moment; memory O(rows + cols) per matrix)
# ---------------------------------------------------------------------------


def adafactor_init(params, cfg: OptConfig):
    def init(p):
        if p.dim() >= 2:
            return {
                "vr": torch.zeros(p.shape[:-1], dtype=F32, device=p.device),
                "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=F32, device=p.device),
            }
        return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}

    return {"v": tree_map(init, params)}


def _adafactor_leaf(g, v, p, scale, lr, cfg: OptConfig, mean=torch.mean) -> None:
    """`mean(x, dim, keepdim=False)`: the factored moments' mean over a dim
    of `p` (or of `vr`, whose dim -1 is `p`'s dim -2)."""
    b2 = cfg.b2
    factored = p.dim() >= 2
    state = (v["vr"], v["vc"]) if factored else (v["v"],)
    # the factored means run over the last two dims, so only a stack of
    # matrices (3 or more dims) may be sliced along dim 0
    for gs, ps, *vs in _slices(g, p, *state, leading=p.dim() >= 3):
        g32 = gs.to(F32) * scale
        g2 = (g32 * g32).add_(1e-30)
        if factored:
            vr = vs[0].mul_(b2).add_(mean(g2, -1) * (1 - b2))
            vc = vs[1].mul_(b2).add_(mean(g2, -2) * (1 - b2))
            vhat = vr[..., None] * vc[..., None, :] / (mean(vr, -1, keepdim=True)[..., None] + 1e-30)
        else:
            vhat = vs[0].mul_(b2).add_(g2.mul_(1 - b2))
        delta = g32.div_(torch.sqrt(vhat).add_(cfg.eps))
        if factored:
            delta.add_(cfg.weight_decay * ps.to(F32))
        delta.mul_(lr)
        if ps.dtype == F32:
            ps.sub_(delta)
        else:
            ps.copy_(ps.to(F32) - delta)


def _adafactor_update(grads, state, params, step, cfg: OptConfig, norm=None, means=None):
    """One Adafactor step, params and state updated in place and returned."""
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.grad_clip, norm)
    flat = leaves_with_path(params)
    for g, (path, p), mean in zip(leaves(grads), flat, means or [torch.mean] * len(flat)):
        v = functools.reduce(operator.getitem, path, state["v"])  # the leaf's {"vr", "vc"} or {"v"}
        _adafactor_leaf(g, v, p, scale.to(p.device), lr.to(p.device), cfg, mean)
    return params, state, {"lr": lr, "grad_norm": gnorm}


def make_optimizer(cfg: OptConfig):
    """Returns (init_fn(params) -> state, update_fn(grads, state, params,
    step, norm=None, means=None)).

    Where params, grads and state are each rank's shards of larger tensors
    (`launch.steps.make_sharded_train_step`), `norm` is the grads' global
    norm over every rank and `means` gives, per param leaf in `leaves`
    order, the mean over a dim of the whole tensor (Adafactor's factored
    moments; AdamW is elementwise and takes none)."""
    if cfg.optimizer == "adamw":
        return (lambda p: adamw_init(p, cfg)), (
            lambda g, s, p, t, norm=None, means=None: _adamw_update(g, s, p, t, cfg, norm)
        )
    if cfg.optimizer == "adafactor":
        return (lambda p: adafactor_init(p, cfg)), (
            lambda g, s, p, t, norm=None, means=None: _adafactor_update(g, s, p, t, cfg, norm, means)
        )
    raise ValueError(cfg.optimizer)
