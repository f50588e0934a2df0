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
import math
import operator
from typing import Literal

import numpy as np
import torch

from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

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


#: Runs a dim of a leaf is cut into for the clip's norm: gcd(size, NORM_RUNS),
#: and a block stack's leading dim one run a rep.  A mesh that splits a dim
#: into m equal shards, m dividing 32 (the production mesh's 16 x 16, 2 pods
#: stacked over dp: 32), cuts no run.
NORM_RUNS = 32


def _halve(v: torch.Tensor, dim: int) -> torch.Tensor:
    """`v` with its `dim` halved: element i plus element i + n // 2, an odd
    last element carried over to the end."""
    n = v.shape[dim]
    half = n // 2
    out = v.narrow(dim, 0, half) + v.narrow(dim, half, half)
    return torch.cat([out, v.narrow(dim, 2 * half, 1)], dim) if n % 2 else out


def pairwise_sum(v: torch.Tensor, dims=(-1,)) -> torch.Tensor:
    """The sums of `v` over `dims` (each kept, of size 1), last dim first,
    each by halving (`_halve`) until one element is left: one fixed order
    of IEEE adds for each output, whatever the count of outputs, their
    layout or the device (a library reduction picks its order by the
    shape)."""
    for d in sorted((d % v.dim() for d in dims), reverse=True):
        while v.shape[d] > 1:
            v = _halve(v, d)
    return v


def norm_runs(path, shape) -> tuple:
    """The runs per dim for the clip's norm of the leaf at `path` (a key
    path, `tree.leaves_with_path`'s) of `shape`: a leaf of a block stack
    (its leading dim the reps, which no mesh splits) one run a rep, so that
    the count of blocks grows with depth as the model's other costs do."""
    runs = [math.gcd(n, NORM_RUNS) for n in shape]
    if runs and "blocks" in keystr(path):
        runs[0] = shape[0]
    return tuple(runs)


def block_square_sums(x: torch.Tensor, runs) -> torch.Tensor:
    """The f32 squares of `x` summed over each block of the grid that cuts
    dim d into `runs[d]` equal runs (`pairwise_sum` over a block's dims, on
    strided views), shape `runs`.  A block's sum does not depend on the
    other blocks: a shard holding whole blocks gets them as the whole leaf
    does.  A leaf over `SLICE_ELEMS` values goes as many runs of dim 0 at a
    time as that holds (at least one)."""
    if x.dim() == 0:
        return x.to(F32).square()
    per_run = x.numel() // runs[0]
    step = max(1, SLICE_ELEMS // max(per_run, 1))
    if runs[0] > step:
        rows = x.shape[0] // runs[0]
        return torch.cat([block_square_sums(x.narrow(0, i * rows, min(step, runs[0] - i) * rows),
                                            (min(step, runs[0] - i), *runs[1:])) for i in range(0, runs[0], step)])
    split = [v for n, r in zip(x.shape, runs) for v in (r, n // r)]
    return pairwise_sum(x.reshape(split).to(F32).square(), range(1, 2 * x.dim(), 2)).reshape(runs)


def norm_of_partials(parts) -> torch.Tensor:
    """sqrt of the pairwise sum of the leaves' flattened block sums, in
    leaf order."""
    return torch.sqrt(pairwise_sum(torch.cat([p.reshape(-1) for p in parts]))[0])


def mean_runs(n: int) -> int:
    """Runs a dim of `n` is cut into for Adafactor's factored means:
    gcd(n, NORM_RUNS), so that a mesh axis of a power of two up to
    `NORM_RUNS` that splits the dim cuts no run."""
    return math.gcd(n, NORM_RUNS)


def run_sums(x: torch.Tensor, dim: int, runs: int) -> torch.Tensor:
    """The sums of `x` over `runs` equal runs of `dim` (each a
    `pairwise_sum`), `dim` then of size `runs`: a run's sum does not depend
    on the other runs, so a shard holding whole runs gets them as the whole
    tensor does."""
    dim %= x.dim()
    split = x.reshape(*x.shape[:dim], runs, x.shape[dim] // runs, *x.shape[dim + 1:])
    return pairwise_sum(split, (dim + 1,)).squeeze(dim + 1)


def mean_of_runs(sums: torch.Tensor, dim: int, n: int, keepdim: bool = False) -> torch.Tensor:
    """The mean over `n` values from their runs' sums `sums` along `dim`:
    the runs summed pairwise, divided by `n`."""
    total = pairwise_sum(sums, (dim,))
    total = total if keepdim else total.squeeze(dim)
    return total / torch.tensor(float(n), dtype=total.dtype, device=total.device)


def factored_mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """Adafactor's mean of `x` over `dim`: the sums of `mean_runs` runs, then
    the runs' sums, each in a fixed pairwise order, so that a sharded step,
    which gathers each rank's runs (`launch.steps.make_sharded_train_step`),
    gets the same bits."""
    return mean_of_runs(run_sums(x, dim, mean_runs(x.shape[dim])), dim % x.dim(), x.shape[dim], keepdim)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of the sum of squares, in f32: each
    leaf's squares summed over the blocks of `norm_runs`, then all the
    blocks' sums in one fixed order (`norm_of_partials`), so that a sharded
    step, which sums its shards' blocks and gathers them
    (`launch.steps.make_sharded_train_step`), gets the same bits."""
    return norm_of_partials([block_square_sums(x, norm_runs(path, x.shape)) for path, x in leaves_with_path(tree)])


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


def _adafactor_leaf(g, v, p, scale, lr, cfg: OptConfig, mean=factored_mean) -> None:
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
    for g, (path, p), mean in zip(leaves(grads), flat, means or [factored_mean] * len(flat)):
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
