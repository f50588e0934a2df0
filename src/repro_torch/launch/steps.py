"""Step functions: the port of the JAX package's `repro/launch/steps.py`
(training, and serving's prefill and decode).

The reference's steps are pure functions for `jax.jit`; here they run
eagerly over the same param dict.  The train step takes grads with torch
autograd (for `jax.value_and_grad`) and updates params and optimizer
state in place (the reference donates them); the decode step writes the
caches in place.  `param_specs` / `opt_specs` are the state's shapes and
dtypes on the `meta` device (for `jax.eval_shape`), with no allocation.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import OptConfig, make_optimizer
from repro_torch.tree import leaves, tree_map, unflatten

# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_and_grads(cfg: ModelConfig, params, batch):
    """(loss, metrics, grads): `loss_fn` on `batch` and its grads w.r.t.
    `params`, in the params' nesting (`jax.value_and_grad` of the
    reference's `loss_fn`).

    The grads are taken w.r.t. detached views of the params, made trainable
    for the call alone, so the params (frozen `nn.Parameter`s of a
    `Transformer`, say) stay as serving uses them.  bf16 products sum in
    f32 throughout: the forward, the backward and the remat recompute."""
    with L.f32_accumulation(), torch.enable_grad():
        trainable = tree_map(lambda p: p.detach().requires_grad_(), params)
        loss, metrics = T.loss_fn(trainable, cfg, batch)
        flat = torch.autograd.grad(loss, leaves(trainable), materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten(params, flat)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    _, update = make_optimizer(opt_cfg)

    def train_step(params, opt_state, batch, step):
        """One step on `batch` (a dict of tensors on the params' device):
        returns (params, opt_state, metrics), the first two updated in place
        under `no_grad`."""
        loss, metrics, grads = loss_and_grads(cfg, params, batch)
        with torch.no_grad():
            params, opt_state, opt_metrics = update(grads, opt_state, params, step)
        return params, opt_state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_opt_init(cfg: ModelConfig, opt_cfg: OptConfig):
    init, _ = make_optimizer(opt_cfg)
    return init


def param_specs(cfg: ModelConfig):
    """The param dict's shapes and dtypes, on the `meta` device."""
    return T.init_params(cfg, None, "meta")


def opt_specs(cfg: ModelConfig, opt_cfg: OptConfig):
    """The optimizer state's shapes and dtypes, on the `meta` device."""
    return make_opt_init(cfg, opt_cfg)(param_specs(cfg))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, caches, pos):
        return T.decode_step(params, cfg, token, caches, pos)

    return decode_step
