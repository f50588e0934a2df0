"""Step functions for serving: the port of the serving half of the JAX
package's `repro/launch/steps.py`.

The reference's steps are pure functions for `jax.jit`; here they run
eagerly over the same param dict, and the decode step writes the caches
in place (the reference donates them).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch, cache_len)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, caches, pos):
        return T.decode_step(params, cfg, token, caches, pos)

    return decode_step
