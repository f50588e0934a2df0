"""Reduced jamba end to end against the JAX reference with its MoE routing
teacher-forced where a tie could flip it.

Reduced jamba's bf16 router logits tie exactly at times, so a 1-ulp
difference upstream can flip a token's routing and carry to the logits
(tests/test_torch_models.py holds its whole model at 0.4).  Here the
reference's own routing is recorded (`jax.lax.top_k` wrapped in a
`jax.debug.callback` for the test), and the port's `layers._top_k` is
patched to take the reference's experts at each token whose reference
top-k margin, in logit units (the gaps between the k + 1 largest log
probabilities), is below `ROUTER_MARGIN`; the weights stay the port's own
probabilities at those experts.  Every other token must route as the
reference does.  The main path is not touched.

With every routing the reference's, 16 layers of bf16 rounding still
compound: `silu` rounds as the reference's, but each of jamba's 14 Mamba
mixers keeps softplus's f32 ulps (`TOL_MAMBA` in test_torch_models.py) and
the backward's other roundings, and a router-free reduced mamba2 of the
same 16 layers drifts as far (`test_mamba2_at_jambas_depth`).  So the
bounds below are set from these readings, not at `TOL_MODEL` / `TOL_GRAD`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.launch.serve import make_inputs
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves
from test_torch_grads import TOL_LOSS, carried, one_thread, rel_err  # noqa: F401

ARCH = "jamba-1.5-large-398b"
BATCH, SEQ = 2, 16

# The largest move of a pairwise router-logit difference (per token, the
# spread of log p_port - log p_reference over the experts) with every
# routing forced measured 0.449 (the last MoE layer) with a `silu` that
# rounded once, 0.289 since; a token whose reference margin is below twice
# the first is forced (246 of 256 either way).
ROUTER_MARGIN = 0.9
# Forced readings: logits 0.0861, the grads' global relative error 0.129
# (2-norm of the difference over all leaves over the reference's), each
# bound twice the reading.  Unforced: 0.123 and 0.146.
TOL_FORCED_LOGITS = 0.17
TOL_FORCED_GRADS = 0.25
# Reduced mamba2 at 16 layers: logits 0.102 (bound twice that), grads 0.209
# (held at 0.4, the bound before `silu` rounded as the reference's).
TOL_DEPTH_LOGITS = 0.2
TOL_DEPTH_GRADS = 0.4


def _reference_routing(monkeypatch):
    """A list that records (probs, experts) of each of the reference's
    `jax.lax.top_k` calls as its computation runs them, in order."""
    calls, top_k = [], jax.lax.top_k

    def recording(probs, k):
        out = top_k(probs, k)
        jax.debug.callback(lambda p, e: calls.append((np.asarray(p), np.asarray(e))), probs, out[1],
                           ordered=True)
        return out

    monkeypatch.setattr(jax.lax, "top_k", recording)
    return calls


def _margins(probs: np.ndarray, k: int) -> np.ndarray:
    """Per token, the smallest gap between neighbours among the k + 1 largest
    log probabilities (logit units)."""
    s = -np.sort(-np.log(probs.astype(np.float64)), axis=-1)
    return np.min(s[..., :k] - s[..., 1:k + 1], axis=-1)


class Forced:
    """The port's `_top_k`, taking the reference's experts (call by call,
    in order) at each token whose reference margin is below
    `ROUTER_MARGIN`; records the forced count, whether every other token
    routed as the reference did, and the worst spread."""

    def __init__(self, reference):
        self.reference, self.calls = reference, 0
        self.forced, self.agree, self.spread = 0, True, 0.0

    def __call__(self, probs, k):
        ref_p, ref_e = self.reference[self.calls]
        self.calls += 1
        idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]
        d = np.log(probs.detach().double().numpy()) - np.log(ref_p.astype(np.float64))
        self.spread = max(self.spread, float((d.max(-1) - d.min(-1)).max()))
        force = torch.from_numpy(_margins(ref_p, k) < ROUTER_MARGIN)
        ref_idx = torch.from_numpy(np.asarray(ref_e, np.int64))
        self.agree &= bool((idx == ref_idx)[~force].all())
        self.forced += int(force.sum())
        idx = torch.where(force[..., None], ref_idx, idx)
        return torch.gather(probs, -1, idx), idx


def _setup(arch, **over):
    ref_cfg = ref_get_config(arch).reduced(capacity_factor=8.0, **over)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    inputs = make_inputs(ref_cfg, BATCH, SEQ, seed=0)
    return get_config(arch).reduced(capacity_factor=8.0, **over), ref_cfg, params, inputs


def _grad_err(ref_grads, grads) -> float:
    """The 2-norm of the difference of all grad leaves over the reference's."""
    num = den = 0.0
    for g_ref, g in zip(jax.tree.leaves(ref_grads), grads):
        r = np.asarray(jnp.asarray(g_ref, jnp.float32), np.float64)
        num += float(((r - g.double().numpy()) ** 2).sum())
        den += float((r ** 2).sum())
    return (num / den) ** 0.5


def test_jamba_forced_routing_matches_reference(monkeypatch):
    """Reduced jamba (16 layers, 8 MoE layers of 4 experts, top 2; batch
    2 x 16) with the near-tie tokens' routing forced: every unforced
    token routes as the reference does, the worst spread stays within
    half of `ROUTER_MARGIN`, 246 of the 256 token routings are forced, and the
    forward logits, the loss and the grads are held to the forced bounds."""
    cfg, ref_cfg, params, inputs = _setup(ARCH)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in inputs.items()}
    pt = carried(params)
    ref_calls = _reference_routing(monkeypatch)
    lj, _ = RT.forward(params, ref_cfg, jb)
    (loss_j, _), gj = jax.value_and_grad(RT.loss_fn, has_aux=True)(params, ref_cfg, jb)
    jax.effects_barrier()
    moe_layers = cfg.num_layers // cfg.moe_every
    assert len(ref_calls) == 2 * moe_layers

    fwd = Forced(ref_calls[:moe_layers])
    monkeypatch.setattr(PL, "_top_k", fwd)
    lt, _ = PT.forward(pt, cfg, tb)
    grad = Forced(ref_calls[moe_layers:])
    monkeypatch.setattr(PL, "_top_k", grad)
    loss_t, _, gt = steps.loss_and_grads(cfg, pt, tb)
    readings = {"forced": (fwd.forced, grad.forced), "spread": (fwd.spread, grad.spread),
                "logits": rel_err(lj, lt), "loss": abs(float(loss_t) - float(loss_j)) / float(loss_j),
                "grads": _grad_err(gj, leaves(gt))}
    assert fwd.calls == grad.calls == moe_layers, readings
    assert fwd.agree and grad.agree, readings
    assert max(readings["spread"]) <= ROUTER_MARGIN / 2, readings
    assert readings["forced"] == (246, 246), readings
    assert readings["logits"] <= TOL_FORCED_LOGITS, readings
    assert readings["loss"] <= TOL_LOSS, readings
    assert readings["grads"] <= TOL_FORCED_GRADS, readings


def test_mamba2_at_jambas_depth():
    """Reduced mamba2 at jamba's 16 layers, no router: its logits and
    grads drift from the reference's about as far as forced jamba's
    (readings 0.102 and 0.209), within `TOL_DEPTH_LOGITS` /
    `TOL_DEPTH_GRADS`; at its own 2 layers `TOL_MODEL` holds
    (tests/test_torch_models.py)."""
    cfg, ref_cfg, params, inputs = _setup("mamba2-780m", num_layers=16)
    jb = {k: jnp.asarray(v) for k, v in inputs.items()}
    tb = {k: torch.from_numpy(v) for k, v in inputs.items()}
    pt = carried(params)
    lj, _ = RT.forward(params, ref_cfg, jb)
    lt, _ = PT.forward(pt, cfg, tb)
    (loss_j, _), gj = jax.value_and_grad(RT.loss_fn, has_aux=True)(params, ref_cfg, jb)
    loss_t, _, gt = steps.loss_and_grads(cfg, pt, tb)
    readings = {"logits": rel_err(lj, lt), "loss": abs(float(loss_t) - float(loss_j)) / float(loss_j),
                "grads": _grad_err(gj, leaves(gt))}
    assert readings["logits"] <= TOL_DEPTH_LOGITS, readings
    assert readings["loss"] <= TOL_LOSS, readings
    assert readings["grads"] <= TOL_DEPTH_GRADS, readings
