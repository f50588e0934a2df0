"""The port's `loss_fn` and its grads (`repro_torch.models.transformer`)
against the JAX package's `jax.value_and_grad(repro.models.transformer.
loss_fn)` on the CPU, on the ten reduced archs, from the reference's
weights (carried by `params_from_reference`) and `make_inputs` draws.

Both sides compute in bf16 with f32 statistics and round in a few other
places (see tests/test_torch_models.py), forward and backward, so values
are compared by a stated bound: the loss by relative error, each grad leaf
by max |port - reference| over max |reference|, each bound at most twice
the worst measured on this grid (beside it).  Reduced jamba's bf16 router
logits tie exactly, so one routing flips end to end and its grads are held
block by block on the reference's own inputs (tests/test_torch_grad_blocks.py).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES, get_config as ref_get_config
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch import steps
from repro_torch.launch.serve import make_inputs
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_reference
from repro_torch.tree import leaves

TOL_LOSS = 0.01        # loss and ce, relative (worst 3.3e-3, forced jamba; 4.6e-4 the others)
TOL_AUX = 0.006        # MoE aux loss, relative (worst 4.6e-3, jamba; 3.8e-3 the others)
TOL_GRAD = 0.082       # a grad leaf end to end, nine archs (worst 0.0411, llama-vision's ln1)
TOL_GRAD_BLOCK = 0.042  # a grad leaf of one block on the reference's input, jamba (worst 0.0210, dt_bias)
# skip_d's grad is a sum over (batch, seq, head_dim) of bf16 products, which
# the reference's broadcast transpose accumulates in bf16 and the port in f32
# (rounded once): PERF.md section 6.  Worst 0.321 (a jamba block), 0.087
# (mamba2 end to end).
TOL_GRAD_SKIP_D = 0.45
BATCH, SEQ = 2, 16


@pytest.fixture(autouse=True)
def one_thread():
    """Torch on one intra-op thread for each test: under pytest-xdist every
    core runs a worker, and a parallel op of the small models here waits on
    descheduled pool threads (a reduced train loop ran 50-100x slower).
    The readings beside the bounds are the same at 1 and 8 threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel_err(ref, got) -> float:
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    got = got.float().numpy()
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30))


def carried(tree):
    return params_from_reference(jax.tree.map(np.asarray, tree), device="cpu")


def grad_tol(path: str, tol: float) -> float:
    return TOL_GRAD_SKIP_D if "skip_d" in path else tol


@functools.lru_cache(maxsize=None)
def setup(arch):
    """(port cfg, reference cfg, reference params, inputs) at
    `reduced(capacity_factor=8.0)`: no MoE drops."""
    ref_cfg = ref_get_config(arch).reduced(capacity_factor=8.0)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    return get_config(arch).reduced(capacity_factor=8.0), ref_cfg, params, make_inputs(ref_cfg, BATCH, SEQ, seed=0)


def port_loss_and_grads(cfg, params, batch):
    """The port's (loss, metrics, grads in leaf order)."""
    loss, metrics, grads = steps.loss_and_grads(cfg, params, batch)
    return loss, metrics, leaves(grads)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_loss_and_grads_match_reference(arch):
    cfg, ref_cfg, params, inputs = setup(arch)
    (lj, mj), gj = jax.value_and_grad(RT.loss_fn, has_aux=True)(
        params, ref_cfg, {k: jnp.asarray(v) for k, v in inputs.items()})
    lt, mt, gt = port_loss_and_grads(cfg, carried(params), {k: torch.from_numpy(v) for k, v in inputs.items()})
    assert lt.dtype == torch.float32 and lt.shape == ()
    assert abs(float(lt) - float(lj)) <= TOL_LOSS * abs(float(lj))
    ce, aux = float(mt["ce"]), float(mt["aux"])
    assert abs(ce - float(mj["ce"])) <= TOL_LOSS * abs(float(mj["ce"]))
    assert abs(aux - float(mj["aux"])) <= TOL_AUX * max(abs(float(mj["aux"])), 1e-6)
    ref_leaves = jax.tree_util.tree_flatten_with_path(gj)[0]
    assert len(ref_leaves) == len(gt)
    for (path, g_ref), g in zip(ref_leaves, gt):
        key = jax.tree_util.keystr(path)
        assert g.dtype == getattr(torch, str(g_ref.dtype)) and bool(torch.isfinite(g).all()), key
        if arch != "jamba-1.5-large-398b":  # routing flips end to end: held per block
            assert rel_err(g_ref, g) <= grad_tol(key, TOL_GRAD), key


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m", "qwen3-moe-30b-a3b", "whisper-small"])
def test_remat_gives_identical_loss_and_grads(arch, monkeypatch):
    """`cfg.remat` recomputes each rep in the backward
    (`torch.utils.checkpoint`): the same loss and grads bit for bit, with
    every rep's body run twice."""
    cfg, _, params, inputs = setup(arch)
    pt = carried(params)
    batch = {k: torch.from_numpy(v) for k, v in inputs.items()}
    calls = []
    body = PT._apply_rep
    monkeypatch.setattr(PT, "_apply_rep", lambda *a: calls.append(1) or body(*a))
    out = {}
    for remat in (False, True):
        calls.clear()
        out[remat] = port_loss_and_grads(dataclasses.replace(cfg, remat=remat), pt, batch)
        assert len(calls) == cfg.reps * (1 + remat)
    assert torch.equal(out[False][0], out[True][0])
    assert all(torch.equal(a, b) for a, b in zip(out[False][2], out[True][2]))
    with torch.inference_mode():  # serving never recomputes
        calls.clear()
        PT.forward(pt, dataclasses.replace(cfg, remat=True), batch)
        assert len(calls) == cfg.reps
