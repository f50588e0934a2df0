"""Grads on the CPU where a whole-model comparison cannot hold them, and the
SSD's mask before `exp`.

Reduced jamba's bf16 router logits tie exactly, so one token's routing
flips between the port and the JAX package end to end and every grad
differs by 0.1-0.7 of its largest value; here each block's grads are taken
on the reference's own input, as `Walk` in tests/test_torch_models.py
compares its forward.  The bounds and helpers are tests/test_torch_grads.py's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import ssm as RS
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch.serve import make_inputs
from repro_torch.models import layers as PL
from repro_torch.models import ssm as PS
from repro_torch.models import transformer as PT
from repro_torch.tree import leaves, tree_map
from test_torch_grads import (BATCH, SEQ, TOL_GRAD_BLOCK, TOL_LOSS, carried, grad_tol, one_thread,  # noqa: F401
                              port_loss_and_grads, rel_err, setup)


def _block_vjps(ref_fn, port_fn, pj, pt, x, cotangent):
    """Grads of <fn(p, x), cotangent> w.r.t. the block's params and input,
    both packages on the reference's `x`: (reference, port) leaf lists with
    their key strings, params then the input."""
    _, pull = jax.vjp(ref_fn, pj, x)
    gp, gx = pull(cotangent)
    ref = [(jax.tree_util.keystr(p), g) for p, g in jax.tree_util.tree_flatten_with_path(gp)[0]]
    ref.append(("x", gx))
    train = tree_map(lambda p: p.detach().clone().requires_grad_(), pt)
    xt = carried(x).requires_grad_()
    outs = port_fn(train, xt)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cts = [carried(c) for c in (cotangent if isinstance(cotangent, tuple) else (cotangent,))]
    port = torch.autograd.grad(outs, leaves(train) + [xt], cts, materialize_grads=True)
    return ref, port


@pytest.mark.parametrize("rep", [0, 1])
def test_jamba_block_grads_on_reference_inputs(rep):
    """Every block of jamba's rep `rep`: the grads w.r.t. its params and its
    input for a random cotangent, on the input the reference's forward
    gives it (reps before `rep` run in the reference alone).  A MoE block is
    split as `Walk` in test_torch_models.py splits it: the mixer half, then
    ln2 + MoE (+ 0.01 x aux) on the half's reference output."""
    arch = "jamba-1.5-large-398b"
    cfg, ref_cfg, params, inputs = setup(arch)
    pt = carried(params)
    rng = np.random.default_rng(rep)
    pos_j = jnp.broadcast_to(jnp.arange(SEQ)[None], (BATCH, SEQ))
    pos_t = torch.from_numpy(np.array(pos_j, np.int32))
    x = params["embed"][jnp.asarray(inputs["tokens"])].astype(jnp.bfloat16)
    checked = 0
    for r in range(rep + 1):
        for i, (mixer, ffn) in enumerate(ref_cfg.pattern()):
            pj = jax.tree.map(lambda a, r=r: a[r], params["blocks"][i])
            half = "none" if ffn == "moe" else ffn

            def ref_block(p, x, m=mixer, f=half):
                return RT._apply_block(ref_cfg, m, f, p, x, pos_j, None)[0]

            def port_block(p, x, m=mixer, f=half):
                return PT._apply_block(cfg, m, f, p, x, pos_t, None)[0]

            y = ref_block(pj, x)
            if ffn == "moe":
                def ref_moe(p, y):
                    return RL.moe(p["ffn"], ref_cfg, RL.rmsnorm(y, p["ln2"], ref_cfg.norm_eps))

                def port_moe(p, y):
                    return PL.moe(p["ffn"], cfg, PL.rmsnorm(y, p["ln2"], cfg.norm_eps))

                moe_p = {"ffn": pj["ffn"], "ln2": pj["ln2"]}
                out, _ = ref_moe(moe_p, y)
            if r == rep:
                pt_r = PT._rep_slice(pt["blocks"][i], r)
                ct = jnp.asarray(rng.standard_normal(x.shape), jnp.float32).astype(jnp.bfloat16)
                pairs = [_block_vjps(ref_block, port_block, pj, pt_r, x, ct)]
                if ffn == "moe":
                    ct2 = jnp.asarray(rng.standard_normal(x.shape), jnp.float32).astype(jnp.bfloat16)
                    pairs.append(_block_vjps(ref_moe, port_moe, moe_p, {"ffn": pt_r["ffn"], "ln2": pt_r["ln2"]},
                                             y, (ct2, jnp.float32(0.01))))
                for ref, port in pairs:
                    assert len(ref) == len(port)
                    for (key, g_ref), g in zip(ref, port):
                        if np.abs(np.asarray(g_ref, np.float32)).max() == 0:  # the other half's params
                            assert not bool(g.any()), key
                            continue
                        assert rel_err(g_ref, g) <= grad_tol(key, TOL_GRAD_BLOCK), (r, i, key)
                        checked += 1
            x = y + out if ffn == "moe" else y
    assert checked > 100


def test_segsum_decay_masks_before_exp():
    """At a 256-chunk with decays whose above-diagonal exponent overflows:
    the port's forward is its earlier form (mask after `exp`) bit for bit,
    within 1 f32 ulp of the reference's (the two `exp`s' last bit), and the
    reference's own form gives the same values as masking before `exp`."""
    rng = np.random.default_rng(0)
    a_cs = np.cumsum(-rng.exponential(1.0, (2, 3, 4, 256)).astype(np.float32), axis=-1, dtype=np.float32)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(a_cs[..., :, None] - a_cs[..., None, :])).any()  # above the diagonal
    at = torch.from_numpy(a_cs)
    got = PS._segsum_decay(at)
    li, lj = at[..., :, None], at[..., None, :]
    mask = torch.tril(torch.ones((256, 256), dtype=torch.bool))
    assert torch.equal(got, torch.where(mask, torch.exp(li - lj), 0.0))
    ref = np.asarray(RS._segsum_decay(jnp.asarray(a_cs)))
    aj = jnp.asarray(a_cs)
    ref_masked_first = jnp.exp(jnp.where(np.tril(np.ones((256, 256), bool)), aj[..., :, None] - aj[..., None, :],
                                         -jnp.inf))
    assert np.asarray(ref_masked_first).tobytes() == ref.tobytes()
    ulps = np.abs(ref.view(np.int32).astype(np.int64) - got.numpy().view(np.int32).astype(np.int64))
    tiny = np.abs(got.numpy()) < np.finfo(np.float32).tiny  # XLA's CPU flushes subnormals to 0
    assert ulps[~tiny].max() <= 1 and not ref[tiny].any()


def test_mamba2_grads_finite_at_the_published_chunk():
    """Reduced mamba2 at `ssm_chunk=256` (the published chunk), batch 2 x seq
    256: every grad of the port is finite.  The reference's are not: its
    `_segsum_decay` takes `exp` before the mask (ROADMAP.md section 3)."""
    ref_cfg = ref_get_config("mamba2-780m").reduced(ssm_chunk=256)
    cfg = get_config("mamba2-780m").reduced(ssm_chunk=256)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    tokens = make_inputs(ref_cfg, 2, 256, seed=0)["tokens"]
    (lj, _), gj = jax.value_and_grad(RT.loss_fn, has_aux=True)(params, ref_cfg, {"tokens": jnp.asarray(tokens)})
    lt, _, gt = port_loss_and_grads(cfg, carried(params), {"tokens": torch.from_numpy(tokens)})
    assert abs(float(lt) - float(lj)) <= TOL_LOSS * abs(float(lj))
    assert all(bool(torch.isfinite(g).all()) for g in gt)
    ref_finite = [bool(np.isfinite(np.asarray(g)).all()) for g in jax.tree.leaves(gj)]
    assert len(ref_finite) == len(gt) == 12 and ref_finite.count(False) == 10
