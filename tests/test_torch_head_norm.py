"""`repro_torch.models.layers.head_norm`, the q / k norms of attention,
against the JAX package's `rmsnorm` on the CPU.

The norms' weight is shared by the heads, so its grad is a sum over
(batch, seq, heads).  The port sums it in one order that no split of the
heads changes (each head's partial over the leading dims, then the heads,
each by one sum over a shape that a rank sees as one device does), where
the reference lets XLA pick its order; the per-token norm, its output and
the input's grad are `rmsnorm`'s.  Inputs
are numpy draws from a seed, handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L
from test_torch_grads import TOL_GRAD

EPS = 1e-6
#: (batch, seq, heads, head dim): reduced qwen3's q and k, and full-width
#: qwen3-4b's heads at a short sequence.
SHAPES = [(2, 16, 4, 32), (2, 16, 2, 32), (1, 8, 32, 128), (3, 5, 8, 128)]


def draws(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 2).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    to_bf16 = lambda v: np.asarray(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))  # noqa: E731
    return to_bf16(x).copy(), scale, to_bf16(ct).copy()


def port_grads(norm, x, scale, ct):
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    out = norm(xt, st, EPS)
    out.backward(torch.from_numpy(ct).to(torch.bfloat16))
    return out, xt.grad, st.grad


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_norm_weight_grad_matches_reference(shape):
    """The weight grad against `jax.vjp` of the reference's `rmsnorm`,
    within 1e-5 relative to its largest element (f32 sums of up to 1,024
    terms per element in another order; `TOL_GRAD`, the end-to-end leaf
    bound, is far above it); the output bit for bit against the
    reference's bf16 (the input's grad is `rmsnorm`'s, below)."""
    x, scale, ct = draws(shape, sum(shape))
    out_ref, vjp = jax.vjp(lambda xv, s: RL.rmsnorm(xv, s, EPS), jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale))
    gs_ref = np.asarray(vjp(jnp.asarray(ct, jnp.bfloat16))[1])
    out, _, gs = port_grads(L.head_norm, x, scale, ct)
    err = float(np.abs(gs.numpy() - gs_ref).max() / np.abs(gs_ref).max())
    assert err <= 1e-5 <= TOL_GRAD, err
    assert np.array_equal(out.float().detach().numpy(), np.asarray(out_ref.astype(jnp.float32)))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_head_norm_is_rmsnorm_but_for_the_weight_grad(shape):
    """`head_norm`'s output and input grad equal `rmsnorm`'s bit for bit;
    its weight grad is the heads' sum of the per-head partials, each by one
    `sum` over dim 0; a rank's run of the heads, summed among all the
    heads' with the others zero (as `_SharedScale` does where the heads are
    split), gets its heads' partials with the same bits."""
    x, scale, ct = draws(shape, 7 + sum(shape))
    out, gx, gs = port_grads(L.head_norm, x, scale, ct)
    out0, gx0, _ = port_grads(L.rmsnorm, x, scale, ct)
    assert torch.equal(out, out0) and torch.equal(gx, gx0)
    normed = L._normed(torch.from_numpy(x).to(torch.bfloat16), EPS)
    prod = (torch.from_numpy(ct).to(torch.bfloat16).float() * normed).reshape(-1, *shape[-2:])
    heads = prod.sum(0)
    assert torch.equal(gs, heads.sum(0))
    h = shape[-2]
    for lo, hi in ((0, h // 2), (h // 2, h), (h - 1, h)):
        whole = torch.zeros_like(prod)
        whole[:, lo:hi] = prod[:, lo:hi]
        assert torch.equal(whole.sum(0)[lo:hi], heads[lo:hi]), (lo, hi)


def test_head_norm_without_grad_is_rmsnorm():
    """Without autograd (serving), the plain product: `rmsnorm`'s bits."""
    x, scale, _ = draws((2, 3, 4, 32), 1)
    xt, st = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(scale)
    with torch.no_grad():
        assert torch.equal(L.head_norm(xt, st, EPS), L.rmsnorm(xt, st, EPS))
