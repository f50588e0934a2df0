"""The port's softplus (`repro_torch.kernels.softplus`, called by the SSD
mixer through `models.ssm._softplus`) against the JAX package's
`jax.nn.softplus` and its `jax.grad` on the CPU, bit for bit.

XLA's CPU computes `logaddexp(x, 0)` with its own polynomial `exp` and
`log1p`, FMAs where LLVM fused a product with the following add, and
subnormals read as zero and flushed; the plain versions repeat that code op
by op in IEEE f32 / f64 arithmetic, so they agree with the reference on
every input (the grad's NaNs as NaNs: their payloads are not the CPU's).
An exhaustive sweep of all 2^32 patterns is in `PERF.md`; here a strided
sweep of 2^22.  The kernels' own indexing runs in
tests/test_torch_emulated.py, and on the card in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import softplus as ksp
from repro_torch.models import ssm as PS


def patterns() -> np.ndarray:
    """2^22 f32 bit patterns, strided over all 2^32 (every exponent, both
    signs, subnormals, infinities and NaNs), and the edges of the clamps:
    |x| around 87.8 and 88.8, where 2^n reaches 2^-126 and 2^-127, and
    around log1p's 0.41421357 and logf's sqrt(1/2)."""
    sweep = (np.arange(1 << 22, dtype=np.uint64) * 1023 + 17).astype(np.uint32)
    edges = np.array([87.8, 88.8, 87.0, 87.33654, 86.64, 0.41421357, 0.88137, 0.7071068, 1e-38, 1.1754944e-38,
                      2.0**-126 * (1 - 2.0**-24), 16.63, 88.7228, 103.97], np.float32)
    near = (edges.view(np.uint32)[:, None] + np.arange(-512, 512, dtype=np.int64)).astype(np.uint32).ravel()
    near = np.concatenate([near, near | 0x80000000])
    zeros = np.array([0, 0x80000000, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFC00001, 1, 0x80000001, 0x007FFFFF,
                      0x00800000], np.uint32)
    return np.concatenate([sweep, near, zeros]).view(np.float32)


def cotangents(n: int, seed: int) -> np.ndarray:
    """Grads of softplus's output: magnitudes from 1e-45 to 1e38, specials first."""
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(n) * 10.0 ** rng.integers(-45, 38, n)).astype(np.float32)
    g[:10] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0, -1.0, 1e-39]
    return g


def same(a: np.ndarray, b: np.ndarray, nan_as_nan: bool = False) -> np.ndarray:
    """Where the bits of `a` and `b` agree (with `nan_as_nan`, NaN against NaN)."""
    eq = a.view(np.uint32) == b.view(np.uint32)
    return eq | (np.isnan(a) & np.isnan(b)) if nan_as_nan else eq


@pytest.fixture(scope="module")
def sweep():
    x = patterns()
    g = cotangents(x.size, 1)
    y, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    return x, g, np.array(y), np.array(vjp(jnp.asarray(g))[0])


def test_plain_forward_is_the_reference_bit_for_bit(sweep):
    x, _, want, _ = sweep
    got = ksp.softplus_fwd_plain(torch.from_numpy(x)).numpy()
    bad = ~same(got, want)
    assert not bad.any(), (bad.sum(), x[bad][:8], got[bad][:8], want[bad][:8])


def test_plain_grad_is_the_reference_bit_for_bit(sweep):
    x, g, y, want = sweep
    got = ksp.softplus_bwd_plain(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(g)).numpy()
    bad = ~same(got, want, nan_as_nan=True)
    assert not bad.any(), (bad.sum(), x[bad][:8], g[bad][:8], got[bad][:8], want[bad][:8])
    ones = np.asarray(jax.vmap(jax.grad(jax.nn.softplus))(x[:1 << 16]))
    got = ksp.softplus_bwd_plain(*(torch.from_numpy(v[:1 << 16]) for v in (x, y)), torch.ones(1 << 16)).numpy()
    assert same(got, ones, nan_as_nan=True).all()


def test_torch_logaddexp_is_not_the_reference():
    """The control: the parent's `torch.logaddexp(x, 0)` and its autograd
    grad differ from the reference on a normal grid, as measured before."""
    x = (np.random.default_rng(2).standard_normal(1 << 16) * 4).astype(np.float32)
    want, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = torch.logaddexp(t, torch.zeros(()))
    y.backward(torch.ones_like(y))
    assert (~same(y.detach().numpy(), np.asarray(want))).mean() > 0.02
    assert (~same(t.grad.numpy(), np.asarray(vjp(jnp.ones_like(want))[0]))).mean() > 0.2


@pytest.mark.parametrize("shape", [(2, 16, 6), (3, 5)], ids=["mixer", "decode"])
def test_mixer_softplus_and_its_autograd(shape):
    """`ssm._softplus` as the mixer and decode call it (`dt + dt_bias`,
    f32): its value and its grad through autograd equal the reference's
    `jax.nn.softplus` and `jax.vjp` on the same input, bit for bit."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    want, vjp = jax.vjp(jax.nn.softplus, jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_()
    y = PS._softplus(t)
    y.backward(torch.from_numpy(g))
    assert same(y.detach().numpy(), np.asarray(want)).all()
    assert same(t.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0])).all()
    with torch.no_grad():
        assert same(PS._softplus(torch.from_numpy(x)).numpy(), np.asarray(want)).all()


def test_wrappers_check_their_arguments():
    x = torch.zeros(4)
    with pytest.raises(TypeError):
        ksp.softplus_fwd(x.double())
    with pytest.raises(ValueError):
        ksp.softplus_bwd(x, torch.zeros(5), torch.zeros(4))
    with pytest.raises(TypeError):
        ksp.softplus_bwd(x, x, np.zeros(4, np.float32))
    assert ksp.softplus_fwd(torch.empty(0, 3)).shape == (0, 3)
    meta = ksp.softplus_fwd(torch.empty(2, 3, device="meta"))
    assert meta.shape == (2, 3) and meta.device.type == "meta"
    before = dict(ksp.LAUNCHES)
    ksp.softplus_bwd(x, ksp.softplus_fwd(x), x)
    assert ksp.LAUNCHES == before  # the CPU takes the plain versions: no launch


def test_chip_smoke_softplus_check_on_cpu():
    """`chip_smoke.py`'s softplus check rehearsed on the CPU (the plain
    versions on both sides) over a slice of the patterns, the model's
    shapes and the row layout; and its pattern walk and comparison."""
    cs = __import__("test_torch_serve")._load_chip_smoke()
    out = cs.check_softplus(np.random.default_rng(0), "cpu", total=1 << 15, chunk=1 << 13)
    assert out["differ"] == {"softplus_fwd": 0, "softplus_bwd": 0} and out["patterns"] == 1 << 15
    assert len(out["shapes"]) == 2 * len(cs.SOFTPLUS_SHAPES)
    top = cs.softplus_patterns((1 << 32) - 4, 4, "cpu").view(torch.int32)
    assert top.tolist() == [-4, -3, -2, -1]
    nan = torch.tensor([float("nan"), 1.0])
    other = torch.tensor([1.0, 1.0]).view(torch.int32)
    other[0] = 0x7FC00001
    assert cs.softplus_differ(nan, other.view(torch.float32), nan_as_nan=True).tolist() == [False, False]
    assert cs.softplus_differ(nan, other.view(torch.float32), nan_as_nan=False).tolist() == [True, False]
