"""The port's `silu` (`repro_torch.models.layers.silu` over
`repro_torch.kernels.silu`) against the JAX package's `jax.nn.silu` and its
`jax.grad` on the CPU.

XLA computes `jax.nn.silu` as five ops and its grad as seven more, each
rounded to the operand's dtype, with subnormals flushed; the port does the
same ops in the same order (the plain versions here, the `silu` kernels on
the card), so on bf16 the two agree bit for bit on every input.  In f32,
XLA's `exp` is not torch's, so there the bound is stated in f32 ulps.  The
kernels' own indexing runs in tests/test_torch_emulated.py, and on the card
in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import silu as ksilu
from repro_torch.models import layers as PL

#: f32 against the reference, each bound twice the worst measured on the
#: grids below: XLA's f32 `exp` is not torch's (an ulp apart on some inputs),
#: and XLA does not flush f32 intermediates where the bf16 steps do.  The
#: forward in ulps of the reference's value (worst 3); the grad, where
#: k + l may cancel, in ulps of its scale |h| (1 + |a|) (worst 1.5), where
#: that scale is normal and above 2^-100.
ULPS_F32 = 6
SCALE_ULPS_F32_GRAD = 3.0


def all_bf16() -> np.ndarray:
    """Every bf16 bit pattern as f32: |x| up to 3.4e38, +-0, subnormals, +-inf, nans."""
    return (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)


def cotangents(n: int, seed: int) -> np.ndarray:
    """Grads of silu's output for the grid: magnitudes from 1e-40 to 1e38, specials first."""
    rng = np.random.default_rng(seed)
    h = (rng.standard_normal(n) * 10.0 ** rng.integers(-40, 38, n)).astype(np.float32)
    h[:12] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40, 1.0, -1.0, 3e38, -3e38, 1e-39]
    return h


def reference(x: np.ndarray, h: np.ndarray, dtype):
    """(silu(x), the VJP of silu at x applied to h) from JAX, as f32 numpy."""
    xj, hj = jnp.asarray(x).astype(dtype), jnp.asarray(h).astype(dtype)
    y, vjp = jax.vjp(jax.nn.silu, xj)
    (g,) = vjp(hj)
    return np.asarray(y.astype(jnp.float32)), np.asarray(g.astype(jnp.float32)), xj, hj


def port(xj, hj, dtype):
    """(silu(x), its grad applied to h) through the port's autograd, as f32 numpy."""
    x = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(dtype).requires_grad_()
    h = torch.from_numpy(np.array(hj.astype(jnp.float32))).to(dtype)
    y = PL.silu(x)
    assert y.dtype == dtype
    y.backward(h)
    return y.detach().float().numpy(), x.grad.float().numpy()


def differ(ref: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Where the bits differ, a nan on both sides counting as equal."""
    return (ref.view(np.uint32) != got.view(np.uint32)) & ~(np.isnan(ref) & np.isnan(got))


def ulps(ref: np.ndarray, got: np.ndarray) -> int:
    """The largest distance in f32 ulps over the elements where both are finite."""
    both = np.isfinite(ref) & np.isfinite(got)
    key = lambda v: np.where(v.view(np.int32) < 0, np.int64(-(1 << 31)) - v.view(np.int32),  # noqa: E731
                             v.view(np.int32).astype(np.int64))
    return int(np.abs(key(ref[both]) - key(got[both])).max())


def test_silu_bf16_equals_jax_on_every_input():
    """Every bf16 value, with cotangents spread over the whole range:
    forward and grad equal the reference's bit for bit (subnormals flushed
    as XLA flushes them, inf and nan where it has them)."""
    x = all_bf16()
    ref_y, ref_g, xj, hj = reference(x, cotangents(x.size, 0), jnp.bfloat16)
    y, g = port(xj, hj, torch.bfloat16)
    assert not differ(ref_y, y).any(), x[differ(ref_y, y)][:8]
    assert not differ(ref_g, g).any(), x[differ(ref_g, g)][:8]
    assert np.isnan(y).sum() == np.isnan(ref_y).sum() > 0 and np.isinf(g).any()


def test_silu_bf16_equals_jax_where_one_rounding_does_not():
    """On a 64 x 512 grid of normal draws at the MLP's scale the port is
    exact, while `torch.nn.functional.silu` (one rounding) differs from the
    reference in many elements: the fault this `silu` repairs."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((64, 512)) * 3).astype(np.float32)
    h = rng.standard_normal((64, 512)).astype(np.float32)
    ref_y, ref_g, xj, hj = reference(x, h, jnp.bfloat16)
    y, g = port(xj, hj, torch.bfloat16)
    assert not differ(ref_y, y).any() and not differ(ref_g, g).any()
    one_rounding = torch.nn.functional.silu(torch.from_numpy(np.array(xj.astype(jnp.float32))).bfloat16())
    assert differ(ref_y, one_rounding.float().numpy()).mean() > 0.2


@pytest.mark.parametrize("grid", ["patterns", "normal"])
def test_silu_f32_within_ulps_of_jax(grid):
    """The same ops in f32, within `ULPS_F32` / `SCALE_ULPS_F32_GRAD` of the reference."""
    rng = np.random.default_rng(2)
    if grid == "patterns":  # every bf16 value read as f32, and its neighbours' low bits
        x = (all_bf16().view(np.uint32) | rng.integers(0, 1 << 16, 1 << 16).astype(np.uint32)).view(np.float32)
    else:
        x = (rng.standard_normal(1 << 16) * 8).astype(np.float32)
    h = cotangents(x.size, 3)
    ref_y, ref_g, xj, hj = reference(x, h, jnp.float32)
    y, g = port(xj, hj, torch.float32)
    assert ulps(ref_y, y) <= ULPS_F32
    assert not (np.isnan(ref_y) ^ np.isnan(y)).any() and not (np.isnan(ref_g) ^ np.isnan(g)).any()
    with np.errstate(over="ignore", invalid="ignore"):
        scale = (np.abs(h) * (1 + np.abs(x))).astype(np.float32)
    held = np.isfinite(ref_g) & np.isfinite(g) & np.isfinite(scale) & (scale >= 2.0 ** -100)
    assert held.mean() > 0.75
    err = np.abs(ref_g[held].astype(np.float64) - g[held]) / np.spacing(scale[held]).astype(np.float64)
    assert err.max() <= SCALE_ULPS_F32_GRAD


def test_silu_grad_on_the_layouts_of_its_callers():
    """The autograd Function on a column slice (the mixer's `z`) and a
    permuted einsum output (an expert path's): the values are a contiguous
    copy's, and the grad is `silu_bwd_plain` of the cotangent, in place of
    the slice."""
    rng = np.random.default_rng(4)
    proj = torch.from_numpy(rng.standard_normal((2, 5, 48)).astype(np.float32)).bfloat16().requires_grad_()
    buf = torch.from_numpy(rng.standard_normal((2, 4, 3, 8)).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((4, 8, 6)).astype(np.float32)).bfloat16()
    e = torch.einsum("becd,edf->becf", buf, w).requires_grad_()
    z = proj[..., 8:40]
    assert not z.is_contiguous() and not e.is_contiguous()
    for t, leaf in ((z, proj), (e, e)):
        y = PL.silu(t)
        assert torch.equal(y, ksilu.silu_fwd_plain(t.detach().contiguous()))
        h = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32)).bfloat16()
        y.backward(h)
        if t is z:
            exp = torch.zeros_like(proj)
            exp[..., 8:40] = ksilu.silu_bwd_plain(z.detach(), h)
        else:
            exp = ksilu.silu_bwd_plain(e.detach(), h)
        assert torch.equal(leaf.grad, exp)


def test_silu_walks_the_layouts_the_kernels_take():
    """How a launch reads each layout (the CPU never launches; the card's
    wrapper goes through `_walk`): dense tensors as one row with their own
    strides kept, a column slice as rows with its row stride, anything else
    as a dense copy."""
    base = torch.zeros(2, 5, 48, dtype=torch.bfloat16)
    a, dense, rows, cols, stride, out = ksilu._walk(base)
    assert (dense, rows, cols, stride) == (True, 1, 480, 480) and out.is_contiguous()
    perm = torch.zeros(4, 2, 3, 6, dtype=torch.bfloat16).permute(1, 0, 2, 3)
    a, dense, rows, cols, stride, out = ksilu._walk(perm)
    assert (dense, rows, cols) == (True, 1, 144) and out.stride() == perm.stride() and a is perm
    z = base[..., 8:40]
    a, dense, rows, cols, stride, out = ksilu._walk(z)
    assert (dense, rows, cols, stride) == (False, 10, 32, 48) and a is z and out.is_contiguous()
    cut = base[:, 1:4, 8:40].transpose(0, 1)
    a, dense, rows, cols, stride, out = ksilu._walk(cut)
    assert (dense, rows, cols, stride) == (True, 1, 192, 192) and a is not cut
    with pytest.raises(ValueError):
        ksilu.silu_bwd(base, base[0])


def test_chip_smoke_silu_check_on_cpu():
    """`chip_smoke.py`'s silu check rehearsed on the CPU (the plain versions
    on both sides), and its comparison's reading of nans, infinities and
    the signs of zeros."""
    cs = __import__("test_torch_serve")._load_chip_smoke()
    out = cs.check_silu(np.random.default_rng(0), "cpu")
    assert out["max_abs_err"] == {"silu_fwd": 0.0, "silu_bwd": 0.0} and out["cases"] == len(cs.SILU_SHAPES) + 4
    assert [c["contiguous"] for c in out["checks"][:len(cs.SILU_SHAPES)]] == [c is None for _, _, c in cs.SILU_SHAPES]
    t = torch.tensor([0.0, 1.0, float("inf"), float("nan")])
    assert cs.float_err(t, t.clone()) == 0.0
    for other in ([-0.0, 1.0, float("inf"), float("nan")], [0.0, 1.0, float("-inf"), float("nan")],
                  [0.0, 1.0, float("inf"), 2.0]):
        assert cs.float_err(t, torch.tensor(other)) == float("inf")
    assert cs.float_err(t, torch.tensor([0.0, 1.5, float("inf"), float("nan")])) == 0.5


def test_silu_on_meta_tensors_gives_shapes():
    """The dry-run traces the models on meta tensors: silu and its grad keep
    the shapes there, through the plain versions."""
    x = torch.empty(4, 8, dtype=torch.bfloat16, device="meta", requires_grad=True)
    y = PL.silu(x)
    y.sum().backward()
    assert y.device.type == x.grad.device.type == "meta" and y.shape == x.grad.shape == x.shape
