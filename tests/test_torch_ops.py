"""The port's composed ops (`repro_torch.kernels.ops`) on the CPU against
the JAX package's, and where the entry points run.

polymul / ntt_conv / ntt_conv_fixedpoint go through the same kernel
wrappers as on the card; on CPU tensors those run the kernels' plain
versions.  Inputs come from numpy with fixed seeds and go to both packages.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.ntt import make_context as ref_context
from repro.kernels import ops as jops
from repro_torch import kernels
from repro_torch.core import modmath as mm
from repro_torch.core.ntt import make_context, schoolbook_negacyclic
from repro_torch.kernels import ops, ref

Q = mm.DEFAULT_Q
CPU = "cpu"


def rand(shape, q=Q, seed=42):
    return np.random.default_rng(seed).integers(0, q, shape).astype(np.uint32)


# ---------------------------------------------------------------------------
# composed ops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [256, 2048])
def test_polymul_vs_schoolbook(n):
    a, b = rand(n, seed=n), rand(n, seed=n + 1)
    got = mm.to_numpy_u32(ops.polymul_ntt(a, b, make_context(Q, n), device=CPU))
    np.testing.assert_array_equal(got, schoolbook_negacyclic(a, b, Q))


def test_polymul_batched_matches_reference_ops():
    n = 512
    a, b = rand((4, n), seed=5), rand((4, n), seed=6)
    got = mm.to_numpy_u32(ops.polymul_ntt(a, b, make_context(Q, n), device=CPU))
    for i in range(4):
        np.testing.assert_array_equal(got[i], schoolbook_negacyclic(a[i], b[i], Q))
    np.testing.assert_array_equal(got, np.asarray(jops.polymul_ntt(a, b, ref_context(Q, n))))
    np.testing.assert_array_equal(mm.to_numpy_u32(ref.polymul_ref(a, b, make_context(Q, n))), got)


def test_polymul_two_regime_matches_reference_ops():
    n = 4096
    a, b = rand((2, n), seed=7), rand((2, n), seed=8)
    got = mm.to_numpy_u32(ops.ntt_conv(a, b, make_context(Q, n), tile=512, device=CPU))
    np.testing.assert_array_equal(got, np.asarray(jops.polymul_ntt(a, b, ref_context(Q, n), tile=512)))


@pytest.mark.parametrize("frac_bits", [8, 10])
def test_ntt_conv_fixedpoint_bit_equal(frac_bits):
    """Integers are exact and the scale is a power of two, so the float32
    result equals the reference's bit for bit (tolerance 0)."""
    n = 256
    rng = np.random.default_rng(3)
    u = rng.standard_normal(n).astype(np.float32)
    k = (rng.standard_normal(n) * 0.1).astype(np.float32)
    u[:4] = [0.5 / 2**frac_bits, 1.5 / 2**frac_bits, 2.5 / 2**frac_bits, -0.5 / 2**frac_bits]
    got = ops.ntt_conv_fixedpoint(u, k, make_context(Q, n), frac_bits=frac_bits, device=CPU)
    exp = np.asarray(jops.ntt_conv_fixedpoint(u, k, ref_context(Q, n), frac_bits=frac_bits))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)


def test_round_half_even_matches_jnp():
    v = np.array([0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(v)).numpy(), np.asarray(jax.numpy.round(v)))


# ---------------------------------------------------------------------------
# devices and wrapper checks
# ---------------------------------------------------------------------------


def test_numpy_input_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ctx = make_context(Q, 256)
    x = rand(256)
    for call in (lambda: ops.ntt(x, ctx), lambda: ops.intt(x, ctx),
                 lambda: ops.polymul_ntt(x, x, ctx), lambda: ops.ntt_conv_fixedpoint(x, x, ctx)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_cpu_tensor_stays_on_cpu_and_launches_nothing():
    kernels.reset_launch_counts()
    ctx = make_context(Q, 4096)
    x = torch.from_numpy(rand((2, 4096)))
    out = ops.polymul_ntt(x, x, ctx, tile=512)
    assert out.device.type == CPU
    assert kernels.launch_counts() == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0}
