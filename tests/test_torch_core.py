"""The port's host core (`repro_torch.core`) against the JAX package's.

Contexts and packed tile tables must be byte-equal, and the int64 torch
twins of the uint32 device arithmetic must equal `repro.core.modmath`'s
uint32 functions on the same inputs (made with numpy from a fixed seed).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import modmath as jmm
from repro.core import ntt as jntt
from repro.he import rns_primes
from repro.kernels import ntt as jkntt
from repro_torch.core import modmath as mm
from repro_torch.core import ntt as tntt
from repro_torch.kernels import ntt as kntt

Q = mm.DEFAULT_Q
ALT_PRIMES = [998244353, 469762049, jmm.find_ntt_prime(2**15, bits=30)]
CONTEXT_CASES = (
    [(Q, 256), (Q, 1024), (Q, 4096)]
    + [(q, 1024) for q in ALT_PRIMES]
    + [(q, 1024) for q in rns_primes(1024, 8)]
)
TABLES = ("psi_brv", "psi_brv_shoup", "psi_inv_brv", "psi_inv_brv_shoup")
SCALARS = ("q", "n", "psi", "psi_inv", "n_inv", "n_inv_shoup", "qprime", "r2_mod_q")


def assert_same_context(port, ref):
    for f in SCALARS:
        assert getattr(port, f) == getattr(ref, f), f
    for f in TABLES:
        a, b = getattr(port, f), getattr(ref, f)
        assert a.dtype == b.dtype == np.uint32, f
        assert a.tobytes() == b.tobytes(), f


@pytest.mark.parametrize("q,n", CONTEXT_CASES)
def test_make_context_byte_equal(q, n):
    ref = jntt.make_context(q, n)
    assert_same_context(tntt.make_context(q, n), ref)
    carried = tntt.context_from_reference(ref)
    assert_same_context(carried, ref)
    assert carried.omega == ref.omega


def test_context_from_reference_checks_tables():
    ref = jntt.make_context(Q, 256)
    short = dataclasses.replace(ref, psi_brv=ref.psi_brv[:128])
    with pytest.raises(ValueError, match="psi_brv has shape"):
        tntt.context_from_reference(short)


def test_device_tables_cached_per_q_n_device():
    ctx = tntt.make_context(Q, 512)
    tabs = tntt.device_tables(ctx, "cpu")
    assert tntt.device_tables(tntt.context_from_reference(ctx), "cpu") is tabs
    for f in TABLES:
        t = getattr(tabs, f)
        assert t.dtype == torch.uint32 and t.is_contiguous()
        assert np.array_equal(mm.to_numpy_u32(t), getattr(ctx, f))
    assert tabs.for_direction(False) == (tabs.psi_inv_brv, tabs.psi_inv_brv_shoup)


@pytest.mark.parametrize("n,tile", [(4096, 512), (8192, 1024), (16384, 2048), (65536, 8192)])
@pytest.mark.parametrize("forward", [True, False])
def test_pack_tile_stages_byte_equal(n, tile, forward):
    packed, packed_sh, stages = kntt._pack_tile_stages(tntt.make_context(Q, n), n, tile, forward)
    rp, rp_sh, rstages = jkntt._pack_tile_stages(jntt.make_context(Q, n), n, tile, forward)
    assert packed.tobytes() == rp.tobytes() and packed.shape == rp.shape
    assert packed_sh.tobytes() == rp_sh.tobytes()
    assert [dataclasses.astuple(s) for s in stages] == [dataclasses.astuple(s) for s in rstages]


@pytest.mark.parametrize("n", [2, 16, 1024, 65536])
def test_stage_plans_equal(n):
    for port_fn, ref_fn in ((tntt.forward_stages, jntt.forward_stages),
                            (tntt.inverse_stages, jntt.inverse_stages)):
        assert [dataclasses.astuple(s) for s in port_fn(n)] == [
            dataclasses.astuple(s) for s in ref_fn(n)
        ]


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def test_host_helpers_equal():
    for v in [0, 1, 2, 97, 561, 7919, Q, Q + 2, 2**31 - 1, 2**61 - 1]:
        assert mm.is_prime(v) == jmm.is_prime(v), v
    for two_n, bits in [(2**11, 31), (2**15, 30), (2**17, 31)]:
        assert mm.find_ntt_prime(two_n, bits) == jmm.find_ntt_prime(two_n, bits)
    for q in [Q, *ALT_PRIMES]:
        assert mm.primitive_root(q) == jmm.primitive_root(q)
        assert mm.root_of_unity(q, 1024) == jmm.root_of_unity(q, 1024)
        assert mm.mont_params(q) == jmm.mont_params(q)
        assert mm.inv_mod(12345, q) == jmm.inv_mod(12345, q)
        assert mm.shoup(q - 1, q) == jmm.shoup(q - 1, q)
    assert np.array_equal(mm.powers_of(31, 100, Q), jmm.powers_of(31, 100, Q))
    for n in [1, 2, 8, 1024]:
        assert np.array_equal(mm.bit_reverse_indices(n), jmm.bit_reverse_indices(n))
    with pytest.raises(ValueError):
        mm.root_of_unity(Q, 7)


def test_np_ops_equal():
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, Q, (2, 500))
    for name in ("np_mulmod", "np_addmod", "np_submod"):
        assert np.array_equal(getattr(mm, name)(a, b, Q), getattr(jmm, name)(a, b, Q)), name
    assert np.array_equal(mm.np_powmod(3, a[:20], Q), jmm.np_powmod(3, a[:20], Q))


# ---------------------------------------------------------------------------
# int64 twins vs the reference's uint32 device functions
# ---------------------------------------------------------------------------


def _t(v):
    return mm.as_i64(torch.from_numpy(np.ascontiguousarray(v, np.uint32)))


def _u(t):
    return mm.to_u32(t).numpy()


def test_u32_conversions_roundtrip():
    v = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)
    t = _t(v)
    assert t.dtype == torch.int64 and t.tolist() == [int(x) for x in v]
    assert np.array_equal(_u(t), v)
    with pytest.raises(TypeError):
        mm.as_i64(torch.zeros(3, dtype=torch.float32))


def test_mulhi_mullo_full_range():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    edge = np.array([0, 1, 2**16 - 1, 2**16, 2**31, 2**32 - 1], np.uint32)
    a = np.concatenate([a, np.repeat(edge, edge.size)])
    b = np.concatenate([b, np.tile(edge, edge.size)])
    assert np.array_equal(_u(mm.mulhi_u32(_t(a), _t(b))), np.asarray(jmm.mulhi_u32(a, b)))
    assert np.array_equal(_u(mm.mullo_u32(_t(a), _t(b))), np.asarray(jmm.mullo_u32(a, b)))
    exact = (a.astype(object) * b.astype(object)) >> 32
    assert np.array_equal(_u(mm.mulhi_u32(_t(a), _t(b))).astype(object), exact)


TWINS = ["addmod", "submod", "shoup_mulmod", "mont_mul", "mulmod", "to_mont", "from_mont"]


def _call(lib, name, a, b, w_sh, ctx):
    q, qp, r2 = ctx.q, ctx.qprime, ctx.r2_mod_q
    return {
        "addmod": lambda: lib.addmod_u32(a, b, q),
        "submod": lambda: lib.submod_u32(a, b, q),
        "shoup_mulmod": lambda: lib.shoup_mulmod_u32(a, b, w_sh, q),
        "mont_mul": lambda: lib.mont_mul_u32(a, b, q, qp),
        "mulmod": lambda: lib.mulmod_u32(a, b, q, qp, r2),
        "to_mont": lambda: lib.to_mont_u32(a, q, qp, r2),
        "from_mont": lambda: lib.from_mont_u32(a, q, qp),
    }[name]()


@pytest.mark.parametrize("name", TWINS)
@pytest.mark.parametrize("q", [Q, ALT_PRIMES[0], ALT_PRIMES[2]])
def test_twin_matches_reference_u32(name, q):
    ctx = jntt.make_context(q, 256)
    rng = np.random.default_rng([TWINS.index(name), q])
    edge = np.array([0, 1, q - 1], np.uint32)
    a = np.concatenate([rng.integers(0, q, 2000).astype(np.uint32), np.repeat(edge, 3)])
    b = np.concatenate([rng.integers(0, q, 2000).astype(np.uint32), np.tile(edge, 3)])
    w_sh = np.array([jmm.shoup(int(w), q) for w in b], np.uint32)
    got = _u(_call(mm, name, _t(a), _t(b), _t(w_sh), ctx))
    exp = np.asarray(_call(jmm, name, a, b, w_sh, ctx))
    assert np.array_equal(got, exp)
    assert got.max() < q


# ---------------------------------------------------------------------------
# oracles and stage loops
# ---------------------------------------------------------------------------


def test_oracles_equal_reference():
    rng = np.random.default_rng(2)
    n = 64
    ctx, rctx = tntt.make_context(Q, n), jntt.make_context(Q, n)
    a, b = rng.integers(0, Q, (2, n)).astype(np.uint32)
    assert np.array_equal(tntt.naive_negacyclic_ntt(a, ctx), jntt.naive_negacyclic_ntt(a, rctx))
    assert np.array_equal(tntt.schoolbook_negacyclic(a, b, Q), jntt.schoolbook_negacyclic(a, b, Q))
    assert np.array_equal(tntt.cyclic_ntt_np(a, Q), tntt.naive_cyclic_ntt(a, Q, rctx.omega))
    assert np.array_equal(tntt.four_step_cyclic_np(a, Q, 8, 8), jntt.four_step_cyclic_np(a, Q, 8, 8))


@pytest.mark.parametrize("n", [256, 2048])
def test_stage_loops_equal_reference(n):
    rng = np.random.default_rng(n)
    ctx, rctx = tntt.make_context(Q, n), jntt.make_context(Q, n)
    a, b = rng.integers(0, Q, (2, 3, n)).astype(np.uint32)
    fwd = jntt.ntt_forward_np(a, rctx)
    assert np.array_equal(tntt.ntt_forward_np(a, ctx), fwd)
    assert np.array_equal(tntt.ntt_inverse_np(fwd, ctx), a)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.array_equal(mm.to_numpy_u32(tntt.ntt_forward_torch(ta, ctx)), fwd)
    assert np.array_equal(
        mm.to_numpy_u32(tntt.ntt_inverse_torch(torch.from_numpy(fwd), ctx)),
        np.asarray(jax.jit(jntt.ntt_inverse_jnp, static_argnums=1)(fwd, rctx)),
    )
    exp = jntt.polymul_negacyclic_np(a, b, rctx)
    assert np.array_equal(tntt.polymul_negacyclic_np(a, b, ctx), exp)
    assert np.array_equal(mm.to_numpy_u32(tntt.polymul_negacyclic_torch(ta, tb, ctx)), exp)
