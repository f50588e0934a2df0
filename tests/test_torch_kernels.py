"""The port's kernel entry points on the CPU against the JAX package.

On CPU tensors every wrapper runs its kernel's plain version over the same
tables and stage plans the card runs, so these cases exercise the port's
tiling, packing and stage order.  Inputs come from numpy with fixed seeds
and go to both packages; the JAX side runs its jnp oracles (jitted) and
its Pallas kernels in interpret mode, as `tests/test_kernels.py` does.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core.ntt import _np_stage as ref_np_stage
from repro.core.ntt import forward_stages as ref_forward_stages
from repro.core.ntt import inverse_stages as ref_inverse_stages
from repro.core.ntt import make_context as ref_context
from repro.kernels import ref as jref
from repro.kernels import ntt as jkntt
from repro.kernels.ntt import ntt_pallas
from repro_torch.core import modmath as mm
from repro_torch.core.ntt import device_tables, make_context, ntt_forward_np
from repro_torch.kernels import modmul as kmod
from repro_torch.kernels import ntt as kntt
from repro_torch.kernels import ops, ref

Q = mm.DEFAULT_Q
CPU = "cpu"

# (batch, n, tile): tests/test_kernels.py's SHAPES grid (its batch_block is a
# TPU grid size with no counterpart in the port), then shapes with 4, 5 and
# 6 inter-tile stages, which B2 runs as 1 and 2 grouped launches.
SHAPES = [
    (1, 256, None),
    (3, 512, None),
    (8, 1024, None),
    (5, 4096, None),
    (2, 4096, 512),
    (4, 8192, 1024),
    (1, 16384, 2048),
    (2, 16384, 4096),
    (2, 2048, 128),
    (1, 8192, 256),
    (2, 4096, 64),
]

_JIT_REF = {
    True: jax.jit(jref.ntt_forward_ref, static_argnums=1),
    False: jax.jit(jref.ntt_inverse_ref, static_argnums=1),
}


def rand(shape, q=Q, seed=42):
    return np.random.default_rng(seed).integers(0, q, shape).astype(np.uint32)


def port_ntt(x, q, forward=True, tile=None):
    fn = ops.ntt if forward else ops.intt
    out = fn(x, make_context(q, x.shape[-1]), tile=tile, device=CPU)
    assert out.dtype == torch.uint32 and out.device.type == CPU
    return mm.to_numpy_u32(out)


@pytest.mark.parametrize("batch,n,tile", SHAPES)
@pytest.mark.parametrize("forward", [True, False])
def test_ntt_matches_reference_ref(batch, n, tile, forward):
    x = rand((batch, n), seed=batch * n)
    exp = np.asarray(_JIT_REF[forward](x, ref_context(Q, n)))
    np.testing.assert_array_equal(port_ntt(x, Q, forward, tile), exp)


@pytest.mark.parametrize(
    "batch,n,tile", [(8, 1024, None), (2, 4096, 512), (4, 8192, 1024), (2, 2048, 128), (2, 4096, 64)]
)
@pytest.mark.parametrize("forward", [True, False])
def test_ntt_matches_pallas_interpret(batch, n, tile, forward):
    x = rand((batch, n), seed=n + forward)
    exp = np.asarray(ntt_pallas(x, ref_context(Q, n), forward=forward, tile=tile, interpret=True))
    np.testing.assert_array_equal(port_ntt(x, Q, forward, tile), exp)


@pytest.mark.parametrize("n,tile", [(1024, None), (8192, 1024), (65536, None), (65536, 65536)])
def test_ntt_roundtrip(n, tile):
    """n = 65536 runs the default tile (two regimes) and a tile request of
    65536, clamped to MAX_TILE = 32768 (one inter-tile stage)."""
    ctx = make_context(Q, n)
    x = rand((3, n) if n < 65536 else (1, n), seed=n)
    f = ops.ntt(x, ctx, tile=tile, device=CPU)
    np.testing.assert_array_equal(mm.to_numpy_u32(ops.intt(f, ctx, tile=tile)), x)
    if n == 65536:
        np.testing.assert_array_equal(mm.to_numpy_u32(f), ntt_forward_np(x, ctx))


@pytest.mark.parametrize("ratio", [2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("tile", [2, 64, 8192])
def test_inter_groups_and_launch_plan(ratio, tile):
    """The inter-tile stages of the JAX package's plans, cut into the fewest
    groups of at most PAIR_MAX_STAGES consecutive stages, evenly."""
    n = ratio * tile
    for forward, ref_plan in ((True, ref_forward_stages), (False, ref_inverse_stages)):
        groups = kntt.inter_groups(n, tile, forward)
        ref_inter = [(st.blocks, st.stride, st.tw_lo, st.gs) for st in ref_plan(n) if st.stride >= tile]
        flat = [(st.blocks, st.stride, st.tw_lo, st.gs) for g in groups for st in g]
        assert flat == ref_inter
        k = len(ref_inter)
        assert len(groups) == -(-k // kntt.PAIR_MAX_STAGES)
        sizes = [len(g) for g in groups]
        assert max(sizes) <= kntt.PAIR_MAX_STAGES and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)
    assert kntt.launch_plan(n, tile) == {"ntt_tile": 1, "ntt_pair": len(groups)}
    assert kntt.launch_plan(tile, tile) == {"ntt_tile": 1, "ntt_pair": 0}


def test_launch_plan_main_shapes():
    """Per transform: one B2 group of the 3 inter-tile stages and one B1 at
    n = 65536 (default tile 8192); the fused B1 alone at n = 4096."""
    assert kntt.launch_plan(65536) == {"ntt_tile": 1, "ntt_pair": 1}
    assert kntt.launch_plan(65536, 65536) == {"ntt_tile": 1, "ntt_pair": 1}
    assert kntt.launch_plan(4096) == {"ntt_tile": 1, "ntt_pair": 0}


@pytest.mark.parametrize("n,tile", [(64, 2), (1024, 16), (4096, 64)])
@pytest.mark.parametrize("forward", [True, False])
def test_grouped_pair_plain_equals_stage_loop(n, tile, forward):
    """B2's plain version over a group equals one stage at a time, and the
    whole chain equals the reference's stage loop over the same stages."""
    ctx = make_context(Q, n)
    tw, tw_sh = device_tables(ctx, CPU).for_direction(forward)
    x = torch.from_numpy(rand((3, n), seed=n))
    grouped, looped = x.clone(), x.clone()
    for group in kntt.inter_groups(n, tile, forward):
        kntt.ntt_pair_plain(grouped, grouped, tw, tw_sh, group, Q)
        for st in group:
            kntt.ntt_pair_plain(looped, looped, tw, tw_sh, [st], Q)
    assert torch.equal(grouped, looped)
    rctx = ref_context(Q, n)
    table = rctx.psi_brv if forward else rctx.psi_inv_brv
    exp = np.asarray(x.numpy())
    ref_plan = ref_forward_stages(n) if forward else ref_inverse_stages(n)
    for st in ref_plan:
        if st.stride >= tile:
            exp = ref_np_stage(exp, st, table, Q)
    np.testing.assert_array_equal(mm.to_numpy_u32(grouped), exp)


@pytest.mark.parametrize("n,tile", [(64, 2), (4096, 512), (65536, 8192)])
@pytest.mark.parametrize("forward", [True, False])
def test_packed_tables_hold_reference_twiddles(n, tile, forward):
    """B1's per-tile rows hold the twiddles of the JAX package's packing,
    each stage's slice at [blocks, 2 * blocks): the full table's layout."""
    rp, rp_sh, rstages = jkntt._pack_tile_stages(ref_context(Q, n), n, tile, forward)
    rows, rows_sh, stages = kntt._packed_tables(make_context(Q, n), tile, forward, torch.device(CPU))
    rows, rows_sh = mm.to_numpy_u32(rows), mm.to_numpy_u32(rows_sh)
    assert len(stages) == len(rstages)
    for st, rst in zip(stages, rstages):
        assert (st.blocks, st.stride, st.gs) == (rst.blocks, rst.stride, rst.gs) and st.tw_lo == st.blocks
        ref = slice(rst.tw_lo, rst.tw_lo + rst.blocks)
        np.testing.assert_array_equal(rows[:, st.blocks : 2 * st.blocks], rp[:, ref])
        np.testing.assert_array_equal(rows_sh[:, st.blocks : 2 * st.blocks], rp_sh[:, ref])


def test_tile_clamped_to_shared_memory():
    assert kntt.resolve_tile(None, 65536) == 8192
    assert kntt.resolve_tile(65536, 65536) == kntt.MAX_TILE == 32768
    assert kntt.resolve_tile(None, 1024) == 1024
    with pytest.raises(ValueError, match="power of two"):
        kntt.resolve_tile(3000, 4096)


def test_ntt_1d_input():
    x = rand(512)
    got = port_ntt(x, Q)
    assert got.shape == (512,)
    np.testing.assert_array_equal(got, np.asarray(_JIT_REF[True](x, ref_context(Q, 512))))


@pytest.mark.parametrize("q", [998244353, 469762049, mm.find_ntt_prime(2**15, bits=30)])
def test_ntt_other_primes(q):
    n = 1024
    x = rand((2, n), q=q)
    got = port_ntt(x, q)
    np.testing.assert_array_equal(got, np.asarray(_JIT_REF[True](x, ref_context(q, n))))
    np.testing.assert_array_equal(port_ntt(got, q, forward=False), x)


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ntt_linearity(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, Q, (1, n)).astype(np.uint32)
    b = rng.integers(0, Q, (1, n)).astype(np.uint32)
    fa = port_ntt(a, Q).astype(np.int64)
    fb = port_ntt(b, Q).astype(np.int64)
    ab = ((a.astype(np.int64) + b) % Q).astype(np.uint32)
    np.testing.assert_array_equal(port_ntt(ab, Q).astype(np.int64), (fa + fb) % Q)


def test_ntt_delta_transform():
    """NTT(delta_0) = all-ones (psi^0 * w^0 = 1 in every output)."""
    delta = np.zeros((1, 512), np.uint32)
    delta[0, 0] = 1
    np.testing.assert_array_equal(port_ntt(delta, Q), np.ones((1, 512), np.uint32))


def test_ntt_leaves_input_unchanged():
    ctx = make_context(Q, 4096)
    x = torch.from_numpy(rand((2, 4096)))
    before = x.clone()
    for tile in (None, 512):
        ops.ntt(x, ctx, tile=tile)
        ops.intt(x, ctx, tile=tile)
    assert torch.equal(x, before)


# ---------------------------------------------------------------------------
# modmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(17,), (2, 1000), (3, 4, 256), (1, 65536)])
def test_modmul_matches_ref(shape):
    ctx, rctx = make_context(Q, 256), ref_context(Q, 256)
    a, b = rand(shape, seed=1), rand(shape, seed=2)
    got = mm.to_numpy_u32(kmod.modmul_cuda(torch.from_numpy(a), torch.from_numpy(b), ctx))
    np.testing.assert_array_equal(got, np.asarray(jref.modmul_ref(a, b, rctx)))
    np.testing.assert_array_equal(got.astype(object), (a.astype(object) * b.astype(object)) % Q)
    np.testing.assert_array_equal(mm.to_numpy_u32(ref.modmul_ref(a, b, ctx)), got)


# ---------------------------------------------------------------------------
# wrapper checks
# ---------------------------------------------------------------------------


def test_wrappers_reject_bad_inputs():
    ctx = make_context(Q, 256)
    good = torch.from_numpy(rand((2, 256)))
    with pytest.raises(TypeError, match="uint32"):
        kntt.ntt_cuda(good.view(torch.int32), ctx)
    with pytest.raises(ValueError, match="contiguous"):
        kntt.ntt_cuda(torch.from_numpy(rand((256, 2))).t(), ctx)
    with pytest.raises(ValueError, match="expected"):
        kntt.ntt_cuda(torch.from_numpy(rand((2, 128))), ctx)
    with pytest.raises(TypeError, match="Tensor"):
        kntt.ntt_cuda(rand((2, 256)), ctx)
    with pytest.raises(ValueError, match="shapes differ"):
        kmod.modmul_cuda(good, good[:1].contiguous(), ctx)
    tw, tw_sh = kntt.device_tables(ctx, CPU).for_direction(True)
    with pytest.raises(ValueError, match="twiddle tables"):
        kntt._tile_pass(good, torch.empty_like(good), tw[:128], tw_sh, [], 256, Q)
    with pytest.raises(ValueError, match="does not fit"):
        stage = kntt.forward_stages(256)[0]
        kntt._pair_pass(good, torch.empty_like(good), tw, tw_sh,
                        [kntt.Stage(stage.blocks, stage.stride * 2, stage.tw_lo, False)], Q)


def test_wrappers_reject_other_plans():
    """B1 runs only the whole run of strides < tile and B2 only groups of
    1 to PAIR_MAX_STAGES consecutive stages: any other plan raises, on the
    CPU as on the card."""
    ctx = make_context(Q, 256)
    x = torch.from_numpy(rand((2, 256)))
    out = torch.empty_like(x)
    tw, tw_sh = kntt.device_tables(ctx, CPU).for_direction(True)
    fwd, inv = kntt.forward_stages(256), kntt.inverse_stages(256)
    with pytest.raises(ValueError, match="every stride"):
        kntt._tile_pass(x, out, tw, tw_sh, fwd[1:], 256, Q)  # not the whole run
    with pytest.raises(ValueError, match="every stride"):
        kntt._tile_pass(x, out, tw, tw_sh, fwd[::-1], 256, Q)  # CT going up
    with pytest.raises(ValueError, match="one direction"):
        kntt._tile_pass(x, out, tw, tw_sh, fwd[:4] + inv[4:], 256, Q)
    with pytest.raises(ValueError, match="1 to 4 stages"):
        kntt._pair_pass(x, out, tw, tw_sh, fwd[:5], Q)
    with pytest.raises(ValueError, match="1 to 4 stages"):
        kntt._pair_pass(x, out, tw, tw_sh, (), Q)
    with pytest.raises(ValueError, match="consecutive"):
        kntt._pair_pass(x, out, tw, tw_sh, (fwd[0], fwd[2]), Q)
    with pytest.raises(ValueError, match="consecutive"):
        kntt._pair_pass(x, out, tw, tw_sh, fwd[1::-1], Q)  # CT going up
    with pytest.raises(ValueError, match="one direction"):
        kntt._pair_pass(x, out, tw, tw_sh, (inv[6], fwd[0]), Q)
    packed, packed_sh, ref_layout = kntt._pack_tile_stages(ctx, 256, 64, True)
    with pytest.raises(ValueError, match="full table's layout"):
        kntt._tile_pass(x, out, torch.from_numpy(packed.reshape(-1)),
                        torch.from_numpy(packed_sh.reshape(-1)), ref_layout, 64, Q)
    with pytest.raises(ValueError, match="full table's layout"):
        kntt._pair_pass(x, out, tw, tw_sh, [kntt.Stage(1, 128, 0, False)], Q)
    kntt._pair_pass(x, out, tw, tw_sh, fwd[:4], Q)  # a whole group runs
    kntt._tile_pass(x, out, tw, tw_sh, fwd, 256, Q)
