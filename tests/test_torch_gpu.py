"""The port's CUDA kernels on the card, against their plain torch versions.

Run on a machine with a CUDA card:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Without a card every test skips (the `cuda` fixture decides, at run time).
Nothing here imports `jax` or `repro`: the oracles are the port's plain
versions and its numpy stage loop.
"""
import numpy as np
import pytest
import torch

from repro_torch import he, kernels
from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_core
from repro_torch.kernels import modmul as kmod
from repro_torch.kernels import ntt as kntt
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

Q = mm.DEFAULT_Q
# (batch, n, tile): small, then the shapes of chip_smoke.py's main path;
# tile 65536 is clamped to 32768 (128 KiB of shared memory per CTA).  Then
# edge cases of the grouped kernels: tiles 2 to 128, where B1's register
# groups meet the tile's edge and stage counts are not a multiple of the
# group size, and n / tile of 8, 16, 32 and 64 (3 to 6 inter-tile stages,
# at most 4 per B2 launch).
NTT_SHAPES = [(4, 1024, None), (2, 16384, 2048), (1024, 4096, None), (64, 65536, 8192),
              (2, 65536, 65536), (3, 2, None), (5, 16, None), (3, 64, 2), (3, 256, 8),
              (2, 1024, 16), (5, 512, 32), (3, 128, 64), (2, 4096, 64), (2, 2048, 128),
              (1, 32768, None)]
MODMUL_SHAPES = [(3, 1000), (64, 65536)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def residues(shape, device, seed):
    return mm.to_device_u32(np.random.default_rng(seed).integers(0, Q, shape), device)


def same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def launches(ctx, forward, tile, device):
    """(kernel name, run kernel, run plain) for each launch of one transform."""
    n = ctx.n
    tw, tw_sh = ntt_core.device_tables(ctx, device).for_direction(forward)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    plan = ntt_core.forward_stages(n) if forward else ntt_core.inverse_stages(n)
    if tile >= n:
        args = (tw, tw_sh, plan, n, ctx.q, scale)
        return [("ntt_tile", kntt._tile_pass, kntt.ntt_tile_plain, args)]
    packed, packed_sh, local = kntt._packed_tables(ctx, tile, forward, device)
    out = [("ntt_tile", kntt._tile_pass, kntt.ntt_tile_plain,
            (packed, packed_sh, local, tile, ctx.q, None))]
    groups = kntt.inter_groups(n, tile, forward)
    for i, group in enumerate(groups):
        s = scale if (not forward and i == len(groups) - 1) else None
        out.append(("ntt_pair", kntt._pair_pass, kntt.ntt_pair_plain, (tw, tw_sh, group, ctx.q, s)))
    return out


@pytest.mark.parametrize("batch,n,tile", NTT_SHAPES)
@pytest.mark.parametrize("forward", [True, False])
def test_ntt_kernels_match_plain(cuda, batch, n, tile, forward):
    ctx = ntt_core.make_context(Q, n)
    for i, (name, kernel, plain, args) in enumerate(launches(ctx, forward, kntt.resolve_tile(tile, n), cuda)):
        src = residues((batch, n), cuda, seed=i)
        got, exp = torch.empty_like(src), torch.empty_like(src)
        kernel(src, got, *args)
        plain(src, exp, *args)
        torch.cuda.synchronize()
        assert same(got, exp), (name, i)
        in_place = src.clone()
        kernel(in_place, in_place, *args)
        assert same(in_place, exp), (name, i, "in place")
        # one word past a 16-byte boundary: the kernels' 4-byte access paths
        buf = torch.empty(src.numel() + 1, dtype=src.dtype, device=cuda)
        odd = buf[1:].view(src.shape)
        odd.copy_(src)
        kernel(odd, odd, *args)
        assert same(odd, exp), (name, i, "misaligned")


@pytest.mark.parametrize("batch,n,tile", NTT_SHAPES)
def test_ntt_cuda_matches_cpu_path(cuda, batch, n, tile):
    ctx = ntt_core.make_context(Q, n)
    x = np.random.default_rng(n).integers(0, Q, (batch, n)).astype(np.uint32)
    for forward in (True, False):
        fn = ops.ntt if forward else ops.intt
        got = fn(x, ctx, tile=tile)
        assert got.device.type == "cuda"
        exp = fn(x, ctx, tile=tile, device="cpu")
        assert np.array_equal(mm.to_numpy_u32(got), mm.to_numpy_u32(exp)), forward


@pytest.mark.parametrize("shape", MODMUL_SHAPES)
def test_modmul_kernel_matches_plain(cuda, shape):
    ctx = ntt_core.make_context(Q, 256)
    a, b = residues(shape, cuda, 1), residues(shape, cuda, 2)
    got = kmod.modmul_cuda(a, b, ctx)
    assert same(got, kmod.modmul_plain(a, b, ctx))
    exact = (mm.to_numpy_u32(a).astype(object) * mm.to_numpy_u32(b).astype(object)) % Q
    assert np.array_equal(mm.to_numpy_u32(got).astype(object), exact)


@pytest.mark.parametrize("batch,n", [(4, 1024), (1024, 4096), (64, 65536)])
def test_polymul_matches_numpy_oracle(cuda, batch, n):
    ctx = ntt_core.make_context(Q, n)
    rng = np.random.default_rng(batch + n)
    a = rng.integers(0, Q, (batch, n)).astype(np.uint32)
    b = rng.integers(0, Q, (batch, n)).astype(np.uint32)
    kernels.reset_launch_counts()
    out = mm.to_numpy_u32(ops.polymul_ntt(a, b, ctx))
    counts = kernels.launch_counts()
    plan = kntt.launch_plan(n)
    assert counts == {"ntt_tile": 3 * plan["ntt_tile"], "ntt_pair": 3 * plan["ntt_pair"], "modmul": 1}
    rows = rng.choice(batch, size=min(4, batch), replace=False)
    assert np.array_equal(out[rows], ntt_core.polymul_negacyclic_np(a[rows], b[rows], ctx))


def test_tables_on_another_device_raise(cuda):
    ctx = ntt_core.make_context(Q, 1024)
    x = residues((2, 1024), cuda, 0)
    tw, tw_sh = ntt_core.device_tables(ctx, "cpu").for_direction(True)
    with pytest.raises(ValueError, match="is on"):
        kntt._tile_pass(x, torch.empty_like(x), tw, tw_sh, ntt_core.forward_stages(1024), 1024, Q)


def test_rns_ct_mul_relin_and_rescale_match_cpu_path(cuda):
    """ct_mul_relin + rescale at n = 4096, L = 4 on the card against the
    same ops on the CPU plain path, the key copied over."""
    basis = he.make_basis(4096, 4)
    rlk = he.relin_key(basis, he.make_secret(basis, 0), seed=1)
    a, b = he.random_ct(basis, 1), he.random_ct(basis, 2)
    kernels.reset_launch_counts()
    out = he.rescale(basis, he.ct_mul_relin(basis, a, b, rlk))
    torch.cuda.synchronize()
    plan = kntt.launch_plan(4096)
    assert kernels.launch_counts() == {"ntt_tile": 16 * plan["ntt_tile"], "ntt_pair": 16 * plan["ntt_pair"],
                                       "modmul": 8}
    assert out.device.type == "cuda" and tuple(out.shape) == (2, 3, 4096)

    def cpu(t):
        return t.view(torch.int32).cpu().view(torch.uint32)

    cpu_key = he.KeySwitchKey(basis, cpu(rlk.b), cpu(rlk.a))
    exp = he.rescale(basis, he.ct_mul_relin(basis, cpu(a), cpu(b), cpu_key))
    assert np.array_equal(mm.to_numpy_u32(out), mm.to_numpy_u32(exp))
    assert np.array_equal(mm.to_numpy_u32(rlk.b_hat), mm.to_numpy_u32(cpu_key.b_hat))


def numpy_chain(b0, pn, n, t_bus):
    """`np.cumsum` over [b0, pn[0], t_bus, pn[0], t_bus, ...] (each round time n times)."""
    inc = np.empty(1 + 2 * len(pn) * n)
    inc[0] = b0
    inc[1::2] = np.repeat(pn, n)
    inc[2::2] = t_bus
    return np.cumsum(inc)


@pytest.mark.parametrize("k,n", [(0, 4), (1, 1), (5, 8), (96, 16)])
def test_chain_fold_matches_np_cumsum(cuda, k, n):
    """`chain_fold` on the card, the round trip and the kernel alone: a
    strict left fold, `==` to `np.cumsum`."""
    from repro_torch.kernels import fold

    pn = np.random.default_rng(k).uniform(0.0, 60.0, k)
    exp = numpy_chain(12.5, pn, n, 1.25)
    fold.LAUNCHES["chain_fold"] = 0
    assert np.array_equal(fold.chain_fold(12.5, pn, n, 1.25, cuda), exp)
    assert fold.LAUNCHES["chain_fold"] == 1
    out = torch.empty(len(exp), dtype=torch.float64, device=cuda)
    fold.chain_fold_cuda(torch.from_numpy(pn).to(cuda), out, 12.5, n, 1.25)
    assert np.array_equal(out.cpu().numpy(), exp)


def test_chain_fold_round_trips_reuse_the_pinned_buffers(cuda):
    """Chains of different lengths in a row (the third grows the buffers):
    each right, and each result independent of the chains after it."""
    from repro_torch.kernels import fold

    rng = np.random.default_rng(5)
    cases = [(3.0, rng.uniform(0.0, 60.0, 96), 16, 1.25), (7.0, rng.uniform(0.0, 9.0, 3), 2, 0.5),
             (1.0, rng.uniform(0.0, 60.0, 512), 32, 2.5), (4.0, rng.uniform(0.0, 60.0, 5), 8, 1.25)]
    got = [fold.chain_fold(*case, device=cuda) for case in cases]
    for case, g in zip(cases, got):
        assert np.array_equal(g, numpy_chain(*case))


def test_chain_fold_round_trip_is_one_per_card_on_its_own_stream(cuda):
    """None, "cuda" and "cuda:<current>" share one round trip, which runs on
    its own stream: a chain made under another current stream is right."""
    from repro_torch.kernels import fold

    index = torch.cuda.current_device()
    rt = fold.round_trip(None)
    assert rt is fold.round_trip("cuda") is fold.round_trip(torch.device("cuda", index))
    pn = np.random.default_rng(9).uniform(0.0, 60.0, 40)
    with torch.cuda.stream(torch.cuda.Stream(cuda)):
        got = fold.chain_fold(2.0, pn, 3, 1.25, cuda)
    assert rt.handle != torch.cuda.current_stream(cuda).cuda_stream
    assert np.array_equal(got, numpy_chain(2.0, pn, 3, 1.25))


def test_fastpath_torch_backend_on_the_card(cuda):
    from repro_torch.core.mapping import RowCentricMapper
    from repro_torch.core.pim_config import PimConfig
    from repro_torch.pimsys import evaluate_gang, lower_commands, param_beat_trace

    cfg = PimConfig(num_buffers=4, param_cache_entries=32)
    cmds = RowCentricMapper(cfg, 256).commands()
    lp = lower_commands(cfg, cmds, param_beat_trace(cfg, 256, cmds))
    for banks in (2, 8):
        a = evaluate_gang(lp, banks)
        b = evaluate_gang(lp, banks, backend="torch")  # the card by default
        assert a.makespan_ns == b.makespan_ns and a.counters == b.counters
        assert np.array_equal(a.starts, b.starts) and np.array_equal(a.dones, b.dones)


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-1.5-large-398b", "whisper-small"])
def test_reduced_arch_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced arch on the card against the CPU on the same weights, with
    the whole-model bound of tests/test_torch_models.py; and `serve` on the
    card by default."""
    import importlib.util
    import pathlib

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    out = cs.card_vs_cpu(get_config(arch).reduced(capacity_factor=8.0), cuda)
    assert out["finite"] and out["max_rel_err"] <= out["tol"]
    res = serve(arch, batch=2, prompt_len=8, gen=3)
    assert res["device"].startswith("cuda") and res["generated"].shape == (2, 3)


NCCL_STEP = '''
def body(rank, world, tmp):
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(SRC, "..", "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rec = cs.drive_dist_step("cuda", batch=2, seq=64, steps=3, reduced=True)
    return {"equal": rec["equal_to_unsharded"], "backend": rec["backend"], "mismatches": rec["compression"]["mismatches"]}
'''


def test_sharded_step_over_nccl_equals_the_unsharded_step(cuda, tmp_path):
    """NCCL at world size 1 (a child interpreter: the pytest process opens
    no process group): the collectives equal the codec and the sharded step
    equals the unsharded one bit for bit, at reduced qwen3-4b."""
    from torch_dist import run_child

    [rec] = run_child(tmp_path, NCCL_STEP, world=1, backend="nccl", timeout=300)
    assert rec["backend"] == "nccl" and rec["mismatches"] == []
    assert rec["equal"]["unequal_leaves"] == [] and rec["equal"]["loss"] and rec["equal"]["grad_norm"]


#: silu's inputs on the card: (shape, the part of the last dim read or None):
#: qwen3-4b's MLP hidden at decode and train, mamba2-780m's gate z read in
#: its projection, and a ragged slice.
SILU_CASES = [((4, 1, 9728), None), ((4, 512, 9728), None), ((4, 512, 6448), 3072), ((3, 7, 2049), 2000)]


@pytest.mark.parametrize("shape,cols", SILU_CASES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_silu_kernels_match_plain(cuda, shape, cols, dtype):
    """`silu_fwd` / `silu_bwd` on the card equal their plain versions on the
    same inputs bit for bit, one launch each."""
    from repro_torch.kernels import silu as ks

    rng = np.random.default_rng(0)
    a = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(cuda, dtype)
    a = a if cols is None else a[..., :cols]
    h = torch.from_numpy(rng.standard_normal(a.shape).astype(np.float32)).to(cuda, dtype)
    before = dict(ks.LAUNCHES)
    y, g = ks.silu_fwd(a), ks.silu_bwd(a, h)
    torch.cuda.synchronize()
    assert {k: ks.LAUNCHES[k] - before[k] for k in before} == {"silu_fwd": 1, "silu_bwd": 1}
    assert torch.equal(y, ks.silu_fwd_plain(a)) and torch.equal(g, ks.silu_bwd_plain(a, h))


def test_silu_kernels_on_every_bf16_value(cuda):
    """Every bf16 value (subnormals, infinities, nans) through the kernels
    and the autograd Function, against the plain versions: equal bits where
    not nan, nan where nan."""
    from repro_torch.kernels import silu as ks
    from repro_torch.models import layers

    x = torch.from_numpy((np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)).to(cuda, torch.bfloat16)
    h = x.flip(0)
    a = x.clone().requires_grad_()
    y = layers.silu(a)
    y.backward(h)
    for got, exp in ((y.detach(), ks.silu_fwd_plain(x)), (a.grad, ks.silu_bwd_plain(x, h))):
        nan = exp.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan].view(torch.int16), exp[~nan].view(torch.int16))



def test_silu_fwd_on_every_bf16_value_and_a_misaligned_slice(cuda):
    """`silu_fwd` (its table) on every bf16 value, and on a column slice
    whose start and row stride are not 16-byte aligned (the 16-byte vectors'
    scalar heads and tails, stores one by one), against the plain version:
    equal bits where not nan, nan where nan."""
    from repro_torch.kernels import silu as ks

    x = torch.from_numpy((np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)).to(cuda, torch.bfloat16)
    sliced = torch.from_numpy((np.random.default_rng(1).standard_normal((4, 64, 3335)) * 3).astype(np.float32))
    for a in (x, sliced.to(cuda, torch.bfloat16)[..., 5:3333]):
        got, exp = ks.silu_fwd(a), ks.silu_fwd_plain(a)
        nan = exp.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan].view(torch.int16), exp[~nan].view(torch.int16))

def test_silu_bwd_on_every_bf16_value_against_every_cotangent_class_and_other_phases(cuda):
    """`silu_bwd` (its (d, c) table and packed ops, elements within 2^-126
    re-done by the exact ops) on every bf16 a against cotangents of every
    magnitude class, both signs (zero, subnormal, at and beside 2^-126,
    huge, inf, NaN), and with a, h and the output at different 16-byte
    phases, against the plain version: equal bits where not nan, nan where
    nan."""
    from repro_torch.kernels import silu as ks

    classes = [0x0000, 0x0001, 0x0020, 0x007F, 0x0080, 0x0081, 0x0100, 0x0380, 0x0400, 0x0C00, 0x3F80, 0x4A00,
               0x7000, 0x7F7F, 0x7F80, 0x7FC0]
    hs = np.array(classes + [b | 0x8000 for b in classes], dtype=np.uint16)
    every = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    a = torch.from_numpy(np.tile(every, (len(hs), 1))).to(cuda, torch.bfloat16)
    h = torch.from_numpy(np.repeat(hs[:, None], 1 << 16, axis=1).astype(np.int16)).to(cuda).view(torch.bfloat16)
    rng = np.random.default_rng(2)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32)).to(cuda, torch.bfloat16)

    buf_a, buf_h = draw(4 * 64 * 3072 + 8), draw(4 * 64 * 3072 + 8)
    shifted = [(buf_a[5:5 + 4 * 64 * 3072].view(4, 64, 3072), buf_h[2:2 + 4 * 64 * 3072].view(4, 64, 3072)),
               (draw(4, 64, 6448)[..., 1:3073], draw(4, 64, 3072))]
    for x, ct in [(a, h), *shifted]:
        got, exp = ks.silu_bwd(x, ct), ks.silu_bwd_plain(x, ct)
        nan = exp.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(got[~nan].view(torch.int16), exp[~nan].view(torch.int16))


def test_ssd_head_split_is_exact_on_the_card(cuda):
    """The SSD's heads split into the runs of 4 and 2 ranks on one card,
    forward and backward, equal to the whole call bit for bit
    (`parallel_check.ssd_head_split`, chip_smoke.py's part `ssd_head_split`)."""
    from repro_torch.launch import parallel_check as pc

    for name, arch, full, batch, seq in pc.SSD_SPLITS:
        for runs in (4, 2):
            out = pc.ssd_head_split(arch, runs, cuda, full, batch, seq)
            assert out["exact"], (name, runs, {k: v for k, v in out["tensors"].items() if not v["equal"]})


#: softplus's inputs on the card: mamba2-780m's dt at train and decode, and
#: a ragged column slice read as rows.
SOFTPLUS_CASES = [((4, 512, 48), None), ((4, 48), None), ((3, 7, 2049), 2000)]


@pytest.mark.parametrize("shape,cols", SOFTPLUS_CASES)
def test_softplus_kernels_match_plain(cuda, shape, cols):
    """`softplus_fwd` / `softplus_bwd` on the card equal their plain
    versions on the same inputs bit for bit, one launch each; through the
    SSD's `_softplus` and autograd too."""
    from repro_torch.kernels import softplus as ksp
    from repro_torch.models import ssm

    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 8).astype(np.float32)).to(cuda)
    x = x if cols is None else x[..., :cols]
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)).to(cuda)
    before = dict(ksp.LAUNCHES)
    y = ksp.softplus_fwd(x)
    dx = ksp.softplus_bwd(x, y, g)
    torch.cuda.synchronize()
    assert {k: ksp.LAUNCHES[k] - before[k] for k in before} == {"softplus_fwd": 1, "softplus_bwd": 1}
    assert torch.equal(y, ksp.softplus_fwd_plain(x)) and torch.equal(dx, ksp.softplus_bwd_plain(x, y, g))
    t = x.clone().requires_grad_()
    out = ssm._softplus(t)
    out.backward(g)
    assert torch.equal(out.detach(), y) and torch.equal(t.grad, dx)


def test_softplus_kernels_on_a_sweep_of_bit_patterns(cuda):
    """2^24 f32 bit patterns strided over all 2^32 (every exponent, both
    signs, subnormals, infinities, NaNs), each also a cotangent: the kernels
    equal their plain versions bit for bit, the grad's NaNs as NaNs.
    (chip_smoke.py checks all 2^32.)"""
    from repro_torch.kernels import softplus as ksp

    bits = (torch.arange(1 << 24, dtype=torch.int64, device=cuda) * 255 + 7) % (1 << 32)
    x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)
    g = (~x.view(torch.int32)).view(torch.float32)
    y, want = ksp.softplus_fwd(x), ksp.softplus_fwd_plain(x)
    assert torch.equal(y.view(torch.int32), want.view(torch.int32))
    flagged = torch.zeros(1, dtype=torch.int64, device=cuda)
    dx, want = ksp.softplus_bwd(x, y, g, flagged=flagged), ksp.softplus_bwd_plain(x, y, g)
    assert bool(((dx.view(torch.int32) == want.view(torch.int32)) | (dx.isnan() & want.isnan())).all())
    assert 0 < int(flagged.item()) < x.numel()  # the grad's CPU ops taken where an intermediate nears 2^-126


#: (rows, inner, whole width, ranks): jamba's and mamba2's in-projection
#: splits over 4 ranks, reduced, and mamba2-780m's at full width.
SPLIT_CASES = [(128, 128, 580, 4), (128, 128, 548, 4), (2048, 1536, 6448, 4), (127, 64, 96, 2)]


@pytest.mark.parametrize("m,k,total,parts", SPLIT_CASES)
def test_block_of_product_is_the_whole_products_block_on_the_card(cuda, m, k, total, parts):
    """`parallel.block_of_product` on the card equals the whole product's
    block bit for bit, for every rank, in each form of the model axis's
    split products (bf16, f32 accumulation as the model runs)."""
    from repro_torch.distributed import parallel as P
    from repro_torch.models import layers

    gen = torch.Generator(device=cuda).manual_seed(total)

    def draw(*shape):
        return torch.randn(*shape, generator=gen, device=cuda).to(torch.bfloat16)

    x, w, wt, g = draw(m, k), draw(k, total), draw(k, total), draw(m, total)
    n, kn = total // parts, k // parts
    with layers.f32_accumulation():
        for index in range(parts):
            cols, rows = slice(index * n, (index + 1) * n), slice(index * kn, (index + 1) * kn)
            assert torch.equal(P.block_of_product(x, w[:, cols].contiguous(), total, index), (x @ w)[:, cols])
            assert torch.equal(P.block_of_product(g, wt[rows].contiguous().T, k, index), (g @ wt.T)[:, rows])
            assert torch.equal(P.block_of_product(x.T, g[:, cols].contiguous(), total, index), (x.T @ g)[:, cols])
            assert torch.equal(P.block_of_product(x[:, rows].contiguous().T, g, k, index, rows=True),
                               (x.T @ g)[rows])
