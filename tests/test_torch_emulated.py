"""The port's CUDA sources, compiled for the CPU, against the plain versions.

No card and no `nvcc` is needed: `csrc/*.cu` is compiled with g++ as C++20
against `tests/cuda_emu/cuda_runtime.h`, which runs each CTA's threads as
std::threads with a std::barrier for `__syncthreads()`, after two textual
rewrites (a `<<<...>>>` launch becomes a call of `emu_launch`, the dynamic
shared-memory declaration a pointer to the CTA's buffer).  So these tests
run the kernels' own index arithmetic, register groups, shared-memory
layout and 16-byte paths on the CPU, through the wrappers' own argument
marshalling, bit-exact against the kernels' plain versions.  They skip
where there is no g++.
"""
import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_core
from repro_torch.kernels import _build
from repro_torch.kernels import modmul as kmod
from repro_torch.kernels import ntt as kntt

Q = mm.DEFAULT_Q
EMU = pathlib.Path(__file__).resolve().parent / "cuda_emu"
# (batch, n, tile): fused tiles of 1 to 7 stages (B1's register groups meet
# the tile's edge), then n / tile of 2 to 64 (B2 groups for 1 to 6 stages).
SHAPES = [(3, 2, None), (2, 16, None), (3, 32, None), (2, 128, None), (3, 64, 2), (3, 256, 8),
          (2, 1024, 16), (5, 512, 32), (3, 128, 64), (2, 2048, 128), (1, 4096, 1024)]


@pytest.fixture(scope="module")
def emu_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    out = tmp_path_factory.mktemp("cuda_emu")
    sources = []
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = re.sub(r"extern __shared__ __align__\(16\) uint32_t (\w+)\[\];",
                      r"uint32_t* \1 = emu_shared;", src.read_text())
        text, launches = re.subn(r"(\w+(?:<[^<>]*>)?)<<<(.*?)>>>\(", r"emu_launch(\1, \2, ", text,
                                 flags=re.S)
        assert launches, f"no launch found in {src.name}"
        text = text.replace(", )", ")")  # a kernel without arguments
        sources.append(out / (src.stem + ".cpp"))
        sources[-1].write_text(text)
    lib = out / "libemu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread", "-Wno-unknown-pragmas",
                    f"-I{EMU}", f"-I{_build.CSRC}", *map(str, sources), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    return _build._bind(ctypes.CDLL(str(lib)))


def same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def residues(rng, shape, misaligned=False):
    """Residues mod Q in a (batch, n) CPU tensor; `misaligned` puts it one
    word past a 16-byte boundary, which takes the kernels' 4-byte paths."""
    x = torch.from_numpy(rng.integers(0, Q, shape).astype(np.uint32))
    if not misaligned:
        return x
    buf = torch.empty(x.numel() + 1, dtype=torch.uint32)
    out = buf[1:].view(shape)
    out.copy_(x)
    return out


def launches(ctx, tile, forward):
    """(kernel, arguments) for each launch of one transform, in the order
    `ntt_cuda` makes them."""
    n = ctx.n
    tw, tw_sh = ntt_core.device_tables(ctx, "cpu").for_direction(forward)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    if tile >= n:
        plan = ntt_core.forward_stages(n) if forward else ntt_core.inverse_stages(n)
        return [("tile", (tw, tw_sh, plan, n, ctx.q, scale))]
    packed, packed_sh, local = kntt._packed_tables(ctx, tile, forward, torch.device("cpu"))
    groups = kntt.inter_groups(n, tile, forward)
    pairs = [("pair", (tw, tw_sh, group, ctx.q, scale if not forward and i == len(groups) - 1 else None))
             for i, group in enumerate(groups)]
    tile_case = ("tile", (packed, packed_sh, local, tile, ctx.q, None))
    return pairs + [tile_case] if forward else [tile_case] + pairs


def run_emulated(lib, kind, src, dst, args):
    if kind == "tile":
        tw, tw_sh, stages, tile, q, scale = args
        gs = kntt._tile_plan(tuple(stages), tile)
        err = lib.ntt_tile_launch(*kntt._tile_launch_args(src, dst, tw, tw_sh, gs, tile, q, scale), None)
    else:
        tw, tw_sh, group, q, scale = args
        gs, low = kntt._pair_plan(tuple(group), dst.shape[-1])
        err = lib.ntt_pair_launch(*kntt._pair_launch_args(src, dst, tw, tw_sh, gs, low, len(group),
                                                          q, scale), None)
    assert err == 0


@pytest.mark.parametrize("batch,n,tile", SHAPES)
def test_ntt_kernels_emulated_match_plain(emu_lib, batch, n, tile):
    ctx = ntt_core.make_context(Q, n)
    rng = np.random.default_rng(n + batch)
    for forward in (True, False):
        for kind, args in launches(ctx, kntt.resolve_tile(tile, n), forward):
            plain = kntt.ntt_tile_plain if kind == "tile" else kntt.ntt_pair_plain
            src = residues(rng, (batch, n))
            exp = torch.empty_like(src)
            plain(src, exp, *args)
            got = torch.empty_like(src)
            run_emulated(emu_lib, kind, src, got, args)
            assert same(got, exp), (kind, forward, "out of place")
            got = src.clone()
            run_emulated(emu_lib, kind, got, got, args)
            assert same(got, exp), (kind, forward, "in place")
            got = residues(rng, (batch, n), misaligned=True)
            got.copy_(src)
            run_emulated(emu_lib, kind, got, got, args)
            assert same(got, exp), (kind, forward, "misaligned")


def test_ntt_emulated_whole_transform_matches_numpy(emu_lib):
    """The launches chained as `ntt_cuda` chains them, at the main path's
    tile of 8192, against the numpy stage loop."""
    n, tile = 32768, 8192
    ctx = ntt_core.make_context(Q, n)
    x = residues(np.random.default_rng(1), (1, n))
    got = x.clone()
    for kind, args in launches(ctx, tile, True):
        run_emulated(emu_lib, kind, got, got, args)
    np.testing.assert_array_equal(mm.to_numpy_u32(got), ntt_core.ntt_forward_np(mm.to_numpy_u32(x), ctx))
    for kind, args in launches(ctx, tile, False):
        run_emulated(emu_lib, kind, got, got, args)
    assert same(got, x)


def test_modmul_emulated_matches_plain(emu_lib):
    ctx = ntt_core.make_context(Q, 256)
    rng = np.random.default_rng(3)
    a, b = residues(rng, (3, 1000)), residues(rng, (3, 1000))
    out = torch.empty_like(a)
    err = emu_lib.modmul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), ctx.q,
                                ctx.qprime, ctx.r2_mod_q, None)
    assert err == 0
    assert same(out, kmod.modmul_plain(a, b, ctx))


#: (K rounds, n banks) of the chain: single bank steps and rounds, partial
#: chunks of 32 bank steps, then chains past one segment of 1024 bank steps:
#: 96 x 16 (the fastpath's block at 16 banks), 170 x 16, and 512 x 32 (16
#: segments), and 3000 x 1 (more round times than are staged whole).
CHAIN_SHAPES = [(0, 4), (1, 1), (3, 1), (2, 5), (40, 3), (96, 8), (96, 16), (170, 16), (512, 32),
                (3000, 1)]


def chain_case(k, n, seed):
    """(b0, round times of mixed magnitudes, t_bus) from `seed`."""
    rng = np.random.default_rng(seed)
    pn = rng.uniform(0.0, 60.0, k) * rng.choice([1e-3, 1.0, 1e3], k)
    return float(rng.uniform(0.0, 1e5)), pn, float(rng.choice([0.3, 1.25, 37.5]))


def numpy_chain(b0, pn, n, t_bus):
    """`np.cumsum` over [b0, pn[0], t_bus, pn[0], t_bus, ...] (each round time n times)."""
    inc = np.empty(1 + 2 * len(pn) * n)
    inc[0] = b0
    inc[1::2] = np.repeat(pn, n)
    inc[2::2] = t_bus
    return np.cumsum(inc)


def emulated_chain(lib, entry, b0, pn, n, t_bus):
    """The chain from one C entry point: "kernel" (`chain_fold_launch`) or
    "roundtrip" (`chain_fold_roundtrip`, on host memory as on the card)."""
    k = len(pn)
    src = torch.from_numpy(np.ascontiguousarray(pn, dtype=np.float64))
    out = torch.full((1 + 2 * k * n,), float("nan"), dtype=torch.float64)
    if entry == "roundtrip":
        err = lib.chain_fold_roundtrip(src.data_ptr(), out.data_ptr(), k, n, t_bus, b0, 0, None)
    else:
        err = lib.chain_fold_launch(src.data_ptr(), out.data_ptr(), k, n, t_bus, b0, None)
    assert err == 0
    return out.numpy()


@pytest.mark.parametrize("k,n", CHAIN_SHAPES)
def test_chain_fold_emulated_matches_numpy(emu_lib, k, n):
    """`chain_fold`'s walker and helper warps, launched alone and through the
    round trip, against `np.cumsum` over the interleaved increments and the plain
    version, with `==`; a misaligned `out` is refused."""
    from repro_torch.kernels import fold

    b0, pn, t_bus = chain_case(k, n, 7 * k + n)
    exp = numpy_chain(b0, pn, n, t_bus)
    assert np.array_equal(fold.chain_fold_plain(b0, pn, n, t_bus).numpy(), exp)
    for entry in ("kernel", "roundtrip"):
        assert np.array_equal(emulated_chain(emu_lib, entry, b0, pn, n, t_bus), exp), entry
    buf = torch.empty(3 + 2 * k * n, dtype=torch.float64)
    assert emu_lib.chain_fold_launch(buf.data_ptr(), buf[1:].data_ptr(), k, n, t_bus, b0, None) != 0


def test_dadd_probe_emulated_is_a_left_fold(emu_lib):
    """The probe's dependent adds, against `np.cumsum`; a count not a
    multiple of 16 is refused."""
    out = torch.zeros(1, dtype=torch.float64)
    assert emu_lib.fold_dadd_probe_launch(out.data_ptr(), 4096, 0.5, 0.1, None) == 0
    assert out.item() == np.cumsum(np.concatenate([[0.5], np.full(4096, 0.1)]))[-1]
    assert emu_lib.fold_dadd_probe_launch(out.data_ptr(), 20, 0.5, 0.1, None) != 0


@pytest.mark.parametrize("line", range(8))
def test_chain_fold_emulated_on_the_fastpath_grid(emu_lib, line):
    """Every chain that the JAX package's numpy fastpath evaluates on one
    line of the fastpath grid, through the kernel's round trip, `==` to the
    reference's own `_numpy_chain` on the same inputs; and the line's chain
    and add counts (line 0, one bank, evaluates no chain)."""
    import repro.pimsys.fastpath.evaluate as ref_eval
    from test_torch_pimsys import FASTPATH_GRID, GRID_CHAINS, grid_chains

    chains = grid_chains(*FASTPATH_GRID[line])
    assert (len(chains), sum(2 * len(pn) * n for _, pn, n, _ in chains)) == GRID_CHAINS[line]
    for b0, pn, n, t_bus in chains:
        exp = ref_eval._numpy_chain(b0, pn, n, t_bus)
        assert np.array_equal(emulated_chain(emu_lib, "roundtrip", b0, pn, n, t_bus), exp)


def silu_case(layout: str, dtype, seed: int) -> torch.Tensor:
    """silu's input in a layout of its callers: "dense" (a matmul's output),
    "tail" (a dense one whose length leaves a scalar tail after the 16-byte
    vectors), "permuted" (an expert path's einsum output), "rows" (a column
    slice of a projection, the mixer's `z`), "misaligned" (a column slice
    whose start and row stride are not 16-byte aligned, rows of every
    phase), or "patterns" (every bf16 value)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 4).astype(np.float32)).to(dtype)

    if layout == "dense":
        return draw(3, 5000)
    if layout == "tail":
        return draw(3, 1667)
    if layout == "permuted":
        return draw(4, 2, 3, 300).permute(1, 0, 2, 3)
    if layout == "rows":
        return draw(2, 7, 2500)[..., 100:2400]
    if layout == "misaligned":
        return draw(3, 5, 1003)[..., 3:1000]
    return torch.from_numpy((np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)).to(dtype)


def nan_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(((a == b) | (a.isnan() & b.isnan())).all()) and torch.equal(a.signbit() & ~a.isnan(),
                                                                            b.signbit() & ~b.isnan())


def f32_close(got: torch.Tensor, exp: torch.Tensor, scale: torch.Tensor) -> bool:
    """Within 8 f32 ulps of `scale` (or 2^-120), nan where nan: the host's
    `expf` is not torch's, so in f32 the two differ by an ulp or a few after
    the ops that follow it (on the card both call CUDA's `expf`)."""
    fin = exp.isfinite() & scale.isfinite()
    err = (got.double() - exp.double()).abs()[fin]
    return torch.equal(got.isnan(), exp.isnan()) and bool((err <= 2.0**-21 * scale.double()[fin] + 2.0**-120).all())


@pytest.fixture(scope="module")
def silu_table(emu_lib):
    """`silu_fwd`'s table, built by the emulated `silu_table_launch`."""
    table = torch.empty(1 << 16, dtype=torch.bfloat16)
    assert emu_lib.silu_table_launch(table.data_ptr(), None) == 0
    return table


@pytest.fixture(scope="module")
def silu_grad_table(emu_lib):
    """`silu_bwd`'s (d, c) table, built by the emulated `silu_grad_table_launch`."""
    table = torch.empty(1 << 16, dtype=torch.int32)
    assert emu_lib.silu_grad_table_launch(table.data_ptr(), None) == 0
    return table


def test_silu_grad_table_is_every_bf16_value(silu_grad_table):
    """`silu_bwd`'s table (built by the kernel's exact ops) holds, for every
    bf16 bit pattern a, the reference's d = logistic(a) in its low half and
    c = d (1 - d) in its high half, as `silu_bwd_plain` rounds them, bit for
    bit (NaN as NaN): d and c in [0, 1] and never subnormal where a is not
    NaN."""
    from repro_torch.kernels import silu as ksilu

    a = silu_case("patterns", torch.bfloat16, 0)
    x = ksilu._flush(a.float())
    d = ksilu._logistic(x, torch.bfloat16)
    c = ksilu._keep(d * ksilu._keep(1 - d, torch.bfloat16), torch.bfloat16)
    half = lambda bits: (bits & 0xFFFF).to(torch.int16).view(torch.bfloat16)  # noqa: E731
    assert nan_equal(half(silu_grad_table), d.to(torch.bfloat16))
    assert nan_equal(half(silu_grad_table >> 16), c.to(torch.bfloat16))
    assert torch.equal(d.isnan(), a.isnan())
    for v in (d[~a.isnan()], c[~a.isnan()]):
        assert bool(((v >= 0) & (v <= 1) & ((v == 0) | (v >= 2.0**-126))).all())


def test_silu_table_is_every_bf16_value(silu_table):
    """`silu_fwd`'s table (built by the kernel's exact ops) is
    `silu_fwd_plain` of every bf16 bit pattern, bit for bit."""
    from repro_torch.kernels import silu as ksilu

    assert nan_equal(silu_table, ksilu.silu_fwd_plain(silu_case("patterns", torch.bfloat16, 0)))


#: Cotangents of every magnitude class for the every-a sweep (bf16 bits): zeros,
#: subnormals, 2^-126 and its neighbours, small and huge normals, the largest
#: finite, infinities and NaNs, each of both signs.
SILU_H_BITS = [0x0000, 0x0001, 0x0020, 0x007F, 0x0080, 0x0081, 0x0100, 0x0380, 0x0400, 0x0C00, 0x3F80, 0x4A00, 0x7000,
               0x7F7F, 0x7F80, 0x7FC0]


def at_phase(t: torch.Tensor, elements: int) -> torch.Tensor:
    """A copy of `t` (dense) that starts `elements` elements past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    return buf[elements:elements + t.numel()].view(t.shape).copy_(t)


def silu_bwd_emulated(lib, a, h, grad_table):
    """`silu_bwd` as the wrapper launches it on `a` and `h` (same shape,
    each in its own layout): `_walk`'s rows of a, h read where it lies (a
    dense a's h in a's order); the output."""
    from repro_torch.kernels import silu as ksilu

    a, dense, rows, cols, sa, out = ksilu._walk(a)
    if dense:
        if h.stride() != a.stride():
            h = torch.empty_like(a).copy_(h)
        sh = sa
    else:
        sh = ksilu._rows(h)[1]
    code = ksilu._DTYPES[a.dtype]
    table = grad_table.data_ptr() if code == 0 else None
    assert lib.silu_bwd_launch(a.data_ptr(), sa, h.data_ptr(), sh, out.data_ptr(), rows, cols, code, table,
                               None) == 0
    return out


@pytest.mark.parametrize("layout", ["dense", "tail", "permuted", "rows", "misaligned", "patterns"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_silu_emulated_matches_plain(emu_lib, silu_table, silu_grad_table, layout, dtype):
    """`silu_fwd` and `silu_bwd` over the walks the wrapper hands them
    (`kernels.silu._walk`: one dense row, or rows with their own stride;
    16-byte vectors with a scalar head and tail, stored whole or one by one
    as the output's phase allows), against the plain versions: bf16 bit for
    bit, f32 by `f32_close`; a row stride shorter than the row, and bf16
    without a table, are refused."""
    from repro_torch.kernels import silu as ksilu

    a = silu_case(layout, dtype, 5)
    h = silu_case(layout, dtype, 6) if layout != "patterns" else a.flip(0)
    a, dense, rows, cols, sa, y = ksilu._walk(a)
    assert dense == (layout not in ("rows", "misaligned"))
    code = ksilu._DTYPES[dtype]
    fwd, bwd = ksilu.silu_fwd_plain(a), ksilu.silu_bwd_plain(a, h)
    table = silu_table.data_ptr() if dtype == torch.bfloat16 else None
    assert emu_lib.silu_fwd_launch(a.data_ptr(), sa, y.data_ptr(), rows, cols, code, table, None) == 0
    if dtype == torch.bfloat16:
        assert nan_equal(y, fwd), layout
        assert emu_lib.silu_fwd_launch(a.data_ptr(), sa, y.data_ptr(), rows, cols, code, None, None) != 0
    else:
        assert f32_close(y, fwd, fwd.abs()), layout
    out = silu_bwd_emulated(emu_lib, a, h, silu_grad_table)
    if dtype == torch.bfloat16:
        assert nan_equal(out, bwd), layout
    else:
        assert f32_close(out, bwd, h.abs() * (1 + a.abs())), layout
    assert emu_lib.silu_fwd_launch(a.data_ptr(), cols - 1, y.data_ptr(), 2, cols, code, table, None) != 0
    assert emu_lib.silu_bwd_launch(a.data_ptr(), cols - 1, a.data_ptr(), cols, y.data_ptr(), 2, cols, code, table,
                                   None) != 0
    if dtype == torch.bfloat16:
        assert emu_lib.silu_bwd_launch(a.data_ptr(), sa, a.data_ptr(), sa, y.data_ptr(), rows, cols, code, None,
                                       None) != 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("layout", ["dense", "rows"])
@pytest.mark.parametrize("phase_a,phase_h", [(0, 1), (1, 0), (3, 6), (2, 2)])
def test_silu_bwd_emulated_at_other_phases(emu_lib, silu_grad_table, dtype, layout, phase_a, phase_h):
    """`silu_bwd` where a and h (and so the output) lie at other 16-byte
    phases, in elements: a dense one row (h read in a's order), or rows of
    a column slice with h dense: h's vectors read element by element where
    its phase is not a's, the output stored one by one where its is not;
    bit for bit against the plain version (f32 by `f32_close`)."""
    from repro_torch.kernels import silu as ksilu

    width = 16 // torch.tensor([], dtype=dtype).element_size()
    rng = np.random.default_rng(11 + phase_a + 4 * phase_h)
    draw = lambda *shape: torch.from_numpy((rng.standard_normal(shape) * 4).astype(np.float32)).to(dtype)  # noqa: E731
    if layout == "dense":
        a, h = at_phase(draw(3, 1001), phase_a % width), at_phase(draw(3, 1001), phase_h % width)
    else:
        a = at_phase(draw(4, 1030), phase_a % width)[..., 5:1005]
        h = at_phase(draw(4, 1000), phase_h % width)
    out = silu_bwd_emulated(emu_lib, a, h, silu_grad_table)
    bwd = ksilu.silu_bwd_plain(a, h)
    if dtype == torch.bfloat16:
        assert nan_equal(out, bwd)
    else:
        assert f32_close(out, bwd, h.abs() * (1 + a.abs()))


def test_silu_bwd_emulated_every_a_against_every_h_class(emu_lib, silu_grad_table):
    """`silu_bwd` on all 65,536 bf16 values of a against cotangents of every
    magnitude class (`SILU_H_BITS`, both signs: subnormal, at and beside
    2^-126, huge, +-inf, NaN), bit for bit (NaN as NaN) against the plain
    version: where the flag sends elements to the reference's ops (an
    operand or a result in (0, 2^-126]) and where the packed ops stand."""
    from repro_torch.kernels import silu as ksilu

    a = silu_case("patterns", torch.bfloat16, 0)
    hs = np.array(SILU_H_BITS + [b | 0x8000 for b in SILU_H_BITS], dtype=np.uint16)
    a = a.repeat(len(hs), 1)
    h = torch.from_numpy(np.repeat(hs[:, None], 1 << 16, axis=1).astype(np.int16)).view(torch.bfloat16)
    assert nan_equal(silu_bwd_emulated(emu_lib, a, h, silu_grad_table), ksilu.silu_bwd_plain(a, h))


def test_silu_emulated_misaligned_output(emu_lib, silu_table):
    """A dense input one element past a 16-byte boundary and an output
    two past one: the vectors are read whole and stored one by one."""
    from repro_torch.kernels import silu as ksilu

    a = torch.empty(4001, dtype=torch.bfloat16)[1:].copy_(silu_case("dense", torch.bfloat16, 3).reshape(-1)[:4000])
    y = torch.empty(4002, dtype=torch.bfloat16)[2:]
    assert emu_lib.silu_fwd_launch(a.data_ptr(), a.numel(), y.data_ptr(), 1, a.numel(), 0, silu_table.data_ptr(),
                                   None) == 0
    assert nan_equal(y, ksilu.silu_fwd_plain(a))


def softplus_case(layout: str, seed: int, values: torch.Tensor | None = None) -> torch.Tensor:
    """softplus's f32 input: "dense" (the mixer's `dt + dt_bias`), "rows"
    (a column slice, rows with their own stride), "patterns" (a strided
    sweep of f32 bit patterns: every exponent, both signs, subnormals,
    infinities and NaNs) or "edges" (the elements that take the forward's
    CPU ops or sit at a branch: subnormals, +-0, +-inf, NaN payloads,
    inputs whose exp lands at 2^-126, and those around log1p's branch edge
    e = 0x3ED413CD); with `values`, those values in that layout."""
    rng = np.random.default_rng(seed)
    if layout == "dense":
        t = torch.from_numpy((rng.standard_normal((4, 3000)) * 8).astype(np.float32))
    elif layout == "rows":
        t = torch.from_numpy((rng.standard_normal((3, 5, 1200)) * 30).astype(np.float32))[..., 50:1100]
    elif layout == "edges":
        near = lambda v: np.float32(v).view(np.uint32) + np.arange(-40, 41, dtype=np.int64)  # noqa: E731
        bits = np.concatenate([np.arange(0, 1 << 23, 4099), [0, 0x7F800000, 0x7F800001, 0x7FC00000, 0x7FFFFFFF,
                                                             0x7FA5A5A5], near(-np.log(np.float32(2.0**-126))),
                               near(-np.log(np.uint32(0x3ED413CD).view(np.float32))), near(87.0), near(0.5)])
        bits = np.concatenate([bits, bits | 0x80000000]).astype(np.uint32)
        t = torch.from_numpy(bits.view(np.float32).copy())
    else:
        t = torch.from_numpy((np.arange(1 << 18, dtype=np.uint32) * 16411 + seed).view(np.float32))
    return t if values is None else t.copy_(values)


@pytest.mark.parametrize("layout", ["dense", "rows", "patterns", "edges"])
def test_softplus_emulated_matches_plain(emu_lib, layout):
    """`softplus_fwd` and `softplus_bwd` (`csrc/softplus.cu`) over the
    layouts the wrapper hands them (`kernels.softplus._layout`: one dense
    row, or rows with their own strides), bit for bit against the plain
    versions (the grad's NaNs as NaNs); each with and without its count of
    elements that took the CPU's ops (for the forward, of the normal draws
    those past |x| ~ 28.75, where log1p's e^3 / 3 falls below 2^-126; some
    of the patterns and edges; for the grad some of each layout; the same
    values either way); a row stride shorter than the row is refused."""
    from repro_torch.kernels import softplus as ksp

    x0 = softplus_case(layout, 7)
    x, rows, cols, sx = ksp._layout(x0)
    assert (rows > 1) == (layout == "rows")
    want = ksp.softplus_fwd_plain(x)
    flagged = torch.zeros(1, dtype=torch.int64)
    for count in (None, flagged.data_ptr()):
        out = torch.full(x.shape, float("nan"))
        assert emu_lib.softplus_fwd_launch(x.data_ptr(), sx, out.data_ptr(), rows, cols, count, None) == 0
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), (layout, count)
    if layout in ("dense", "rows"):  # log1p's e^3 / 3 falls below 2^-126 from |x| ~ 28.75 on
        assert (x.abs() > 29.2).sum() <= flagged.item() <= (x.abs() > 28.7).sum(), flagged
    else:
        assert 0 < flagged.item() < x.numel(), flagged
    o, so = ksp._like_rows(softplus_case(layout, 9, want), rows, cols)
    g, sg = ksp._like_rows(softplus_case(layout, 8), rows, cols)
    if layout not in ("patterns", "edges"):
        g = g / 8 if rows == 1 else g.div_(8)
    want = ksp.softplus_bwd_plain(x, o, g)
    flagged.zero_()
    for count in (None, flagged.data_ptr()):
        dx = torch.full(x.shape, float("nan"))
        assert emu_lib.softplus_bwd_launch(x.data_ptr(), sx, o.data_ptr(), so, g.data_ptr(), sg, dx.data_ptr(), rows,
                                           cols, count, None) == 0
        same_bits = dx.view(torch.int32) == want.view(torch.int32)
        assert bool((same_bits | (dx.isnan() & want.isnan())).all()), (layout, count)
    assert 0 < flagged.item() < x.numel(), flagged
    assert emu_lib.softplus_fwd_launch(x.data_ptr(), cols - 1, out.data_ptr(), 2, cols, None, None) != 0
    assert emu_lib.softplus_bwd_launch(x.data_ptr(), cols - 1, o.data_ptr(), so, g.data_ptr(), sg, dx.data_ptr(), 2,
                                       cols, None, None) != 0


def softplus_grad_edges():
    """(x, g) where the grad's chain meets 2^-126: exp(d) there (x about
    -87.34, d = x - softplus(x)), g * exp(d) there (g = 2^-100 and x about
    -18.02; g = 2^-126 and x about 0), subnormal cotangents, zero
    cotangents, and x past ~17, where softplus(x) rounds to x and d is 0;
    each beside normal draws, both signs of g."""
    near = lambda v, k=60: np.float32(v).view(np.uint32) + np.arange(-k, k + 1, dtype=np.int64)  # noqa: E731
    as_f32 = lambda bits: np.asarray(bits, dtype=np.uint32).view(np.float32)  # noqa: E731
    rng = np.random.default_rng(3)
    xs, gs = [], []
    for x_bits, g in ((near(-87.3365), 1.0), (near(-87.3365), 3.0), (near(-18.0218), 2.0**-100),
                      (near(-0.6931), 2.0**-125), (near(0.0, 8), 2.0**-126), (near(17.5), 1.0),
                      (near(40.0), 1.0), (near(-2.0), 2.0**-130), (near(-2.0), 0.0)):
        xs.append(as_f32(x_bits))
        gs.append(np.full(len(x_bits), g, dtype=np.float32))
    xs.append((rng.standard_normal(500) * 4).astype(np.float32))
    gs.append(rng.standard_normal(500).astype(np.float32))
    x, g = np.concatenate(xs), np.concatenate(gs)
    return torch.from_numpy(np.concatenate([x, x])), torch.from_numpy(np.concatenate([g, -g]))


def test_softplus_bwd_emulated_edges(emu_lib):
    """`softplus_bwd` where its chain meets 2^-126 (`softplus_grad_edges`),
    out the plain forward's, bit for bit against the plain version (NaN as
    NaN), with its count of elements that took the CPU's ops neither 0 nor
    all of them."""
    from repro_torch.kernels import softplus as ksp

    x, g = softplus_grad_edges()
    o = ksp.softplus_fwd_plain(x)
    want = ksp.softplus_bwd_plain(x, o, g)
    flagged = torch.zeros(1, dtype=torch.int64)
    dx = torch.full(x.shape, float("nan"))
    assert emu_lib.softplus_bwd_launch(x.data_ptr(), x.numel(), o.data_ptr(), x.numel(), g.data_ptr(), x.numel(),
                                       dx.data_ptr(), 1, x.numel(), flagged.data_ptr(), None) == 0
    same_bits = dx.view(torch.int32) == want.view(torch.int32)
    assert bool((same_bits | (dx.isnan() & want.isnan())).all())
    assert 0 < flagged.item() < x.numel(), flagged
    tiny = (want.abs() <= 2.0**-126) & (want != 0)
    assert not tiny.any() and bool(((want == 0) & (g != 0)).any())  # results flushed where the CPU flushes


def test_empty_launch_emulated(emu_lib):
    """The launch floor's empty kernel runs; a shape of no CTA is refused."""
    assert emu_lib.empty_launch(3, 128, None) == 0
    assert emu_lib.empty_launch(0, 128, None) != 0
