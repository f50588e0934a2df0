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
    "permuted" (an expert path's einsum output), "rows" (a column slice of a
    projection, the mixer's `z`), or "patterns" (every bf16 value)."""
    rng = np.random.default_rng(seed)

    def draw(*shape):
        return torch.from_numpy((rng.standard_normal(shape) * 4).astype(np.float32)).to(dtype)

    if layout == "dense":
        return draw(3, 5000)
    if layout == "permuted":
        return draw(4, 2, 3, 300).permute(1, 0, 2, 3)
    if layout == "rows":
        return draw(2, 7, 2500)[..., 100:2400]
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


@pytest.mark.parametrize("layout", ["dense", "permuted", "rows", "patterns"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_silu_emulated_matches_plain(emu_lib, layout, dtype):
    """`silu_fwd` and `silu_bwd` over the walks the wrapper hands them
    (`kernels.silu._walk`: one dense row, or rows with their own stride;
    tiles of 2048 meeting a row's end), against the plain versions: bf16
    bit for bit, f32 by `f32_close`; a row stride shorter than the row is
    refused."""
    from repro_torch.kernels import silu as ksilu

    a = silu_case(layout, dtype, 5)
    h = silu_case(layout, dtype, 6) if layout != "patterns" else a.flip(0)
    a, dense, rows, cols, sa, y = ksilu._walk(a)
    assert dense == (layout != "rows")
    code = ksilu._DTYPES[dtype]
    assert emu_lib.silu_fwd_launch(a.data_ptr(), sa, y.data_ptr(), rows, cols, code, None) == 0
    if dense:
        h = torch.empty_like(a).copy_(h)
        sh = sa
    else:
        sh = ksilu._rows(h)[1]
    out = torch.empty_like(y)
    assert emu_lib.silu_bwd_launch(a.data_ptr(), sa, h.data_ptr(), sh, out.data_ptr(), rows, cols, code, None) == 0
    fwd, bwd = ksilu.silu_fwd_plain(a), ksilu.silu_bwd_plain(a, h)
    if dtype == torch.bfloat16:
        assert nan_equal(y, fwd) and nan_equal(out, bwd), layout
    else:
        assert f32_close(y, fwd, fwd.abs()), layout
        assert f32_close(out, bwd, h.abs() * (1 + a.abs())), layout
    assert emu_lib.silu_fwd_launch(a.data_ptr(), cols - 1, y.data_ptr(), 2, cols, code, None) != 0
