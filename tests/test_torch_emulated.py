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


@pytest.mark.parametrize("count", [0, 1, 3, 4, 7, 1536, 3073])
def test_chain_fold_emulated_matches_numpy(emu_lib, count):
    """`chain_fold`'s one-thread walk against `np.cumsum` over [b0, *inc]
    and the plain version, with `==` (lengths around its 4-wide unroll)."""
    from repro_torch.kernels import fold

    rng = np.random.default_rng(count)
    inc = torch.from_numpy(rng.uniform(0.0, 60.0, count) * rng.choice([1.0, 1e-3, 1e3], count))
    b0 = float(rng.uniform(0.0, 1e5))
    out = torch.empty(count + 1, dtype=torch.float64)
    assert emu_lib.chain_fold_launch(inc.data_ptr(), out.data_ptr(), count, b0, None) == 0
    exp = np.cumsum(np.concatenate([[b0], inc.numpy()]))
    assert np.array_equal(out.numpy(), exp)
    assert torch.equal(fold.left_fold_plain(inc, b0), out)
