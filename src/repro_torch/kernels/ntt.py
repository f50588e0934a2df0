"""Row-centric negacyclic NTT on the H100: the port of `repro/kernels/ntt.py`.

Two regimes, as in the Pallas version:

  n <= tile  -> the reference's `_fused_full`, here one `ntt_tile` launch
      (B1, `csrc/ntt.cu`) inside `ntt_cuda`: every stage of a row in shared
      memory, one HBM read and one write.
  n >  tile  -> `_two_regime`: one `ntt_pair` launch (B2) per stage with
      stride >= tile, and one `ntt_tile` launch for all stages with stride
      < tile, each tile fused over its packed twiddle row
      (`_pack_tile_stages`, the reference's packing as is).

Each kernel has one wrapper, `_tile_pass` and `_pair_pass`, and the
orchestration goes through them on either device.  On a CUDA tensor a
wrapper launches its kernel (and counts the launch in `LAUNCHES`); on a CPU
tensor it runs the kernel's plain torch version (`ntt_tile_plain`,
`ntt_pair_plain`) on the same packed tables and the same stage plan, so the
CPU tests exercise the tiling, packing and stage order that the card runs.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core.ntt import (
    NttContext,
    Stage,
    device_tables,
    forward_stages,
    inverse_stages,
    torch_stage,
)
from repro_torch.kernels import _build

DEFAULT_TILE = 8192  # words: 32 KiB of shared memory per CTA
#: Largest tile one CTA holds: 2^15 words = 128 KiB of the H100's 227 KB of
#: shared memory per block (2^16 words would need 256 KiB).
MAX_TILE = 32768

#: Kernel launches made by the wrappers, by kernel; plain versions add nothing.
LAUNCHES = {"ntt_tile": 0, "ntt_pair": 0}


def _log2(v: int) -> int:
    return v.bit_length() - 1


# ---------------------------------------------------------------------------
# tables and plans
# ---------------------------------------------------------------------------


def _pack_tile_stages(ctx: NttContext, n: int, tile: int, forward: bool):
    """Per-tile packed twiddle tables + stage plans with packed offsets.

    For tile j (global offset o = j*tile) the stage with stride t uses
    table[h + o/(2t) : ... + tile/(2t)] (h = n/(2t)) — a contiguous slice,
    so all of tile j's stage twiddles concatenate into row j of a
    (n_tiles, tile) array; the CTA of tile j reads row j.
    """
    table = ctx.psi_brv if forward else ctx.psi_inv_brv
    table_sh = ctx.psi_brv_shoup if forward else ctx.psi_inv_brv_shoup
    plan_full = forward_stages(n) if forward else inverse_stages(n)
    stages = [st for st in plan_full if st.stride < tile]
    n_tiles = n // tile
    packed = np.zeros((n_tiles, tile), np.uint32)
    packed_sh = np.zeros((n_tiles, tile), np.uint32)
    local_stages = []
    cursor = 0
    for st in stages:
        h = n // (2 * st.stride)
        per_tile = tile // (2 * st.stride)
        for j in range(n_tiles):
            lo = h + (j * tile) // (2 * st.stride)
            packed[j, cursor : cursor + per_tile] = table[lo : lo + per_tile]
            packed_sh[j, cursor : cursor + per_tile] = table_sh[lo : lo + per_tile]
        local_stages.append(Stage(blocks=per_tile, stride=st.stride, tw_lo=cursor, gs=st.gs))
        cursor += per_tile
    return packed, packed_sh, local_stages


_PACKED: dict[tuple, tuple[torch.Tensor, torch.Tensor, tuple[Stage, ...]]] = {}
_PACKED_LOCK = threading.Lock()


def _packed_tables(ctx: NttContext, tile: int, forward: bool, device: torch.device):
    """`_pack_tile_stages` as uint32 tensors on `device`, once per
    (q, n, tile, direction, device)."""
    key = (ctx.q, ctx.n, tile, forward, str(device))
    with _PACKED_LOCK:
        hit = _PACKED.get(key)
        if hit is None:
            packed, packed_sh, local = _pack_tile_stages(ctx, ctx.n, tile, forward)
            hit = _PACKED[key] = (
                mm.to_device_u32(packed, device),
                mm.to_device_u32(packed_sh, device),
                tuple(local),
            )
    return hit


# ---------------------------------------------------------------------------
# kernel wrappers and their plain versions
# ---------------------------------------------------------------------------


def _check_pass(src, dst, tw, tw_sh, table_len: int) -> None:
    _build.check_u32("dst", dst)
    for name, t in (("src", src), ("tw", tw), ("tw_sh", tw_sh)):
        _build.check_u32(name, t, dst.device)
    if src.dim() != 2 or src.shape != dst.shape:
        raise ValueError(f"src {tuple(src.shape)} and dst {tuple(dst.shape)} must be one (batch, n)")
    if tw.numel() != table_len or tw_sh.numel() != table_len:
        raise ValueError(f"twiddle tables must hold {table_len} words, got {tw.numel()}, {tw_sh.numel()}")


def ntt_tile_plain(src, dst, tw, tw_sh, stages, tile: int, q: int, scale=None) -> None:
    """B1's plain version: the stages of `stages` over every tile of
    `src` (batch, n), tile j using row j of `tw` (n // tile, tile) from
    offset `stage.tw_lo`; optional (n_inv, n_inv_shoup) scale; into `dst`."""
    n_tiles = tw.numel() // tile
    x = mm.as_i64(src).reshape(src.shape[0], n_tiles, tile)
    w_all = mm.as_i64(tw).reshape(n_tiles, tile)
    wsh_all = mm.as_i64(tw_sh).reshape(n_tiles, tile)
    for st in stages:
        sl = slice(st.tw_lo, st.tw_lo + st.blocks)
        x = torch_stage(x, st, w_all[:, sl, None], wsh_all[:, sl, None], q)
    if scale is not None:
        x = mm.shoup_mulmod_u32(x, scale[0], scale[1], q)
    dst.copy_(mm.to_u32(x).reshape(dst.shape))


def _tile_pass(src, dst, tw, tw_sh, stages, tile: int, q: int, scale=None) -> None:
    """Wrapper of B1 `ntt_tile`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  `src` may be `dst` (in place)."""
    n = dst.shape[-1] if dst.dim() == 2 else 0
    _check_pass(src, dst, tw, tw_sh, n)
    if tile < 2 or tile & (tile - 1) or n % tile or tile > MAX_TILE:
        raise ValueError(f"tile {tile} must be a power of two <= {MAX_TILE} dividing n={n}")
    if len({st.gs for st in stages}) != 1:
        raise ValueError("a tile pass runs stages of one direction")
    for st in stages:
        if st.blocks * 2 * st.stride != tile or st.tw_lo + st.blocks > tile:
            raise ValueError(f"{st} does not fit a tile of {tile}")
    if dst.is_cuda:
        if dst.numel() == 0:
            return
        lib = _build.load()
        k = len(stages)
        log_strides = (ctypes.c_int * k)(*(_log2(st.stride) for st in stages))
        tw_los = (ctypes.c_int * k)(*(st.tw_lo for st in stages))
        n_inv, n_inv_sh = scale if scale is not None else (0, 0)
        with torch.cuda.device(dst.device):
            err = lib.ntt_tile_launch(
                src.data_ptr(), dst.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
                dst.numel() // tile, tile, n // tile, log_strides, tw_los, k,
                int(stages[0].gs), q, int(scale is not None), n_inv, n_inv_sh,
                _build.stream_handle(dst.device),
            )
        _build.check(err, "ntt_tile")
        LAUNCHES["ntt_tile"] += 1
    elif dst.device.type == "cpu":
        ntt_tile_plain(src, dst, tw, tw_sh, stages, tile, q, scale)
    else:
        raise ValueError(f"ntt_tile runs on CUDA or CPU tensors, not {dst.device}")


def ntt_pair_plain(src, dst, tw, tw_sh, stage: Stage, q: int, scale=None) -> None:
    """B2's plain version: one stage over the rows of `src` (batch, n),
    block `blk` using twiddle `tw[stage.tw_lo + blk]`; optional scale."""
    sl = slice(stage.tw_lo, stage.tw_lo + stage.blocks)
    w = mm.as_i64(tw)[sl, None]
    w_sh = mm.as_i64(tw_sh)[sl, None]
    x = torch_stage(mm.as_i64(src), stage, w, w_sh, q)
    if scale is not None:
        x = mm.shoup_mulmod_u32(x, scale[0], scale[1], q)
    dst.copy_(mm.to_u32(x))


def _pair_pass(src, dst, tw, tw_sh, stage: Stage, q: int, scale=None) -> None:
    """Wrapper of B2 `ntt_pair`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  `src` may be `dst` (in place)."""
    n = dst.shape[-1] if dst.dim() == 2 else 0
    _check_pass(src, dst, tw, tw_sh, n)
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two")
    if stage.blocks * 2 * stage.stride != n or stage.tw_lo + stage.blocks > n:
        raise ValueError(f"{stage} does not fit rows of {n}")
    if dst.is_cuda:
        if dst.numel() == 0:
            return
        lib = _build.load()
        n_inv, n_inv_sh = scale if scale is not None else (0, 0)
        with torch.cuda.device(dst.device):
            err = lib.ntt_pair_launch(
                src.data_ptr(), dst.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
                dst.numel() // 2, _log2(n // 2), _log2(stage.stride), stage.tw_lo,
                int(stage.gs), q, int(scale is not None), n_inv, n_inv_sh,
                _build.stream_handle(dst.device),
            )
        _build.check(err, "ntt_pair")
        LAUNCHES["ntt_pair"] += 1
    elif dst.device.type == "cpu":
        ntt_pair_plain(src, dst, tw, tw_sh, stage, q, scale)
    else:
        raise ValueError(f"ntt_pair runs on CUDA or CPU tensors, not {dst.device}")


# ---------------------------------------------------------------------------
# public entry point
# ---------------------------------------------------------------------------


def resolve_tile(tile: int | None, n: int) -> int:
    """The tile a call runs with: `tile` (default `DEFAULT_TILE`) clamped
    to n and to `MAX_TILE`."""
    tile = tile or DEFAULT_TILE
    if tile < 1 or tile & (tile - 1):
        raise ValueError(f"tile must be a power of two, got {tile}")
    return min(tile, n, MAX_TILE)


def ntt_cuda(x: torch.Tensor, ctx: NttContext, forward: bool = True, tile: int | None = None):
    """Batched negacyclic NTT over the last axis of (batch, n) or (n,) uint32.

    forward: natural order in -> bit-reversed out (CT butterflies).
    inverse: bit-reversed in -> natural out, scaled by 1/N (GS); the
    scale rides on the last kernel launch.

    Runs on `x`'s device: the CUDA kernels on the card, their plain
    versions on the CPU.  The result is a fresh tensor; `x` is left
    unchanged.  The first launch reads `x` and writes the result buffer,
    and every later launch updates that buffer in place, so a call
    allocates once and copies nothing beside the kernels.

    `tile` (default 8192) is clamped to n and to `MAX_TILE` = 32768, the
    largest power-of-two tile whose words fit one CTA's shared memory; a
    larger request (the reference's fused n = 65536, say) runs as
    32768-word tiles.  Every tiling gives the same canonical values.  The
    reference's `batch_block`, `interpret` and odd-batch padding belong to
    the TPU grid and have no counterpart here.
    """
    _build.check_u32("x", x)
    n = ctx.n
    if x.dim() not in (1, 2) or x.shape[-1] != n:
        raise ValueError(f"expected (n,) or (batch, n) with n={n}, got {tuple(x.shape)}")
    if n < 2:
        raise ValueError("n must be at least 2")
    squeeze = x.dim() == 1
    src = x.reshape(1, n) if squeeze else x
    dst = torch.empty_like(src)
    tile = resolve_tile(tile, n)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    tw, tw_sh = device_tables(ctx, dst.device).for_direction(forward)
    if tile >= n:
        plan = forward_stages(n) if forward else inverse_stages(n)
        _tile_pass(src, dst, tw, tw_sh, plan, n, ctx.q, scale)
    else:
        _two_regime(src, dst, ctx, forward, tile, tw, tw_sh, scale)
    return dst[0] if squeeze else dst


def _two_regime(src, dst, ctx, forward, tile, tw, tw_sh, scale) -> None:
    """n > tile: one B2 launch per stage with stride >= tile, one B1 launch
    for the rest; the inverse's 1/N rides on its last B2 launch."""
    packed, packed_sh, local_stages = _packed_tables(ctx, tile, forward, dst.device)
    plan_full = forward_stages(ctx.n) if forward else inverse_stages(ctx.n)
    inter = [st for st in plan_full if st.stride >= tile]
    if forward:
        cur = src
        for st in inter:  # large strides first
            _pair_pass(cur, dst, tw, tw_sh, st, ctx.q)
            cur = dst
        _tile_pass(dst, dst, packed, packed_sh, local_stages, tile, ctx.q)
    else:
        _tile_pass(src, dst, packed, packed_sh, local_stages, tile, ctx.q)
        for i, st in enumerate(inter):
            last = i == len(inter) - 1
            _pair_pass(dst, dst, tw, tw_sh, st, ctx.q, scale if last else None)
