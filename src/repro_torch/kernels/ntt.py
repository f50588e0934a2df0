"""Row-centric negacyclic NTT on the H100: the port of `repro/kernels/ntt.py`.

Two regimes, as in the Pallas version:

  n <= tile  -> the reference's `_fused_full`, here one `ntt_tile` launch
      (B1, `csrc/ntt.cu`) inside `ntt_cuda`: every stage of a row on chip,
      one HBM read and one write.
  n >  tile  -> `_two_regime`: the stages with stride >= tile in groups of
      up to `PAIR_MAX_STAGES` consecutive stages, one `ntt_pair` launch (B2)
      per group (`inter_groups`), and one `ntt_tile` launch for all stages
      with stride < tile, each tile fused over its packed twiddle row
      (`_packed_tables`).  `launch_plan` gives the launches per transform.

Both kernels read twiddles in the full table's layout: the stage with B
blocks (per row, or per tile) at [B, 2B) of the table (or of the tile's
row), so a thread's run of twiddles is aligned and loads as 16-byte words.

Each kernel has one wrapper, `_tile_pass` and `_pair_pass`, and the
orchestration goes through them on either device.  On a CUDA tensor a
wrapper launches its kernel (and counts the launch in `LAUNCHES`); on a CPU
tensor it runs the kernel's plain torch version (`ntt_tile_plain`,
`ntt_pair_plain`) on the same packed tables and the same stage plan, so the
CPU tests exercise the tiling, packing, grouping and stage order that the
card runs.  Both wrappers check the plan against what the kernel runs and
raise on any other, on either device.
"""
from __future__ import annotations

import functools
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
#: Most stages one B2 launch runs: 2^4 words per column in registers.
PAIR_MAX_STAGES = 4

#: Kernel launches made by the wrappers, by kernel; plain versions add nothing.
LAUNCHES = {"ntt_tile": 0, "ntt_pair": 0}
#: Host seconds in `ntt_cuda`, entry to return, summed over its calls on
#: either device.
HOST_S = {"ntt_cuda": 0.0}


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
    """B1's per-tile twiddle rows and stage plan as uint32 tensors on
    `device`, once per (q, n, tile, direction, device).

    The reference's packing (`_pack_tile_stages`), with each stage's slice
    moved to [blocks, 2 * blocks) of the row: the full table's layout, which
    the kernel reads as aligned vectors.
    """
    key = (ctx.q, ctx.n, tile, forward, str(device))
    with _PACKED_LOCK:
        hit = _PACKED.get(key)
        if hit is None:
            packed, packed_sh, local = _pack_tile_stages(ctx, ctx.n, tile, forward)
            rows, rows_sh = np.zeros_like(packed), np.zeros_like(packed_sh)
            for st in local:
                rows[:, st.blocks : 2 * st.blocks] = packed[:, st.tw_lo : st.tw_lo + st.blocks]
                rows_sh[:, st.blocks : 2 * st.blocks] = packed_sh[:, st.tw_lo : st.tw_lo + st.blocks]
            hit = _PACKED[key] = (
                mm.to_device_u32(rows, device),
                mm.to_device_u32(rows_sh, device),
                tuple(Stage(st.blocks, st.stride, st.blocks, st.gs) for st in local),
            )
    return hit


@functools.lru_cache(maxsize=None)
def inter_groups(n: int, tile: int, forward: bool) -> tuple[tuple[Stage, ...], ...]:
    """The stages with stride >= `tile` in run order, cut into the fewest
    groups of at most `PAIR_MAX_STAGES` consecutive stages, as even as
    possible (larger groups first): one B2 launch each.  Empty when
    tile >= n."""
    plan = forward_stages(n) if forward else inverse_stages(n)
    inter = [st for st in plan if st.stride >= tile]
    count = -(-len(inter) // PAIR_MAX_STAGES)
    groups, start = [], 0
    for g in range(count):
        end = start + len(inter) // count + (g < len(inter) % count)
        groups.append(tuple(inter[start:end]))
        start = end
    return tuple(groups)


def launch_plan(n: int, tile: int | None = None) -> dict[str, int]:
    """Kernel launches of one transform (either direction) of rows of n,
    at `tile` resolved as `ntt_cuda` resolves it."""
    t = resolve_tile(tile, n)
    return {"ntt_tile": 1, "ntt_pair": len(inter_groups(n, t, True))}


def _check_table_layout(stages, what: str) -> None:
    for st in stages:
        if st.tw_lo != st.blocks:
            raise ValueError(f"{what} reads twiddles in the full table's layout (tw_lo == blocks), got {st}")


@functools.lru_cache(maxsize=256)
def _tile_plan(stages: tuple[Stage, ...], tile: int) -> bool:
    """B1's direction (True for GS) for `stages`, which must be the whole
    run of the log2(tile) strides < tile: going down (CT) or going up (GS),
    twiddles in the full table's layout.  Any other plan raises."""
    if len({st.gs for st in stages}) != 1:
        raise ValueError("a tile pass runs stages of one direction")
    for st in stages:
        if st.blocks * 2 * st.stride != tile:
            raise ValueError(f"{st} does not fit a tile of {tile}")
    gs = stages[0].gs
    bits = range(_log2(tile)) if gs else range(_log2(tile) - 1, -1, -1)
    if [st.stride for st in stages] != [1 << s for s in bits]:
        raise ValueError(
            f"a tile pass runs every stride < {tile} in order ({'up' if gs else 'down'}), "
            f"got strides {[st.stride for st in stages]}"
        )
    _check_table_layout(stages, "a tile pass")
    return gs


@functools.lru_cache(maxsize=256)
def _pair_plan(stages: tuple[Stage, ...], n: int) -> tuple[bool, int]:
    """(direction, log2 of the smallest stride) for B2: 1 to
    `PAIR_MAX_STAGES` stages of one direction with consecutive strides, in
    run order, twiddles in the full table's layout.  Any other plan raises."""
    if not 1 <= len(stages) <= PAIR_MAX_STAGES:
        raise ValueError(f"a pair pass runs 1 to {PAIR_MAX_STAGES} stages, got {len(stages)}")
    if len({st.gs for st in stages}) != 1:
        raise ValueError("a pair pass runs stages of one direction")
    for st in stages:
        if st.blocks * 2 * st.stride != n:
            raise ValueError(f"{st} does not fit rows of {n}")
    gs = stages[0].gs
    logs = [_log2(st.stride) for st in stages]
    if any(b - a != (1 if gs else -1) for a, b in zip(logs, logs[1:])):
        raise ValueError(f"a pair pass runs consecutive strides in order, got {[st.stride for st in stages]}")
    _check_table_layout(stages, "a pair pass")
    return gs, min(logs)


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


def _tile_launch_args(src, dst, tw, tw_sh, gs: bool, tile: int, q: int, scale) -> tuple:
    """`ntt_tile_launch`'s arguments but the stream, for checked tensors."""
    n_inv, n_inv_sh = scale if scale is not None else (0, 0)
    return (src.data_ptr(), dst.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), dst.numel() // tile,
            _log2(tile), dst.shape[-1] // tile, int(gs), q, int(scale is not None), n_inv, n_inv_sh)


def _tile_pass(src, dst, tw, tw_sh, stages, tile: int, q: int, scale=None) -> None:
    """Wrapper of B1 `ntt_tile`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  `stages` is the whole CT or GS run of strides
    < tile (`_tile_plan`).  `src` may be `dst` (in place)."""
    n = dst.shape[-1] if dst.dim() == 2 else 0
    _check_pass(src, dst, tw, tw_sh, n)
    if tile < 2 or tile & (tile - 1) or n % tile or tile > MAX_TILE:
        raise ValueError(f"tile {tile} must be a power of two <= {MAX_TILE} dividing n={n}")
    gs = _tile_plan(tuple(stages), tile)
    if dst.is_cuda:
        if dst.numel() == 0:
            return
        lib = _build.load()
        with torch.cuda.device(dst.device):
            err = lib.ntt_tile_launch(
                *_tile_launch_args(src, dst, tw, tw_sh, gs, tile, q, scale),
                _build.stream_handle(dst.device),
            )
        _build.check(err, "ntt_tile")
        LAUNCHES["ntt_tile"] += 1
    elif dst.device.type == "cpu":
        ntt_tile_plain(src, dst, tw, tw_sh, stages, tile, q, scale)
    else:
        raise ValueError(f"ntt_tile runs on CUDA or CPU tensors, not {dst.device}")


def ntt_pair_plain(src, dst, tw, tw_sh, stages, q: int, scale=None) -> None:
    """B2's plain version: the stages of `stages` in order over the rows of
    `src` (batch, n), block `blk` of a stage using twiddle
    `tw[stage.tw_lo + blk]`; optional scale; into `dst`."""
    x = mm.as_i64(src)
    w_all, wsh_all = mm.as_i64(tw), mm.as_i64(tw_sh)
    for st in stages:
        sl = slice(st.tw_lo, st.tw_lo + st.blocks)
        x = torch_stage(x, st, w_all[sl, None], wsh_all[sl, None], q)
    if scale is not None:
        x = mm.shoup_mulmod_u32(x, scale[0], scale[1], q)
    dst.copy_(mm.to_u32(x))


def _pair_launch_args(src, dst, tw, tw_sh, gs: bool, low: int, count: int, q: int, scale) -> tuple:
    """`ntt_pair_launch`'s arguments but the stream, for checked tensors."""
    n_inv, n_inv_sh = scale if scale is not None else (0, 0)
    return (src.data_ptr(), dst.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(), dst.shape[0],
            _log2(dst.shape[-1]), low, count, int(gs), q, int(scale is not None), n_inv, n_inv_sh)


def _pair_pass(src, dst, tw, tw_sh, stages, q: int, scale=None) -> None:
    """Wrapper of B2 `ntt_pair`: the kernel on a CUDA tensor, the plain
    version on a CPU tensor.  `stages` is one group of consecutive stages
    (`_pair_plan`, `inter_groups`).  `src` may be `dst` (in place)."""
    n = dst.shape[-1] if dst.dim() == 2 else 0
    _check_pass(src, dst, tw, tw_sh, n)
    if n < 2 or n & (n - 1):
        raise ValueError(f"row length {n} must be a power of two")
    gs, low = _pair_plan(tuple(stages), n)
    if dst.is_cuda:
        if dst.numel() == 0:
            return
        lib = _build.load()
        with torch.cuda.device(dst.device):
            err = lib.ntt_pair_launch(
                *_pair_launch_args(src, dst, tw, tw_sh, gs, low, len(stages), q, scale),
                _build.stream_handle(dst.device),
            )
        _build.check(err, "ntt_pair")
        LAUNCHES["ntt_pair"] += 1
    elif dst.device.type == "cpu":
        ntt_pair_plain(src, dst, tw, tw_sh, stages, q, scale)
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


@_build.timed_span(HOST_S, "ntt_cuda", "repro_torch.kernels.ntt_cuda")
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

    Each call adds its host seconds to `HOST_S` and runs inside the span
    `repro_torch.kernels.ntt_cuda`.
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
    """n > tile: one B2 launch per group of `inter_groups`, one B1 launch
    for the rest; the inverse's 1/N rides on its last B2 launch."""
    packed, packed_sh, local_stages = _packed_tables(ctx, tile, forward, dst.device)
    groups = inter_groups(ctx.n, tile, forward)
    if forward:
        cur = src
        for group in groups:  # large strides first
            _pair_pass(cur, dst, tw, tw_sh, group, ctx.q)
            cur = dst
        _tile_pass(dst, dst, packed, packed_sh, local_stages, tile, ctx.q)
    else:
        _tile_pass(src, dst, packed, packed_sh, local_stages, tile, ctx.q)
        for i, group in enumerate(groups):
            last = i == len(groups) - 1
            _pair_pass(dst, dst, tw, tw_sh, group, ctx.q, scale if last else None)
