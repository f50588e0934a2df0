#!/usr/bin/env python3
"""Drives the port's polymul main path on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, one JSON line each:
  1. device   the card's name, count and power limit;
  2. build    nvcc build of `src/repro_torch/kernels/csrc/` with ptxas's
              register / shared-memory report;
  3. check    each kernel (ntt_tile, ntt_pair, modmul) against its plain
              torch version on the card, bit-exact, both directions;
  4. main     `polymul_ntt` at n=65536 x batch 64 and n=4096 x batch 1024
              (16 MiB per operand: an RNS-CKKS batch of 64 towers at
              logN=16, and a batch of logN=12 polynomials), bit-exact
              against the numpy stage loop on sampled rows and against the
              plain torch path on all rows, plus intt(ntt(x)) == x; every
              kernel must have launched during this phase;
  5. timing   CUDA-event times per launch beside the byte bound, the plain
              version and a library call where one exists, and the whole
              polymul_ntt.
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0).
Imports nothing of `jax` or `repro`.
"""
from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core import modmath as mm  # noqa: E402
from repro_torch.core import ntt as ntt_core  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import modmul as kmod  # noqa: E402
from repro_torch.kernels import ntt as kntt  # noqa: E402

#: Published H100 SXM memory rate (NVIDIA data sheet); bounds are bytes over it.
HBM_BYTES_PER_S = 3.35e12
SEED = 0
TILE = 8192
#: (batch, n) of the main path: 64 x 65536 runs B2 x3 + B1 per transform,
#: 1024 x 4096 runs the fused B1.
MAIN_SHAPES = ((64, 65536), (1024, 4096))
L2_BYTES = 50 * 2**20
#: `torch.cuda._sleep` spins for clock cycles; the SM clock is at most
#: ~2 GHz, so this many cycles last at least 1 ms.
SLEEP_CYCLES_PER_MS = 2_000_000
KERNEL_INFO = {
    "ntt_tile": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt.py:77"),
    "ntt_pair": ("src/repro_torch/kernels/csrc/ntt.cu", "src/repro/kernels/ntt.py:127"),
    "modmul": ("src/repro_torch/kernels/csrc/modmul.cu", "src/repro/kernels/modmul.py:26"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def residues(rng, shape, q: int, device) -> torch.Tensor:
    return mm.to_device_u32(rng.integers(0, q, shape).astype(np.uint32), device)


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((mm.as_i64(a) - mm.as_i64(b)).abs().max())


def _events_ms(fn, iters: int, sleep_ms: float = 0.0) -> tuple[float, float]:
    """(device ms, host enqueue ms) per call over one block of `iters` calls.

    With `sleep_ms` longer than the host's enqueue time, a GPU sleep runs
    first, so the block's launches wait in the stream and the events time
    them back to back: device time alone, whatever the host's launch cost.
    Without it, the events time calls as a caller makes them.
    """
    if sleep_ms:
        torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * sleep_ms))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_ms


def time_ms(fn, iters: int, reps: int = 5, warmup: int = 3) -> dict:
    """ms per call of `fn`, from `reps` blocks of `iters` calls timed by CUDA
    events: `ms` is the median block with the launches queued behind a GPU
    sleep (device time), `spread` its fastest and slowest block; `wall_ms` is
    the median block as a caller sees it (no queue, so the larger of device
    and host time); `host_ms` the host's time to enqueue one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3 * iters * _events_ms(fn, iters)[1] + 1.0
    queued = [_events_ms(fn, iters, sleep_ms)[0] for _ in range(reps)]
    plain = [_events_ms(fn, iters) for _ in range(reps)]
    return {"ms": float(np.median(queued)), "spread": [min(queued), max(queued)],
            "wall_ms": float(np.median([d for d, _ in plain])),
            "host_ms": float(np.median([h for _, h in plain])), "calls": 2 * reps * iters}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------


def pass_cases(ctx, batch: int, tile: int, forward: bool, device):
    """The launches `ntt_cuda` makes for one transform, as
    (kernel, args) with args (tw, tw_sh, plan or stage, [tile,] scale)."""
    n = ctx.n
    tw, tw_sh = ntt_core.device_tables(ctx, device).for_direction(forward)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    plan = ntt_core.forward_stages(n) if forward else ntt_core.inverse_stages(n)
    if tile >= n:
        return [("ntt_tile", (tw, tw_sh, plan, n, scale))]
    packed, packed_sh, local = kntt._packed_tables(ctx, tile, forward, device)
    inter = [st for st in plan if st.stride >= tile]
    cases = [("ntt_tile", (packed, packed_sh, local, tile, None))]
    for i, st in enumerate(inter):
        last = not forward and i == len(inter) - 1
        cases.append(("ntt_pair", (tw, tw_sh, st, scale if last else None)))
    return cases


def check_kernels(rng, device, shapes=MAIN_SHAPES, tile=TILE) -> dict:
    """Every kernel launch of the main path's transforms against its plain
    version on the same inputs and tables, on `device`."""
    errs = {name: 0 for name in KERNEL_INFO}
    checks = []
    for batch, n in shapes:
        ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
        for forward in (True, False):
            for name, args in pass_cases(ctx, batch, tile, forward, device):
                src = residues(rng, (batch, n), ctx.q, device)
                got, exp = torch.empty_like(src), torch.empty_like(src)
                if name == "ntt_tile":
                    tw, tw_sh, stages, t, scale = args
                    kntt._tile_pass(src, got, tw, tw_sh, stages, t, ctx.q, scale)
                    kntt.ntt_tile_plain(src, exp, tw, tw_sh, stages, t, ctx.q, scale)
                    what = f"{len(stages)} stages, tile {t}"
                else:
                    tw, tw_sh, st, scale = args
                    kntt._pair_pass(src, got, tw, tw_sh, st, ctx.q, scale)
                    kntt.ntt_pair_plain(src, exp, tw, tw_sh, st, ctx.q, scale)
                    what = f"stride {st.stride}"
                ok = same(got, exp)
                errs[name] = max(errs[name], max_abs_err(got, exp))
                checks.append({"kernel": name, "batch": batch, "n": n, "forward": forward,
                               "what": what, "scale": args[-1] is not None, "bit_exact": ok})
                if not ok:
                    raise AssertionError(f"{name} differs from its plain version: {checks[-1]}")
        a = residues(rng, (batch, n), ctx.q, device)
        b = residues(rng, (batch, n), ctx.q, device)
        got = kmod.modmul_cuda(a, b, ctx)
        exp = kmod.modmul_plain(a, b, ctx)
        ok = same(got, exp)
        errs["modmul"] = max(errs["modmul"], max_abs_err(got, exp))
        checks.append({"kernel": "modmul", "batch": batch, "n": n, "bit_exact": ok})
        if not ok:
            raise AssertionError(f"modmul differs from its plain version: {checks[-1]}")
    return {"max_abs_err": errs, "checks": checks}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def expected_launches(shapes=MAIN_SHAPES, tile=TILE) -> dict:
    """Launches of one polymul_ntt per shape: 3 transforms and 1 modmul."""
    counts = {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0}
    for _, n in shapes:
        n_pair = (n // min(tile, n)).bit_length() - 1  # stages with stride >= tile
        counts["ntt_tile"] += 3
        counts["ntt_pair"] += 3 * n_pair
        counts["modmul"] += 1
    return counts


def drive_main_path(rng, device, shapes=MAIN_SHAPES) -> dict:
    """`polymul_ntt` through the user's entry point on each shape, then
    the checks of its output; returns the launch counts of the drive."""
    inputs, outputs = [], []
    kernels.reset_launch_counts()
    for batch, n in shapes:
        ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
        a = rng.integers(0, ctx.q, (batch, n)).astype(np.uint32)
        b = rng.integers(0, ctx.q, (batch, n)).astype(np.uint32)
        inputs.append((ctx, a, b))
        outputs.append(ops.polymul_ntt(a, b, ctx, device=device))
    if device != "cpu":
        torch.cuda.synchronize()
    launches = kernels.launch_counts()

    report = []
    for (ctx, a, b), out in zip(inputs, outputs):
        batch, n = a.shape
        if tuple(out.shape) != (batch, n) or out.dtype != torch.uint32:
            raise AssertionError(f"polymul_ntt gave {tuple(out.shape)} {out.dtype}")
        rows = np.sort(rng.choice(batch, size=min(4, batch), replace=False))
        oracle = ntt_core.polymul_negacyclic_np(a[rows], b[rows], ctx)
        picked = out.view(torch.int32)[torch.from_numpy(rows).to(out.device)]  # no uint32 indexing on CUDA
        rows_ok = bool(np.array_equal(mm.to_numpy_u32(picked.view(torch.uint32)), oracle))
        a_t, b_t = mm.to_device_u32(a, device), mm.to_device_u32(b, device)
        plain_ok = same(out, ntt_core.polymul_negacyclic_torch(a_t, b_t, ctx))
        roundtrip_ok = same(ops.intt(ops.ntt(a_t, ctx), ctx), a_t)
        report.append({"batch": batch, "n": n, "oracle_rows": rows.tolist(),
                       "numpy_oracle_bit_exact": rows_ok, "plain_torch_bit_exact": plain_ok,
                       "roundtrip": roundtrip_ok})
        if not (rows_ok and plain_ok and roundtrip_ok):
            raise AssertionError(f"main path wrong: {report[-1]}")
    return {"launches": launches, "results": report}


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------


def time_kernels(rng, device, batch: int, n: int, tile: int = TILE) -> dict:
    """Per-launch times of each kernel at (batch, n), cold: a ring of
    buffers larger than L2, so each launch reads from device memory."""
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    words = batch * n
    ring = max(2, -(-2 * L2_BYTES // (4 * words)) + 1)
    bufs = [residues(rng, (batch, n), ctx.q, device) for _ in range(ring)]
    out = {}
    tile_case, *pair_cases = pass_cases(ctx, batch, min(tile, n), True, device)
    tw, tw_sh, stages, t, _ = tile_case[1]
    table_bytes = 2 * 4 * tw.numel()
    butterflies = words // 2
    it = itertools.count()

    def tile_launch():
        x = bufs[next(it) % ring]
        kntt._tile_pass(x, x, tw, tw_sh, stages, t, ctx.q)

    def record(kernel_fn, warm_fn, plain_fn, library_fn, nbytes, **extra):
        cold = time_ms(kernel_fn, 50)
        plain = time_ms(plain_fn, 3, reps=3, warmup=1)
        rec = {**cold, "plain_ms": plain["ms"], "library_ms": None,
               "bytes": nbytes, "bound_ms": bound_ms(nbytes), **extra}
        if warm_fn is not None:
            rec["warm_ms"] = time_ms(warm_fn, 50)["ms"]
        if library_fn is not None:
            rec["library_ms"] = time_ms(library_fn, 20)["ms"]
        return rec

    def tile_launch():
        x = bufs[next(it) % ring]
        kntt._tile_pass(x, x, tw, tw_sh, stages, t, ctx.q)

    out["ntt_tile"] = record(
        tile_launch,
        lambda: kntt._tile_pass(bufs[0], bufs[0], tw, tw_sh, stages, t, ctx.q),
        lambda: kntt.ntt_tile_plain(bufs[0], bufs[1], tw, tw_sh, stages, t, ctx.q),
        None, 2 * 4 * words + table_bytes,
        butterflies=butterflies * len(stages), stages=len(stages), tile=t,
    )
    if pair_cases:
        ptw, ptw_sh, st, _ = pair_cases[0][1]

        def pair_launch():
            x = bufs[next(it) % ring]
            kntt._pair_pass(x, x, ptw, ptw_sh, st, ctx.q)

        out["ntt_pair"] = record(
            pair_launch,
            lambda: kntt._pair_pass(bufs[0], bufs[0], ptw, ptw_sh, st, ctx.q),
            lambda: kntt.ntt_pair_plain(bufs[0], bufs[1], ptw, ptw_sh, st, ctx.q),
            None, 2 * 4 * words + 2 * 4 * st.blocks,
            butterflies=butterflies, stride=st.stride,
        )

    def modmul_launch():
        i = next(it)
        kmod.modmul_cuda(bufs[i % ring], bufs[(i + 1) % ring], ctx)

    def library_modmul():
        a64 = bufs[0].view(torch.int32).long()
        b64 = bufs[1].view(torch.int32).long()
        return (a64 * b64) % ctx.q

    out["modmul"] = record(
        modmul_launch, None, lambda: kmod.modmul_plain(bufs[0], bufs[1], ctx),
        library_modmul, 3 * 4 * words,
        library_call="(a.view(int32).long() * b.view(int32).long()) % q, int64",
    )
    return out


def time_polymul(rng, device, batch: int, n: int, tile: int = TILE) -> dict:
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    a = residues(rng, (batch, n), ctx.q, device)
    b = residues(rng, (batch, n), ctx.q, device)
    words = batch * n
    t = min(tile, n)
    n_pair = (n // t).bit_length() - 1
    table_bytes = 2 * 4 * t * (n // t)
    per_transform = (n_pair * 2 * 4 * words) + 2 * 4 * words + table_bytes
    nbytes = 3 * per_transform + 3 * 4 * words
    return {
        "batch": batch, "n": n, "tile": t,
        **time_ms(lambda: ops.polymul_ntt(a, b, ctx, tile=tile), 20),
        "bound_ms": bound_ms(nbytes), "bytes": nbytes,
        "launches": {"ntt_tile": 3, "ntt_pair": 3 * n_pair, "modmul": 1},
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card",
              file=sys.stderr)
        return 1
    device = "cuda"
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi("name,power.limit")
    emit({"phase": "device", "name": name, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    _build.load()
    report = _build.build_report()
    emit({"phase": "build", "nvcc_seconds": report["seconds"], "cached": report["cached"],
          "load_seconds": time.perf_counter() - t0, "ptxas": report["ptxas"]})

    rng = np.random.default_rng(SEED)
    checked = check_kernels(rng, device)
    emit({"phase": "check", **checked})

    main_run = drive_main_path(rng, device)
    launches = main_run["launches"]
    expected = expected_launches()
    emit({"phase": "main", **main_run, "expected_launches": expected})
    if launches != expected or any(v <= 0 for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    timing = {f"{b}x{n}": time_kernels(rng, device, b, n) for b, n in MAIN_SHAPES}
    polymul = [time_polymul(rng, device, b, n) for b, n in MAIN_SHAPES]
    power = nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")
    emit({"phase": "timing", "card": smi, "kernels": timing, "polymul_ntt": polymul,
          "nvidia_smi_after": power})

    big = timing[f"{MAIN_SHAPES[0][0]}x{MAIN_SHAPES[0][1]}"]
    rows = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        rec = big[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": checked["max_abs_err"][kname],
            "bit_exact": checked["max_abs_err"][kname] == 0,
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": "bytes", "library_ms": rec["library_ms"],
            "shape": list(MAIN_SHAPES[0]),
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
