#!/usr/bin/env python3
"""Drives the port's polymul main path on one NVIDIA card and checks its kernels.

    python3 chip_smoke.py        # from the repo root; needs one CUDA card

Phases, one JSON line each:
  1. device   the card's name, count and power limit;
  2. build    nvcc build of `src/repro_torch/kernels/csrc/` with ptxas's
              register / shared-memory report (a stack frame or a spill
              fails the run), then a `sass` line: each kernel's SASS
              instruction mix, where the toolkit has `cuobjdump`;
  3. check    each kernel (ntt_tile, ntt_pair, modmul) against its plain
              torch version on the card, bit-exact, both directions, in
              place and out of place, at the main shapes and on a grid of
              edge cases (tiles 2 to 32768, 1 to 6 inter-tile stages);
  4. main     `polymul_ntt` at n=65536 x batch 64 and n=4096 x batch 1024
              (16 MiB per operand: an RNS-CKKS batch of 64 towers at
              logN=16, and a batch of logN=12 polynomials), bit-exact
              against the numpy stage loop on sampled rows and against the
              plain torch path on all rows, plus intt(ntt(x)) == x; every
              kernel must have launched during this phase;
  5. timing   CUDA-event times per launch beside the bound (the larger of
              bytes over the memory rate and integer instructions over the
              issue rate), the plain version and a library call where one
              exists, and the whole polymul_ntt.
Then the `kernels` line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  Any failed check raises (exit code != 0).
Imports nothing of `jax` or `repro`.
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import re
import shutil
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

#: Published H100 SXM memory rate (NVIDIA data sheet); byte bounds are bytes over it.
HBM_BYTES_PER_S = 3.35e12
#: Op bounds: an SM issues 4 warp instructions (128 lane operations) per
#: clock, at most, at the card's maximum SM clock (nvidia-smi clocks.max.sm).
LANE_OPS_PER_SM_CLOCK = 128
#: Instructions per butterfly on sm_90a, read from the kernels' SASS
#: (`cuobjdump -sass`): the Shoup product as IMAD.HI + IMAD + IMAD, the add
#: and the subtract as IMAD.IADD each, and the three reductions mod q as one
#: VIADDMNMX each (the source's formulas count 11: see csrc/modmath.cuh).
OPS_PER_BUTTERFLY = 8
SEED = 0
TILE = 8192
#: (batch, n) of the main path: 64 x 65536 runs one B2 launch of 3 stages
#: and one B1 per transform, 1024 x 4096 runs the fused B1.
MAIN_SHAPES = ((64, 65536), (1024, 4096))
#: (batch, n, tile) edge cases of the check phase: tiles 2 to MAX_TILE
#: (B1's groups of up to 5 stages meet tiles of 1 to 15 stages), and
#: n / tile in {2, 8, 16, 32, 64}, which gives B2 groups for 1, 3, 4, 5 and
#: 6 inter-tile stages (at most 4 per launch).
CHECK_SHAPES = (
    (3, 2, 2), (5, 16, 16), (3, 32, 32), (2, 128, 128),
    (3, 64, 2), (3, 256, 8), (2, 1024, 16), (5, 512, 32),
    (3, 128, 64), (2, 4096, 64), (2, 2048, 128), (4, 8192, 1024), (2, 16384, 2048),
    (1, 32768, 32768), (2, 65536, 32768),
)
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


def bound(nbytes: int, butterflies: int, sm_mhz: float) -> dict:
    """The least time the card could take: the larger of `nbytes` over the
    memory rate and the butterflies' integer instructions over the issue
    rate of 132 SMs at `sm_mhz`."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = butterflies * OPS_PER_BUTTERFLY / (sms * LANE_OPS_PER_SM_CLOCK * sm_mhz * 1e6) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "bytes_bound_ms": bytes_ms, "butterflies": butterflies,
            "ops_bound_ms": ops_ms, "sm_mhz": sm_mhz}


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


def pass_cases(ctx, tile: int, forward: bool, device):
    """The launches `ntt_cuda` makes for one transform, in order, as
    (kernel, args) with args (tw, tw_sh, plan or group, [tile,] scale)."""
    n = ctx.n
    tw, tw_sh = ntt_core.device_tables(ctx, device).for_direction(forward)
    scale = None if forward else (ctx.n_inv, ctx.n_inv_shoup)
    if tile >= n:
        plan = ntt_core.forward_stages(n) if forward else ntt_core.inverse_stages(n)
        return [("ntt_tile", (tw, tw_sh, plan, n, scale))]
    packed, packed_sh, local = kntt._packed_tables(ctx, tile, forward, device)
    groups = kntt.inter_groups(n, tile, forward)
    pairs = [("ntt_pair", (tw, tw_sh, g, scale if not forward and i == len(groups) - 1 else None))
             for i, g in enumerate(groups)]
    tile_case = ("ntt_tile", (packed, packed_sh, local, tile, None))
    return pairs + [tile_case] if forward else [tile_case] + pairs


def run_case(name, args, src, dst, q, plain=False) -> None:
    """One launch of `pass_cases` from `src` into `dst`: the kernel, or its
    plain version."""
    if name == "ntt_tile":
        tw, tw_sh, stages, t, scale = args
        fn = kntt.ntt_tile_plain if plain else kntt._tile_pass
        fn(src, dst, tw, tw_sh, stages, t, q, scale)
    else:
        tw, tw_sh, group, scale = args
        fn = kntt.ntt_pair_plain if plain else kntt._pair_pass
        fn(src, dst, tw, tw_sh, group, q, scale)


def misaligned(t: torch.Tensor) -> torch.Tensor:
    """A copy of `t` one word past a 16-byte boundary: the kernels' 4-byte
    access paths."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def check_kernels(rng, device, shapes=None, tile=TILE) -> dict:
    """Every kernel launch of the transforms at the main shapes and at
    CHECK_SHAPES against its plain version on the same inputs and tables,
    on `device`: out of place, in place, and from a misaligned buffer."""
    if shapes is None:
        shapes = [(b, n, tile) for b, n in MAIN_SHAPES] + list(CHECK_SHAPES)
    errs = {name: 0 for name in KERNEL_INFO}
    checks = []

    def record(entry, got, exp):
        ok = same(got, exp)
        errs[entry["kernel"]] = max(errs[entry["kernel"]], max_abs_err(got, exp))
        checks.append({**entry, "bit_exact": ok})
        if not ok:
            raise AssertionError(f"{entry['kernel']} differs from its plain version: {checks[-1]}")

    for batch, n, t in shapes:
        ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
        t = kntt.resolve_tile(t, n)
        for forward in (True, False):
            for name, args in pass_cases(ctx, t, forward, device):
                src = residues(rng, (batch, n), ctx.q, device)
                exp = torch.empty_like(src)
                run_case(name, args, src, exp, ctx.q, plain=True)
                stages = args[2]
                entry = {"kernel": name, "batch": batch, "n": n, "tile": t, "forward": forward,
                         "strides": [st.stride for st in stages] if name == "ntt_pair" else None,
                         "stages": len(stages), "scale": args[-1] is not None}
                got = torch.empty_like(src)
                run_case(name, args, src, got, ctx.q)
                record({**entry, "mode": "out of place"}, got, exp)
                got = src.clone()
                run_case(name, args, got, got, ctx.q)
                record({**entry, "mode": "in place"}, got, exp)
                if batch * n <= 1 << 16:
                    got = misaligned(src)
                    run_case(name, args, got, got, ctx.q)
                    record({**entry, "mode": "in place, misaligned"}, got, exp)
        a = residues(rng, (batch, n), ctx.q, device)
        b = residues(rng, (batch, n), ctx.q, device)
        record({"kernel": "modmul", "batch": batch, "n": n},
               kmod.modmul_cuda(a, b, ctx), kmod.modmul_plain(a, b, ctx))
    return {"max_abs_err": errs, "cases": len(checks), "checks": checks}


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def polymul_launches(n: int, tile=TILE) -> dict:
    """Launches of one polymul_ntt: 3 transforms (`launch_plan`) and 1 modmul."""
    return {**{k: 3 * v for k, v in kntt.launch_plan(n, tile).items()}, "modmul": 1}


def expected_launches(shapes=MAIN_SHAPES, tile=TILE) -> dict:
    """Launches of one polymul_ntt per shape."""
    counts = collections.Counter()
    for _, n in shapes:
        counts.update(polymul_launches(n, tile))
    return dict(counts)


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


def time_kernels(rng, device, batch: int, n: int, sm_mhz: float, tile: int = TILE) -> dict:
    """Per-launch times of each kernel at (batch, n), cold: a ring of
    buffers larger than L2, so each launch reads from device memory."""
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    words = batch * n
    ring = max(2, -(-2 * L2_BYTES // (4 * words)) + 1)
    bufs = [residues(rng, (batch, n), ctx.q, device) for _ in range(ring)]
    out = {}
    cases = dict(pass_cases(ctx, kntt.resolve_tile(tile, n), True, device))  # one B2 group at most here
    it = itertools.count()

    def record(kernel_fn, warm_fn, plain_fn, library_fn, nbytes, butterflies, **extra):
        cold = time_ms(kernel_fn, 50)
        plain = time_ms(plain_fn, 3, reps=3, warmup=1)
        rec = {**cold, "plain_ms": plain["ms"], "library_ms": None,
               **bound(nbytes, butterflies, sm_mhz), **extra}
        if warm_fn is not None:
            rec["warm_ms"] = time_ms(warm_fn, 50)["ms"]
        if library_fn is not None:
            rec["library_ms"] = time_ms(library_fn, 20)["ms"]
        return rec

    for name, args in cases.items():
        def launch(name=name, args=args):
            x = bufs[next(it) % ring]
            run_case(name, args, x, x, ctx.q)

        stages = args[2]
        table_bytes = 2 * 4 * sum(st.blocks for st in stages)
        if name == "ntt_tile":
            table_bytes = 2 * 4 * args[0].numel()  # every tile reads its packed row
            extra = {"stages": len(stages), "tile": args[3]}
        else:
            extra = {"stages": len(stages), "strides": [st.stride for st in stages]}
        out[name] = record(
            launch,
            lambda name=name, args=args: run_case(name, args, bufs[0], bufs[0], ctx.q),
            lambda name=name, args=args: run_case(name, args, bufs[0], bufs[1], ctx.q, plain=True),
            None, 2 * 4 * words + table_bytes, words // 2 * len(stages), **extra,
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
        library_modmul, 3 * 4 * words, 0,
        library_call="(a.view(int32).long() * b.view(int32).long()) % q, int64",
    )
    return out


def time_polymul(rng, device, batch: int, n: int, sm_mhz: float, tile: int = TILE) -> dict:
    """`polymul_ntt` per call, beside the sum of its launches' bounds."""
    ctx = ntt_core.make_context(mm.DEFAULT_Q, n)
    a = residues(rng, (batch, n), ctx.q, device)
    b = residues(rng, (batch, n), ctx.q, device)
    words = batch * n
    t = kntt.resolve_tile(tile, n)
    launches = polymul_launches(n, tile)
    transforms = launches["ntt_tile"]
    # each launch reads and writes the data once; B1 reads a table of n words x 2
    nbytes = ((launches["ntt_tile"] + launches["ntt_pair"]) * 2 * 4 * words
              + transforms * 2 * 4 * n + 3 * 4 * words)
    butterflies = transforms * (words // 2) * (n.bit_length() - 1)
    return {
        "batch": batch, "n": n, "tile": t,
        **time_ms(lambda: ops.polymul_ntt(a, b, ctx, tile=tile), 20),
        **bound(nbytes, butterflies, sm_mhz), "launches": launches,
    }


def sass_summary(library: str) -> dict | None:
    """Per kernel of the built library, its SASS instruction count by
    opcode class, from `cuobjdump -sass` where the toolkit has it."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        return None
    out = subprocess.run([tool, "-sass", library], capture_output=True, text=True, check=True,
                         timeout=300).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and name is not None:
            op = m.group(1)
            kernels[name][op.split(".")[0]] += 1
            if op.startswith("IMAD.HI"):
                kernels[name]["IMAD.HI"] += 1
    return {k: dict(sorted(v.items())) for k, v in kernels.items()}


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
    # a stack frame means registers arrays went to local memory; a spill, registers ran out
    local = [ln for ln in report["ptxas"] if re.search(r"\b[1-9]\d* bytes (stack frame|spill)", ln)]
    if local:
        raise AssertionError(f"ptxas reports local memory use: {local}")
    emit({"phase": "sass", "kernels": sass_summary(report["library"])})

    rng = np.random.default_rng(SEED)
    checked = check_kernels(rng, device)
    emit({"phase": "check", **checked})

    main_run = drive_main_path(rng, device)
    launches = main_run["launches"]
    expected = expected_launches()
    emit({"phase": "main", **main_run, "expected_launches": expected})
    if launches != expected or any(v <= 0 for v in launches.values()):
        raise AssertionError(f"launch counts {launches}, expected {expected}")

    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    timing = {f"{b}x{n}": time_kernels(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES}
    polymul = [time_polymul(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES]
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
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "shape": list(MAIN_SHAPES[0]),
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
