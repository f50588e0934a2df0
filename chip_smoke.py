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
  5. rns      the RNS-CKKS path (`repro_torch.he`) at the logN = 16 level of
              a chain, n=65536 with L=16 towers: `relin_key`, then
              `ct_mul_relin` of two random ciphertexts and `rescale`,
              bit-exact against the same ops on the CPU plain path (the key
              copied over) on every tower, the keyswitch identity in the NTT
              domain checked with the numpy stage loop on sampled towers,
              and the launches of each drive equal to `rns_launches`;
  6. timing   CUDA-event times per launch beside the bound (the larger of
              bytes over the memory rate and integer instructions over the
              issue rate), the plain version and a library call where one
              exists, the whole polymul_ntt, and the RNS ops ct_mul,
              keyswitch, ct_mul_relin and rescale beside their floors.
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

from repro_torch import he, kernels  # noqa: E402
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
#: (n, towers) of the rns phase: the logN = 16 level of an RNS-CKKS chain,
#: 16 towers from rns_primes(65536, 16) (q from 2147352577 down, Q ~ 496 bits).
RNS_SHAPE = (65536, 16)
#: Towers of the rns phase checked against the numpy stage loop.
RNS_SAMPLE = 4
RNS_OPS = ("ct_mul", "keyswitch", "ct_mul_relin", "rescale")
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
    and host time); `host_ms` the host's time to enqueue one call.
    `queued_host_ms` is the enqueue time per call behind the sleep: near
    `sleep_ms / iters`, the stream's queue filled and the host waited on
    the device, so `ms` then holds host time too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    sleep_ms = 3 * iters * _events_ms(fn, iters)[1] + 1.0
    queued = [_events_ms(fn, iters, sleep_ms) for _ in range(reps)]
    plain = [_events_ms(fn, iters) for _ in range(reps)]
    device = [d for d, _ in queued]
    wall = [d for d, _ in plain]
    return {"ms": float(np.median(device)), "spread": [min(device), max(device)],
            "wall_ms": float(np.median(wall)), "wall_spread": [min(wall), max(wall)],
            "host_ms": float(np.median([h for _, h in plain])), "calls": 2 * reps * iters,
            "sleep_ms": sleep_ms, "queued_host_ms": float(np.median([h for _, h in queued]))}


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


def rns_launches(n: int, towers: int, op: str = "ct_mul_relin", tile=TILE) -> dict:
    """Launches of one call of a `he` op at (n, towers).  `ct_mul` and
    `keyswitch` each make, per tower, one forward transform call, one
    modmul call and one inverse call (2*L*T + L, T = `launch_plan`'s
    launches per transform); `ct_mul_relin` is both; `rescale` launches
    nothing.  `relin_key`: two `poly_mul_towers` (per tower a forward call,
    a modmul call and an inverse call each) and the key's NTT (per tower one
    forward call): 5*L*T + 2L."""
    transforms, modmuls = {"ct_mul": (2, 1), "keyswitch": (2, 1), "ct_mul_relin": (4, 2),
                           "rescale": (0, 0), "relin_key": (5, 2)}[op]
    return {**{k: transforms * towers * v for k, v in kntt.launch_plan(n, tile).items()},
            "modmul": modmuls * towers}


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
# phase 5: the RNS-CKKS path
# ---------------------------------------------------------------------------


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _on_cpu(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32).cpu().view(torch.uint32)


def drive_rns(device, n: int = RNS_SHAPE[0], towers: int = RNS_SHAPE[1],
              sample: int = RNS_SAMPLE, seed: int = SEED) -> dict:
    """`relin_key`, then `ct_mul_relin` and `rescale`, through the user's
    entry points on `device`, each drive between a reset and a read of the
    launch counts; then the checks of the results: every tower bit-exact
    against the same ops on the CPU plain path (the key's b and a copied
    over, its NTT form recomputed there and compared), and on `sample`
    towers, with the numpy stage loop, ct_mul's products, the keyswitch
    identity NTT(c0') + NTT(c1') NTT(s) = NTT(d2) NTT(s)^2 (c0', c1' the
    keyswitch of d2), the relinearized sum and rescale's formula; and
    intt(ntt(x)) == x on the towers."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    basis = he.make_basis(n, towers)
    s = he.make_secret(basis, seed, device=device)
    ct_a = he.random_ct(basis, seed + 1, device=device)
    ct_b = he.random_ct(basis, seed + 2, device=device)
    kernels.reset_launch_counts()
    rlk = he.relin_key(basis, s, seed=seed + 3)
    _sync(device)
    key_launches = kernels.launch_counts()
    kernels.reset_launch_counts()
    out = he.ct_mul_relin(basis, ct_a, ct_b, rlk)
    res = he.rescale(basis, out)
    _sync(device)
    launches = kernels.launch_counts()
    drive_s = time.perf_counter() - t0
    peak_mib = torch.cuda.max_memory_allocated() / 2**20 if on_card else None
    if tuple(out.shape) != (2, towers, n) or tuple(res.shape) != (2, towers - 1, n) \
            or out.dtype != torch.uint32 or res.dtype != torch.uint32:
        raise AssertionError(f"ct_mul_relin / rescale gave {tuple(out.shape)} {tuple(res.shape)}")

    # every tower against the CPU plain path on the same inputs and key
    t0 = time.perf_counter()
    cpu_key = he.KeySwitchKey(basis, _on_cpu(rlk.b), _on_cpu(rlk.a))
    key_hat_ok = all(same(_on_cpu(g), c) for g, c in zip(rlk.hat, cpu_key.hat))
    cpu_out = he.ct_mul_relin(basis, _on_cpu(ct_a), _on_cpu(ct_b), cpu_key)
    cpu_res = he.rescale(basis, cpu_out)
    out_np, res_np = mm.to_numpy_u32(out), mm.to_numpy_u32(res)
    cpu_exact = {"key_hat": key_hat_ok,
                 "ct_mul_relin": bool(np.array_equal(out_np, mm.to_numpy_u32(cpu_out))),
                 "rescale": bool(np.array_equal(res_np, mm.to_numpy_u32(cpu_res)))}
    cpu_s = time.perf_counter() - t0

    # sampled towers against the numpy stage loop, independent of the kernels
    t0 = time.perf_counter()
    d = he.ct_mul(basis, ct_a, ct_b)
    ks = he.keyswitch(basis, d.view(torch.int32)[2].view(torch.uint32), rlk)
    back = he.ntt_towers(basis, he.ntt_towers(basis, ct_a), forward=False)
    roundtrip = same(back, ct_a)
    host = {k: mm.to_numpy_u32(v).astype(np.int64)
            for k, v in (("s", s), ("a", ct_a), ("b", ct_b), ("d", d), ("ks", ks))}
    picked = np.sort(np.random.default_rng(seed).choice(towers, size=min(sample, towers), replace=False))
    identities = []
    for i in picked.tolist():
        ctx, q = basis.contexts[i], basis.moduli[i]
        rows = np.stack([host["s"][i], *host["a"][:, i], *host["b"][:, i], *host["d"][:, i],
                         *host["ks"][:, i]])
        sh, a0, a1, b0, b1, d0, d1, d2, k0, k1 = ntt_core.ntt_forward_np(rows, ctx).astype(np.int64)
        ct_mul_ok = (np.array_equal(d0, a0 * b0 % q) and np.array_equal(d2, a1 * b1 % q)
                     and np.array_equal(d1, (a0 * b1 % q + a1 * b0 % q) % q))
        keyswitch_ok = np.array_equal((k0 + k1 * sh % q) % q, d2 * sh % q * sh % q)
        relin_ok = np.array_equal(out_np[:, i], (host["d"][:2, i] + host["ks"][:, i]) % q)
        rescale_ok = None
        if i < towers - 1:
            inv = mm.inv_mod(basis.moduli[-1] % q, q)
            delta = (out_np[:, i].astype(np.int64) - out_np[:, -1].astype(np.int64) % q) % q
            rescale_ok = bool(np.array_equal(res_np[:, i], delta * inv % q))
        identities.append({"tower": i, "q": q, "ct_mul": bool(ct_mul_ok),
                           "keyswitch": bool(keyswitch_ok), "relinearize": bool(relin_ok),
                           "rescale": rescale_ok})
    identity_s = time.perf_counter() - t0

    report = {"n": n, "towers": towers, "moduli": [basis.moduli[0], basis.moduli[-1]],
              "modulus_bits": basis.modulus.bit_length(), "device": str(out.device),
              "key_launches": key_launches, "launches": launches,
              "expected_key_launches": rns_launches(n, towers, "relin_key"),
              "expected_launches": rns_launches(n, towers, "ct_mul_relin"),
              "cpu_bit_exact": cpu_exact, "towers_checked_vs_cpu": list(range(towers)),
              "identity": identities, "roundtrip": roundtrip, "peak_mib": peak_mib,
              "seconds": {"drive": drive_s, "cpu_path": cpu_s, "identity": identity_s}}
    bad = [c for c in identities if not all(v in (True, None) for k, v in c.items()
                                              if k not in ("tower", "q"))]
    if not all(cpu_exact.values()) or bad or not roundtrip:
        raise AssertionError(f"rns path wrong: {report}")
    return report


# ---------------------------------------------------------------------------
# phase 6: timing
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


def transform_floor_ms(n: int, rows: int, sm_mhz: float, tile: int = TILE) -> float:
    """Sum of the bounds of one transform's launches over `rows` rows of n:
    each launch reads and writes the rows once, B1 also its twiddle rows
    (2 x n words), each B2 launch its group's twiddles."""
    t = kntt.resolve_tile(tile, n)
    words = rows * n
    total = bound(8 * words + 8 * n, words // 2 * (t.bit_length() - 1), sm_mhz)["bound_ms"]
    for group in kntt.inter_groups(n, t, True):
        total += bound(8 * words + 8 * sum(st.blocks for st in group), words // 2 * len(group),
                       sm_mhz)["bound_ms"]
    return total


def rns_work(op: str, towers: int) -> dict:
    """What one call of `op` does at L = `towers`, in rows of n residues:
    `calls`, per tower the rows of each (forward call, inverse call, modmul
    call); `elementwise`, the rows its torch passes read and write in all
    (each pass's inputs read once and its output written once, as uint32)."""
    big_l = towers
    passes = {  # per tower: (rows read, rows written)
        "move a, b tower-major": (4, 4), "pair the operands": (4, 8), "form d": (4, 3),
        "move d back": (3, 3), "gather d2": (1, 1), "base-extend": (1, big_l),
        "repeat the digits": (big_l, 2 * big_l), "sum over digits": (2 * big_l, 2),
        "relinearize": (4, 2), "move back": (2, 2),
    }
    ct_mul = ["move a, b tower-major", "pair the operands", "form d"]
    keyswitch = ["base-extend", "repeat the digits", "sum over digits"]
    work = {
        "ct_mul": ([(4, 3, 4)], ct_mul + ["move d back"]),
        "keyswitch": ([(big_l, 2, 2 * big_l)], keyswitch + ["move back"]),
        "ct_mul_relin": ([(4, 3, 4), (big_l, 2, 2 * big_l)],
                         ct_mul + ["gather d2"] + keyswitch + ["relinearize", "move back"]),
        "rescale": ([], []),
    }
    calls, used = work[op]
    rows = big_l * sum(sum(passes[p]) for p in used)
    if op == "rescale":  # reads the L towers, writes L - 1, of 2 components
        rows = 2 * big_l + 2 * (big_l - 1)
    return {"calls": calls, "elementwise": rows}


def rns_floor_ms(op: str, n: int, towers: int, sm_mhz: float) -> dict:
    """The floor of one call of `op`: the sum of its launches' bounds plus
    its elementwise bytes over the memory rate."""
    work = rns_work(op, towers)
    kernels_ms = towers * sum(transform_floor_ms(n, fwd, sm_mhz) + transform_floor_ms(n, inv, sm_mhz)
                              + bound(12 * mul * n, 0, sm_mhz)["bound_ms"]
                              for fwd, inv, mul in work["calls"])
    elementwise_bytes = 4 * work["elementwise"] * n
    elementwise_ms = elementwise_bytes / HBM_BYTES_PER_S * 1e3
    return {"floor_ms": kernels_ms + elementwise_ms, "kernels_bound_ms": kernels_ms,
            "elementwise_bytes": elementwise_bytes, "elementwise_ms": elementwise_ms}


def device_breakdown(fn, calls: int = 3) -> dict:
    """Device time per call of `fn` by kernel, from torch.profiler's CUDA
    activity over `calls` calls: each of the port's kernels by name, every
    other device kernel (torch's elementwise passes) as `torch`.
    `busy_ms` is their sum: the device's busy time, without the gaps."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us, count = collections.Counter(), collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((k for k in KERNEL_INFO if f"{k}_kernel" in e.name), "torch")
        us[name] += e.time_range.elapsed_us()
        count[name] += 1
    return {"busy_ms": sum(us.values()) / calls / 1e3,
            "ms": {k: v / calls / 1e3 for k, v in us.items()},
            "kernels_per_call": {k: v / calls for k, v in count.items()}}


def time_rns(device, sm_mhz: float, n: int = RNS_SHAPE[0], towers: int = RNS_SHAPE[1],
             seed: int = SEED) -> dict:
    """Each RNS op per call at (n, towers): device time (one call per block,
    queued behind a GPU sleep), wall and host time, its launches by kernel
    (counted over one call and checked against `rns_launches`), its floor,
    and the device's idle share of the wall time."""
    basis = he.make_basis(n, towers)
    s = he.make_secret(basis, seed, device=device)
    rlk = he.relin_key(basis, s, seed=seed + 3)
    ct_a = he.random_ct(basis, seed + 1, device=device)
    ct_b = he.random_ct(basis, seed + 2, device=device)
    c2 = he.random_poly(basis, seed + 4, device=device)
    calls = {
        "ct_mul": lambda: he.ct_mul(basis, ct_a, ct_b),
        "keyswitch": lambda: he.keyswitch(basis, c2, rlk),
        "ct_mul_relin": lambda: he.ct_mul_relin(basis, ct_a, ct_b, rlk),
        "rescale": lambda: he.rescale(basis, ct_a),
    }
    out = {}
    for op in RNS_OPS:
        kernels.reset_launch_counts()
        calls[op]()
        torch.cuda.synchronize()
        launches = kernels.launch_counts()
        expected = rns_launches(n, towers, op)
        if launches != expected:
            raise AssertionError(f"{op}: launches {launches}, expected {expected}")
        rec = time_ms(calls[op], 1, reps=7)
        out[op] = {**rec, "launches": launches, **rns_floor_ms(op, n, towers, sm_mhz),
                   "device_idle_share": 1 - rec["ms"] / rec["wall_ms"],
                   "profile": device_breakdown(calls[op])}
    return {"n": n, "towers": towers, "ops": out}


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

    rns = drive_rns(device)
    emit({"phase": "rns", **rns})
    if (rns["launches"] != rns["expected_launches"] or rns["key_launches"] != rns["expected_key_launches"]
            or any(v <= 0 for v in rns["launches"].values())):
        raise AssertionError(f"rns launch counts {rns['key_launches']} / {rns['launches']}, expected "
                             f"{rns['expected_key_launches']} / {rns['expected_launches']}")

    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    timing = {f"{b}x{n}": time_kernels(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES}
    polymul = [time_polymul(rng, device, b, n, sm_mhz) for b, n in MAIN_SHAPES]
    rns_timing = time_rns(device, sm_mhz)
    power = nvidia_smi("name,power.limit,power.draw,clocks.sm,temperature.gpu")
    emit({"phase": "timing", "card": smi, "kernels": timing, "polymul_ntt": polymul,
          "rns": rns_timing, "nvidia_smi_after": power})

    big = timing[f"{MAIN_SHAPES[0][0]}x{MAIN_SHAPES[0][1]}"]
    rows = []
    for kname, (source, replaces) in KERNEL_INFO.items():
        rec = big[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": checked["max_abs_err"][kname],
            "launches_by_path": {"polymul_ntt": launches[kname], "rns relin_key": rns["key_launches"][kname],
                                 "rns ct_mul_relin + rescale": rns["launches"][kname]},
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
