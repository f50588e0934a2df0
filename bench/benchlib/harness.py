"""One run of one cell: set-up, the measured window, the traced stretch,
the check, and the result line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up runs from the first line of `run.py` to the first timed call:
importing torch and the program, building or loading the kernels, the
cell's basis and device tables, the operands drawn on the device, and
`warmup_calls` calls.  The window then issues calls for `--seconds`
seconds, at most `inflight` outstanding (before each call it waits on the
event of the call `inflight` places back), and ends with a synchronise;
every product it issued counts as done.  With `--trace 1` a stretch of
`trace_calls` more calls runs under the profiler after the window.  Then
the program's state is dropped and the generator checks the products it
kept against the configuration's reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import time

from benchlib import peaks
from benchlib import trace as trace_mod
from benchlib.spec import Spec, SpecError

ROOT = pathlib.Path(__file__).resolve().parents[2]
#: Top-level module names that no run may hold once its window has closed.
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules() -> list[str]:
    """The names of `FOREIGN` that `sys.modules` holds, by top-level name."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FOREIGN))


@dataclasses.dataclass
class Window:
    """Calls issued in one stretch of the loop, and what they took."""

    calls: int
    products: int
    seconds: float  # host clock, first call's start to the synchronise's end
    host_call_s: list[float]  # each call's start to its return
    launches: dict[str, int]  # the program's kernel launches in the stretch


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: dict
    config: dict
    mix: dict
    setup_s: float
    window: Window
    trace_window: Window | None
    trace: trace_mod.TraceReading | None
    hbm_bytes_per_s: float | None

    @property
    def n(self) -> int:
        return self.config["n"]

    @property
    def towers(self) -> int:
        return self.config["towers"]

    @property
    def products_per_call(self) -> int:
        return self.mix["products_per_call"]

    @property
    def shared(self) -> int:
        return self.mix.get("shared_operand", 0)


def drive(workload, device, inflight: int, done, on_output=None, span=None) -> Window:
    """Issues calls until `done(calls, seconds)`; each call's output goes to
    `on_output`; `span(name)` wraps each harness step."""
    import torch

    span = span or (lambda name: contextlib.nullcontext())
    cuda = device.type == "cuda"
    ring = [torch.cuda.Event() for _ in range(inflight)] if cuda else []
    host: list[float] = []
    before = workload.launches()
    calls = 0
    start = time.perf_counter()
    while True:
        if cuda and calls >= inflight:
            with span("bench.wait"):
                ring[calls % inflight].synchronize()
        with span("bench.call"):
            c0 = time.perf_counter()
            out = workload.issue(calls)
            host.append(time.perf_counter() - c0)
        if cuda:
            ring[calls % inflight].record()
        if on_output is not None:
            on_output(calls, out)
        del out
        calls += 1
        if done(calls, time.perf_counter() - start):
            break
    with span("bench.sync"):
        if cuda:
            torch.cuda.synchronize(device)
    seconds = time.perf_counter() - start
    after = workload.launches()
    return Window(calls=calls, products=calls * workload.products_per_call, seconds=seconds, host_call_s=host,
                  launches={k: v - before.get(k, 0) for k, v in after.items()})


def _traced(workload, device, inflight: int, calls: int) -> tuple[Window, trace_mod.TraceReading | None]:
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as tmp:
        with profile(activities=activities) as prof:
            window = drive(workload, device, inflight, lambda c, s: c >= calls, span=record_function)
        if not cuda:
            return window, None
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        return window, trace_mod.read_chrome_trace(path)


def power_limit_w(device) -> float | None:
    """The card's power limit as `nvidia-smi` reads it, None where it cannot."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", str(device.index or 0)], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool, device, t0: float,
             system=None) -> dict:
    """One run of cell `name` on `device`; `system` stands in for the
    program's entry where given (the control, a planted fault).  Returns
    the result line's object, with the seconds of set-up by part under
    `setup` (which `main` prints apart)."""
    import torch

    entered = time.perf_counter()
    cell = spec.cell(name)
    config = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    reference = spec.reference(config["reference"])
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    workload = spec.generator(mix["generator"]).build(config, mix, seed, device, reference, system=system)
    built = time.perf_counter()
    inflight = mix["inflight"]
    drive(workload, device, inflight, lambda c, s: c >= mix["warmup_calls"], on_output=workload.warm)
    setup_s = time.perf_counter() - t0
    phases = {"imports_s": entered - t0, "build_s": built - entered, **workload.phases,
              "warmup_s": t0 + setup_s - built}
    window = drive(workload, device, inflight, lambda c, s: s >= seconds, on_output=workload.keep)
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell["chips"] if cuda else 0,
           "memory_peak_bytes": torch.cuda.max_memory_allocated(device) if cuda else 0}
    trace_window = reading = None
    if trace:
        trace_window, reading = _traced(workload, device, inflight, mix["trace_calls"])
        if reading is not None:
            dev.update(busy_s=reading.busy_s, window_s=reading.window_s, power_limit_w=power_limit_w(device))
    checks = workload.verify()
    run = Run(cell=cell, config=config, mix=mix, setup_s=setup_s, window=window, trace_window=trace_window,
              trace=reading, hbm_bytes_per_s=peaks.hbm_bytes_per_s(kind))
    metrics = {}
    for metric in spec.metrics(name, trace):
        value = spec.reader(metric["name"]).read(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": window.products, "failed": workload.failed, "metrics": metrics, "device": dev}
    if reading is not None:
        result["breakdown"] = reading.breakdown()
    result["setup"] = phases
    result["checks"] = checks
    return result


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="bench/run.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str], t0: float) -> int:
    args = parse(argv)
    try:
        spec = Spec(ROOT)
        cell = spec.cell(args.workload)
    except (OSError, ValueError, KeyError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import repro_torch.he  # noqa: F401
    except ImportError as e:
        print(f"bench: the program (src/repro_torch) does not import in this checkout: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    except SpecError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    found = foreign_modules()  # the window has closed: whatever the run loaded is here
    if found:
        print(f"bench: the run holds {', '.join(found)} in sys.modules; no result", file=sys.stderr)
        return 3
    print("setup " + " ".join(f"{k} {v:.3f}" for k, v in result.pop("setup").items()), file=sys.stderr)
    for key, check in result["checks"].items():
        print(f"check {key} {check['value']} limit {check['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
