"""The program's spans and counters in one cell, read as per-layer numbers,
and what the spans cost:

    python bench/probe_spans.py --workload <cell> --seed <n> --seconds <s> [--stretches <k>] [--out <file>]

from the root of a checkout, on a machine with a CUDA card (without one it
exits with 2).  Set-up and the window run as in `run.py`, tracing off.  At
the window's edges the probe takes the program's counters
(`benchlib.counters`) and reads their change as `dispatch_us_per_launch`,
`op_host_ms_per_call` and `copy_bytes_ratio`, beside the harness's
`host_ms_per_call` and `launches_per_call`.  Then come `--stretches` pairs
of traced stretches of the mix's `trace_calls` calls, the program's spans
on and off in turn (off: the program's span helper gives its null context
while the profiler records, so the pair prices the spans).  `trace.py`
reads each stretch (`device_idle`, `rns_copy_share`, host time a call) and
`spans.py` the program's spans in it (`split_share`, `join_share`,
`idle_in_program_share`, device and idle time by innermost span).  Last,
the generator checks the kept products.  Prints one JSON object as the
last line of standard output, and writes it to `--out` where given.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import statistics
import sys
import tempfile
import time

T0 = time.perf_counter()

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from benchlib import counters, harness, roofline, spans, trace  # noqa: E402
from benchlib.spec import Spec  # noqa: E402

TOP_OPS = 4  # operations named per span


def window_reading(workload, device, mix: dict, seconds: float) -> dict:
    """The window, tracing off, and the program's counters over it."""
    before = counters.snapshot()
    window = harness.drive(workload, device, mix["inflight"], lambda c, s: s >= seconds, on_output=workload.keep)
    after = counters.snapshot()
    out = {"calls": window.calls, "polymul_per_s": window.products / window.seconds,
           "host_ms_per_call": 1e3 * statistics.fmean(window.host_call_s),
           "launches_per_call": sum(window.launches.values()) / window.calls}
    if before is None or after is None:
        return out
    d = counters.delta(before, after)
    per_call = roofline.polymul_bytes_per_call(workload.config["n"], workload.config["towers"],
                                               mix["products_per_call"], mix.get("shared_operand", 0))
    return {**out, "dispatch_us_per_launch": counters.dispatch_us_per_launch(d),
            "op_host_ms_per_call": counters.op_host_ms_per_call(d, window.calls),
            "copy_bytes_ratio": counters.copy_bytes_ratio(d, per_call * window.calls),
            "wrapper_ms_per_call": 1e3 * d["wrapper_s"] / window.calls}


@contextlib.contextmanager
def program_spans(on: bool):
    """The program's spans as they are (`on`), or its span helper replaced
    by a null context for the block."""
    if on:
        yield
        return
    from repro_torch.he import rns
    from repro_torch.kernels import _build

    saved = _build.span, rns.span
    _build.span = rns.span = lambda name: contextlib.nullcontext()
    try:
        yield
    finally:
        _build.span, rns.span = saved


def traced_reading(workload, device, mix: dict, spans_on: bool) -> dict:
    """One traced stretch of `trace_calls` calls, read by `trace.py` and `spans.py`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    calls = mix["trace_calls"]
    with program_spans(spans_on), tempfile.TemporaryDirectory(prefix="bench-probe-") as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window = harness.drive(workload, device, mix["inflight"], lambda c, s: c >= calls,
                                   span=record_function)
        path = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    t, s = trace.read(events), spans.read(events)
    port, _ = t.kernels(*roofline.NTT_KERNELS, *roofline.MODMUL_KERNELS)
    by_span = {}
    for span, ops in s.launched.items():
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP_OPS]
        by_span[span or "outside"] = {"device_ms_per_call": 1e3 * sum(ops.values()) / window.calls,
                                      "ops_ms": {op: 1e3 * sec for op, sec in top}}
    return {"spans": spans_on, "calls": window.calls,
            "host_ms_per_call": 1e3 * statistics.fmean(window.host_call_s),
            "device_idle": 100.0 * (1.0 - t.busy_s / t.window_s),
            "rns_copy_share": 100.0 * (t.device_s - port) / t.device_s,
            "split_share": s.device_share(spans.SPLIT), "join_share": s.device_share(spans.JOIN),
            "idle_in_program_share": s.idle_in_program_share(),
            "spans_per_call": {name: n / window.calls for name, n in sorted(s.counts.items())},
            "by_span": by_span,
            "idle_ms_by_span": {span or "outside": 1e3 * sec for span, sec in sorted(s.idle_s.items())},
            "idle_gaps_ms": [[span, 1e3 * sec] for sec, span in t.gaps[:trace.TOP]]}


def parse(argv: list[str]) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="bench/probe_spans.py", description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--stretches", type=int, default=2, help="pairs of traced stretches, spans on and off")
    p.add_argument("--out", type=pathlib.Path, help="also write the result here")
    return p.parse_args(argv)


def main(argv: list[str]) -> int:
    args = parse(argv)
    spec = Spec(harness.ROOT)
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch

    import repro_torch.he  # noqa: F401

    if not torch.cuda.is_available():
        print("probe_spans: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", torch.cuda.current_device())
    workload = spec.generator(mix["generator"]).build(config, mix, args.seed, device,
                                                      spec.reference(config["reference"]))
    harness.drive(workload, device, mix["inflight"], lambda c, s: c >= mix["warmup_calls"], on_output=workload.warm)
    result = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(device),
              "power_limit_w": harness.power_limit_w(device), "setup_s": time.perf_counter() - T0,
              "window": window_reading(workload, device, mix, args.seconds), "traced": []}
    for i in range(args.stretches):
        for on in ((True, False) if i % 2 == 0 else (False, True)):
            result["traced"].append(traced_reading(workload, device, mix, on))
    checks = workload.verify()
    result["correct"] = all(c["value"] <= c["limit"] for c in checks.values())
    line = json.dumps(result)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
