"""`spans.py` over planted Chrome-trace events: host spans, launch events
and device operations joined by `correlation`, as the profiler exports
them; the harness's readers of the trace reading the same with and
without the program's spans; and `counters.py` over a window of the
program on the CPU, as `probe_spans.py` reads it."""
import pytest
import torch

import benchtest
import probe_spans
from benchlib import counters, harness, spans, trace
from benchlib.spec import Spec

HOST, DEVICE = {"pid": 1, "tid": 1}, {"pid": 0, "tid": 7}
SPLIT_OP, JOIN_OP = "CatArrayBatchedCopy", "CatArrayBatchedCopy_vectorized"
NTT_FWD, NTT_INV, MODMUL = "ntt_tile_kernel<false>", "ntt_tile_kernel<true>", "modmul_kernel"


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, **HOST}


def product_call(h, d, corr):
    """One product call entered on the host at `h`: its spans, each
    launch, and the operations it launched, back to back on the device
    from `d` (with the device-side copy of each span, which is no
    operation)."""
    host = [span("repro_torch.rns.poly_mul_towers", h + 1, 44), span("repro_torch.rns.split", h + 2, 4),
            span("repro_torch.rns.towers", h + 7, 33), span("repro_torch.kernels.ntt_cuda", h + 8, 4),
            span("repro_torch.kernels.modmul_cuda", h + 13, 3), span("repro_torch.kernels.ntt_cuda", h + 17, 4),
            span("repro_torch.rns.join", h + 41, 3)]
    launched = [(h + 3, SPLIT_OP, 8), (h + 9, NTT_FWD, 10), (h + 14, MODMUL, 5), (h + 18, NTT_INV, 10),
                (h + 42, JOIN_OP, 4)]
    events = list(host)
    for i, (at, op, dur) in enumerate(launched):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": at, "dur": 1,
                       "args": {"correlation": corr + i}, **HOST})
        events.append({"ph": "X", "cat": "kernel", "name": f"void {op}(unsigned int*)", "ts": d, "dur": dur,
                       "args": {"correlation": corr + i}, **DEVICE})
        d += dur
    events.append({"ph": "X", "cat": "gpu_user_annotation", "name": "repro_torch.rns.split", "ts": d - 37, "dur": 8,
                   **DEVICE})
    return events


def planted(without=()):
    """Two calls, `inflight` 2: the first's operations run from 20 to 57
    us; the wait runs 50-60, so the steady window is 50-117 us; the device
    idles 57-80 while the host enqueues the second call, whose spans are
    open from 61.  Spans named in `without` (a prefix) are left out."""
    events = ([span("bench.call", 0, 50)] + product_call(0, 20, 1) + [span("bench.wait", 50, 10)]
              + [span("bench.call", 60, 50)] + product_call(60, 80, 101) + [span("bench.sync", 110, 20)])
    return [e for e in events if not any(e["name"].startswith(p) for p in without)]


DEVICE_US = 2 * 37
WINDOW_US = 117 - 50


def test_operations_go_to_the_innermost_span_that_launched_them():
    reading = spans.read(planted())
    assert reading.launched_s(spans.SPLIT) == pytest.approx(2 * 8e-6)
    assert reading.launched_s(spans.JOIN) == pytest.approx(2 * 4e-6)
    # a kernel launched under ntt_cuda inside towers counts for ntt_cuda alone
    assert reading.launched["repro_torch.kernels.ntt_cuda"] == pytest.approx({NTT_FWD: 20e-6, NTT_INV: 20e-6})
    assert reading.launched_s("repro_torch.rns.towers") == 0.0
    assert reading.device_share(spans.SPLIT) == pytest.approx(100 * 16 / DEVICE_US)
    assert reading.device_share(spans.JOIN) == pytest.approx(100 * 8 / DEVICE_US)
    assert reading.counts[spans.OP_SPAN] == 2 and reading.counts["repro_torch.kernels.ntt_cuda"] == 4


def test_idle_goes_to_the_span_open_over_it():
    reading = spans.read(planted())
    assert reading.window_s == pytest.approx(WINDOW_US * 1e-6)
    # idle 57-80: the wait and the call before the product's span (57-61), then the product's spans
    assert reading.idle_s[spans.OUTSIDE] == pytest.approx(4e-6)
    assert reading.idle_s["repro_torch.rns.split"] == pytest.approx(4e-6)
    assert reading.idle_s["repro_torch.kernels.ntt_cuda"] == pytest.approx(4e-6 + 3e-6)
    assert sum(reading.idle_s.values()) == pytest.approx(23e-6)
    assert reading.idle_in_program_share() == pytest.approx(100 * 19 / WINDOW_US)
    assert reading.idle_in_program_share() <= 100 * (1 - trace.read(planted()).busy_s / WINDOW_US / 1e-6)


def test_a_trace_without_program_spans_reads_nothing():
    reading = spans.read(planted(without=("repro_torch.",)))
    assert reading.device_share(spans.SPLIT) is None and reading.device_share(spans.JOIN) is None
    assert reading.idle_in_program_share() is None


def test_a_product_without_a_split_reads_zero():
    """Where the product's span is there and the split's is not (a program
    that copies nothing, or copies elsewhere), the split's share is 0.0."""
    reading = spans.read(planted(without=(spans.SPLIT,)))
    assert reading.device_share(spans.SPLIT) == 0.0
    assert reading.launched[spans.OP_SPAN] == pytest.approx({SPLIT_OP: 16e-6})
    assert reading.device_share(spans.JOIN) == pytest.approx(100 * 8 / DEVICE_US)


def run_of(events):
    window = harness.Window(calls=2, products=16, seconds=1.0, host_call_s=[1e-3, 1e-3], launches={})
    return harness.Run(cell={}, config={"n": 64, "towers": 3}, mix={"products_per_call": 8}, setup_s=0.0,
                       window=window, trace_window=window, trace=trace.read(events), hbm_bytes_per_s=3.35e12)


def test_split_and_join_make_up_the_copy_share():
    reader = Spec(benchtest.ROOT).reader("rns_copy_share")
    reading = spans.read(planted())
    total = reading.device_share(spans.SPLIT) + reading.device_share(spans.JOIN)
    assert total == pytest.approx(reader.read(run_of(planted())))


@pytest.mark.parametrize("metric", ["device_idle", "rns_copy_share", "ntt_roofline", "modmul_roofline"])
def test_the_harness_readers_read_the_same_with_program_spans(metric):
    reader = Spec(benchtest.ROOT).reader(metric)
    with_spans = reader.read(run_of(planted()))
    assert with_spans is not None
    assert with_spans == reader.read(run_of(planted(without=("repro_torch.",))))


def test_the_steady_window_is_trace_py_s():
    for events in (planted(), planted(without=("bench.wait",))):
        assert spans.read(events).window_s == pytest.approx(trace.read(events).window_s, abs=1e-12)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = benchtest.copy_benchmark(tmp_path_factory.mktemp("bench"))
    benchtest.shrink(root)
    return root


def cpu_window(root, cell):
    from repro_torch.he import rns

    spec = Spec(root)
    entry = spec.cell(cell)
    config, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    device = torch.device("cpu")
    workload = spec.generator(mix["generator"]).build(config, mix, 2**31 + 7, device,
                                                      spec.reference(config["reference"]))
    harness.drive(workload, device, mix["inflight"], lambda c, s: c >= mix["warmup_calls"], on_output=workload.warm)
    rns.reset_counters()
    return probe_spans.window_reading(workload, device, mix, 0.2)


@pytest.mark.parametrize("cell", ["n15l28.polymul", "n13l7.polymul"])
def test_the_window_reads_the_program_s_counters(tiny, cell):
    got = cpu_window(tiny, cell)
    assert got["copy_bytes_ratio"] == 2.0  # operands copied once tower-major, results once back
    assert got["op_host_ms_per_call"] > 0 and got["wrapper_ms_per_call"] > 0
    assert got["dispatch_us_per_launch"] is None  # the CPU runs the plain versions: no launches


def test_a_program_without_the_counters_reads_none(tiny, monkeypatch):
    from repro_torch.he import rns

    monkeypatch.delattr(rns, "counters")
    assert counters.snapshot() is None
    got = cpu_window(tiny, "n13l7.polymul")
    assert "copy_bytes_ratio" not in got and got["calls"] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["n15l28.polymul", "n13l7.polymul"])
def test_the_program_s_spans_and_counters_on_the_card(card, cell):
    """Each cell at its own size, a short window: the copies counted at
    twice the op's least bytes, split and join adding up to the harness's
    copy share, the idle under program spans within the device's idle, and
    no span entered with the spans off."""
    spec = Spec(benchtest.ROOT)
    entry = spec.cell(cell)
    config, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    workload = spec.generator(mix["generator"]).build(config, mix, 2**31 + 23, card,
                                                      spec.reference(config["reference"]))
    harness.drive(workload, card, mix["inflight"], lambda c, s: c >= mix["warmup_calls"], on_output=workload.warm)
    window = probe_spans.window_reading(workload, card, mix, 1.0)
    assert window["copy_bytes_ratio"] == 2.0 and window["dispatch_us_per_launch"] > 0
    towers = config["towers"]
    traced = probe_spans.traced_reading(workload, card, mix, True)
    assert traced["spans_per_call"] == {"repro_torch.kernels.modmul_cuda": towers,
                                        "repro_torch.kernels.ntt_cuda": 2 * towers, "repro_torch.rns.join": 1,
                                        "repro_torch.rns.poly_mul_towers": 1, "repro_torch.rns.split": 1,
                                        "repro_torch.rns.towers": 1}
    assert abs(traced["split_share"] + traced["join_share"] - traced["rns_copy_share"]) < 0.5
    assert traced["idle_in_program_share"] <= traced["device_idle"]
    assert probe_spans.traced_reading(workload, card, mix, False)["spans_per_call"] == {}
    checks = workload.verify()
    assert all(c["value"] <= c["limit"] for c in checks.values()), checks
