"""The yardstick's arithmetic: the bytes behind each roofline share at both
cells' shapes against hand-worked values, the metric readers on a made-up
run, and the profiler trace's reading on made-up events."""
import pytest

from benchlib import roofline, trace
from benchlib.harness import Run, Window
from benchlib.spec import Spec

import benchtest

H100 = 3.35e12


def test_polymul_bytes_hand_worked():
    # a, b and c once: 3 x 4 B x L x N a product
    assert roofline.polymul_bytes_per_call(32768, 28, 512, 0) == 5_637_144_576 == 512 * 11_010_048
    assert roofline.polymul_bytes_per_call(8192, 7, 2048, 0) == 1_409_286_144 == 2048 * 688_128
    # one b a call when it is shared
    assert roofline.polymul_bytes_per_call(32768, 28, 512, 1) == 1025 * 3_670_016


def test_ntt_bytes_hand_worked():
    # per tower: a forward over 2B rows and an inverse over B rows, each of
    # k launches reading and writing its array, and two twiddle tables of 8N B
    assert roofline.ntt_launch_bytes(32768, 1024) == 268_435_456
    assert roofline.ntt_table_bytes(32768) == 262_144
    assert roofline.ntt_bytes_per_call(32768, 28, 512, 2) == 28 * (2 * (268_435_456 + 134_217_728) + 524_288)
    assert roofline.ntt_bytes_per_call(32768, 28, 512, 2) == 22_563_258_368
    assert roofline.ntt_bytes_per_call(8192, 7, 2048, 1) == 2_819_489_792


def test_modmul_bytes_hand_worked():
    assert roofline.modmul_bytes_per_call(32768, 28, 512) == 5_637_144_576
    assert roofline.modmul_bytes_per_call(8192, 7, 2048) == 1_409_286_144


def test_share():
    assert roofline.share(H100, 1.0, H100) == pytest.approx(100.0)
    assert roofline.share(H100 / 4, 0.5, H100) == pytest.approx(50.0)
    assert roofline.share(1.0, 0.0, H100) is None
    assert roofline.share(1.0, 1.0, None) is None


def events():
    """Two calls, the first wait between them, a drain; times in us."""
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [
        x("user_annotation", "bench.call", 0, 10), x("user_annotation", "bench.wait", 10, 10),
        x("user_annotation", "bench.call", 20, 10), x("user_annotation", "bench.sync", 30, 70),
        x("user_annotation", "aten::cat", 1, 2),
        x("gpu_user_annotation", "bench.call", 0, 100),
        x("kernel", "void (anonymous namespace)::ntt_tile_kernel<false>(unsigned int const*, int)", 5, 20),
        x("kernel", "(anonymous namespace)::modmul_kernel(unsigned int const*, long long)", 27, 33),
        x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 60, 2),
    ]


def test_trace_reading():
    r = trace.read(events())
    # steady window: the first wait (10 us) to the last operation's end (62 us)
    assert r.window_s == pytest.approx(52e-6)
    assert r.busy_s == pytest.approx(50e-6)  # 15 + 33 + 2; the annotation on the device is no operation
    assert r.ops == {"ntt_tile_kernel<false>": [pytest.approx(20e-6), 1],
                     "modmul_kernel": [pytest.approx(33e-6), 1], "Memcpy DtoD": [pytest.approx(2e-6), 1]}
    assert r.gaps == [(pytest.approx(2e-6), "bench.call")]
    assert r.kernels("ntt_tile_kernel", "modmul_kernel") == (pytest.approx(53e-6), 2)
    b = r.breakdown()
    assert [name for name, _ in b["device_ops"]] == ["modmul_kernel", "ntt_tile_kernel<false>", "Memcpy DtoD"]
    assert b["idle_gaps"] == [["bench.call", pytest.approx(2e-6)]]


def test_trace_without_device_operations_is_refused():
    with pytest.raises(ValueError, match="no device operation"):
        trace.read([e for e in events() if e["cat"] == "user_annotation"])


@pytest.mark.parametrize("raw, name", [
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 4>(int*, at::native::X<int>, int)",
     "at::native::CatArrayBatchedCopy<int, 4>"),
    ("void (anonymous namespace)::ntt_pair_kernel<2, 4, true>(unsigned int const*, long long)",
     "ntt_pair_kernel<2, 4, true>"),
    ("Memset (Device)", "Memset"),
])
def test_op_names(raw, name):
    assert trace.op_name(raw) == name


def made_up_run(cell: str, trace_reading) -> Run:
    spec = Spec(benchtest.ROOT)
    entry = spec.cell(cell)
    config, mix = spec.config(entry["config"]), spec.traffic(entry["traffic"])
    b = mix["products_per_call"]
    window = Window(calls=100, products=100 * b, seconds=2.0, host_call_s=[0.004] * 100,
                    launches={"ntt_tile": 2 * 2 * config["towers"] * 100, "modmul": config["towers"] * 100})
    traced = Window(calls=10, products=10 * b, seconds=0.2, host_call_s=[0.004] * 10, launches={})
    return Run(cell=entry, config=config, mix=mix, setup_s=12.5, window=window, trace_window=traced,
               trace=trace_reading, hbm_bytes_per_s=H100)


def test_readers_on_a_made_up_run():
    towers = 28
    reading = trace.TraceReading(
        window_s=0.25, busy_s=0.24,
        ops={"ntt_tile_kernel<true>": [0.1, 2 * towers * 10], "ntt_pair_kernel<2, 4, true>": [0.05, 2 * towers * 10],
             "modmul_kernel": [0.04, towers * 10], "at::native::CatArrayBatchedCopy<int>": [0.06, 10]},
        gaps=[])
    run = made_up_run("n15l28.polymul", reading)
    spec = Spec(benchtest.ROOT)

    def read(name):
        return spec.reader(name).read(run)

    assert read("polymul_per_s") == pytest.approx(100 * 512 / 2.0)
    assert read("setup_s") == 12.5
    assert read("polymul_roofline") == pytest.approx(100 * 100 * 5_637_144_576 / (2.0 * H100))
    assert read("host_ms_per_call") == pytest.approx(4.0)
    assert read("launches_per_call") == pytest.approx(5 * towers)
    # 2 launches a transform: 4 x 28 x 10 NTT launches over 10 calls
    assert read("ntt_roofline") == pytest.approx(100 * 10 * 22_563_258_368 / (0.15 * H100))
    assert read("modmul_roofline") == pytest.approx(100 * 10 * 5_637_144_576 / (0.04 * H100))
    assert read("rns_copy_share") == pytest.approx(100 * 0.06 / 0.25)
    assert read("device_idle") == pytest.approx(100 * (1 - 0.24 / 0.25))


def test_readers_find_nothing_without_a_trace():
    run = made_up_run("n13l7.polymul", None)
    spec = Spec(benchtest.ROOT)
    for name in ("rns_copy_share", "ntt_roofline", "modmul_roofline", "device_idle"):
        assert spec.reader(name).read(run) is None
    run.hbm_bytes_per_s = None
    assert spec.reader("polymul_roofline").read(run) is None
    run.window.launches = {}
    assert spec.reader("launches_per_call").read(run) is None
