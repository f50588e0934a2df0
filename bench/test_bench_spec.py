"""The harness finds a configuration, a traffic mix and a per-layer metric
by name: planted as new files plus `BENCHMARK.json` entries in a copy of
the benchmark, they run with no file that was there edited."""
import hashlib
import json

import pytest

import benchtest
from benchlib.spec import Spec, SpecError

PLANTED_METRIC = '''"""Products a call, as the cell's mix gives them."""


def read(run):
    return float(run.products_per_call)
'''


def digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def plant(root):
    """A new configuration (4 towers at N = 32), a mix with a shared operand,
    a per-layer metric and a cell that uses them."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / "bench" / "configs" / "ckks-n15-l28.json").read_text())
    config = {**base, "name": "planted-n5-l4", "n": 32, "towers": 4, "moduli": base["moduli"][:4]}
    (root / "bench" / "configs" / "planted-n5-l4.json").write_text(json.dumps(config))
    mix = {**json.loads((root / "bench" / "traffic" / "polymul-b2048.json").read_text()),
           "products_per_call": 6, "shared_operand": 1, "check_products": 9, "trace_calls": 3}
    (root / "bench" / "traffic" / "planted-shared.json").write_text(json.dumps(mix))
    (root / "bench" / "metrics" / "planted_products.py").write_text(PLANTED_METRIC)
    bench["configs"].append({"name": "planted-n5-l4", "source": "a test", "file": "bench/configs/planted-n5-l4.json",
                             "reduced": ["n", "towers"], "why": "a test"})
    bench["workloads"].append({"name": "planted.shared", "config": "planted-n5-l4", "traffic": "planted-shared",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "planted_products", "unit": "polymul", "better": "higher",
                               "source": "program_counter", "layer": "a test", "moves": "polymul_per_s",
                               "workloads": ["planted.shared"]})
    bench["end_to_end"][0]["workloads"].append("planted.shared")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))


def test_planted_files_run_without_an_edit(tmp_path):
    root = benchtest.copy_benchmark(tmp_path)
    before = digests(root / "bench")
    plant(root)
    after = digests(root / "bench")
    assert {k: v for k, v in after.items() if k in before} == before  # nothing there was edited
    assert set(after) - set(before) == {"configs/planted-n5-l4.json", "traffic/planted-shared.json",
                                        "metrics/planted_products.py"}
    timed = benchtest.run_on_cpu(root, "planted.shared", seed=3, trace=False)
    assert timed["correct"] and set(timed["metrics"]) == {"polymul_per_s", "setup_s"}, timed
    traced = benchtest.run_on_cpu(root, "planted.shared", seed=3, trace=True)
    assert traced["correct"], traced
    assert traced["metrics"]["planted_products"] == {"value": 6.0, "unit": "polymul"}


def test_metrics_follow_their_cells():
    spec = Spec(benchtest.ROOT)
    for cell in ("n15l28.polymul", "n13l7.polymul"):
        assert [m["name"] for m in spec.metrics(cell, False)] == ["polymul_per_s", "setup_s"]
        assert [m["name"] for m in spec.metrics(cell, True)] == [
            "polymul_roofline", "rns_copy_share", "host_ms_per_call", "launches_per_call", "ntt_roofline",
            "modmul_roofline", "device_idle"]
    assert [m["name"] for m in spec.metrics("a-later-cell", False)] == ["setup_s"]


def test_every_named_file_is_there():
    spec = Spec(benchtest.ROOT)
    for cell in spec.data["workloads"]:
        config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
        assert config["name"] == cell["config"] and len(config["moduli"]) == config["towers"]
        spec.generator(mix["generator"]).build  # noqa: B018
        spec.reference(config["reference"]).poly_mul  # noqa: B018
    for metric in spec.data["end_to_end"] + spec.data["per_layer"]:
        assert callable(spec.reader(metric["name"]).read)


def test_unknown_names_are_refused():
    spec = Spec(benchtest.ROOT)
    with pytest.raises(SpecError):
        spec.cell("no-such-cell")
    with pytest.raises(SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(SpecError):
        spec.reader("no_such_metric")
