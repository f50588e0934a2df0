"""The cells on the card at their own sizes, with short windows: the
program correct and every metric read, the float64 control not correct.
Run on a machine with a card:

    python -m pytest -m gpu bench/test_bench_gpu.py
"""
import time

import pytest

import benchtest
from benchlib import harness
from benchlib.spec import Spec

pytestmark = pytest.mark.gpu
CELLS = ["n15l28.polymul", "n13l7.polymul"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda:0"


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    spec = Spec(benchtest.ROOT)
    result = harness.run_cell(spec, cell, 2**31 + 17, 1.0, trace, card, time.perf_counter())
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {m["name"] for m in spec.metrics(cell, trace)}
    assert result["device"]["platform"] == "gpu" and result["device"]["memory_peak_bytes"] > 0
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        for name in ("polymul_roofline", "ntt_roofline", "modmul_roofline"):
            assert 0 < result["metrics"][name]["value"] <= 100


@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card(card, cell):
    spec = Spec(benchtest.ROOT)
    config = spec.config(spec.cell(cell)["config"])
    system = spec.reference(config["reference"]).as_system(config["moduli"], "float64")
    result = harness.run_cell(spec, cell, 2**31 + 19, 0.5, False, card, time.perf_counter(), system=system)
    assert not result["correct"] and result["checks"]["wrong_residues"]["value"] > 0
