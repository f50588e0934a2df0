"""`run.py` refuses to run where it cannot measure: without a card, and in
a checkout that holds only the benchmark.  Each case runs it in a child
interpreter and sees a non-zero exit and no result line."""
import os
import shutil
import subprocess
import sys

import pytest

from benchtest import ROOT, copy_benchmark


def run_py(root, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "bench/run.py", *args], cwd=root, env=env, capture_output=True,
                          text=True, timeout=120)


def refused(out: subprocess.CompletedProcess) -> bool:
    return out.returncode != 0 and not any(line.startswith("{") for line in out.stdout.splitlines())


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")


@pytest.mark.parametrize("cell", ["n15l28.polymul", "n13l7.polymul"])
def test_refuses_without_a_card(no_card, cell):
    out = run_py(ROOT, "--workload", cell, "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0")
    assert refused(out), out
    assert "CUDA card" in out.stderr


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    copy_benchmark(tmp_path)
    out = run_py(tmp_path, "--workload", "n15l28.polymul", "--seed", "1", "--seconds", "1", "--trace", "0")
    assert refused(out), out
    assert "does not import" in out.stderr


def test_refuses_an_unknown_cell():
    out = run_py(ROOT, "--workload", "no-such-cell", "--seed", "1", "--seconds", "1")
    assert refused(out) and "no workload named" in out.stderr, out


def test_needs_every_argument():
    out = run_py(ROOT, "--workload", "n15l28.polymul", "--seconds", "1")
    assert refused(out) and "--seed" in out.stderr, out


def test_the_checkout_keeps_no_build_output():
    """What runs write inside the checkout is ignored by git."""
    assert {".cache/", "__pycache__/"} <= set((ROOT / "bench" / ".gitignore").read_text().split())
    if (ROOT / ".git").exists() and shutil.which("git"):
        for path in ("bench/.cache/torch_extensions/x", "src/repro_torch/kernels/_build/x"):
            assert subprocess.run(["git", "check-ignore", "-q", path], cwd=ROOT).returncode == 0, path
