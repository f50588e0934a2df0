"""What the benchmark's tests share: a copy of the benchmark in a temporary
root, shrunk to CPU sizes, and runs of its cells on the CPU."""
from __future__ import annotations

import json
import pathlib
import shutil
import time

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
#: A CPU size of each cell: the configuration's first towers at a small N.
TINY = {"n": 64, "towers": 3, "products_per_call": 8, "check_products": 12, "trace_calls": 3}


def copy_benchmark(dest: pathlib.Path) -> pathlib.Path:
    """`BENCHMARK.json` and the benchmark's folder under `dest`."""
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(BENCH, dest / "bench", ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return dest


def shrink(root: pathlib.Path) -> None:
    """Cuts every configuration and traffic file under `root` to CPU sizes."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for entry in bench["configs"]:
        path = root / entry["file"]
        cfg = json.loads(path.read_text())
        cfg.update(n=TINY["n"], towers=TINY["towers"], moduli=cfg["moduli"][: TINY["towers"]])
        path.write_text(json.dumps(cfg))
    for path in (root / "bench" / "traffic").glob("*.json"):
        mix = json.loads(path.read_text())
        mix.update({k: TINY[k] for k in ("products_per_call", "check_products", "trace_calls")})
        path.write_text(json.dumps(mix))


def run_on_cpu(root: pathlib.Path, cell: str, seed: int = 7, seconds: float = 0.2, trace: bool = False,
               system=None) -> dict:
    from benchlib import harness
    from benchlib.spec import Spec

    return harness.run_cell(Spec(root), cell, seed, seconds, trace, "cpu", time.perf_counter(), system=system)
