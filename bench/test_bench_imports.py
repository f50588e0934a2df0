"""Nothing the benchmark runs imports JAX or the JAX package `repro`
(top-level names compared whole: the port `repro_torch` begins with
`repro`), and the reference imports nothing of the port either.  Each
check runs in a child interpreter."""
import json
import subprocess
import sys

from benchtest import BENCH, ROOT

FOREIGN = ["jax", "jaxlib", "flax", "repro"]


def top_level_after(code: str) -> set[str]:
    script = (f"import sys\nsys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]\n{code}\n"
              "print(__import__('json').dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=180, cwd=ROOT,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_and_everything_it_loads_import_no_jax():
    code = """
from benchlib import harness
from benchlib.spec import Spec
import repro_torch.he, repro_torch.kernels
spec = Spec(harness.ROOT)
for cell in spec.data["workloads"]:
    config, mix = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    spec.generator(mix["generator"]); spec.reference(config["reference"])
for metric in spec.data["end_to_end"] + spec.data["per_layer"]:
    spec.reader(metric["name"])
import importlib.util
for name in ("run", "control"):
    s = importlib.util.spec_from_file_location("bench_" + name, harness.ROOT / "bench" / (name + ".py"))
    s.loader.exec_module(importlib.util.module_from_spec(s))
"""
    names = top_level_after(code)
    assert "repro_torch" in names and "benchlib" in names
    assert not names & set(FOREIGN), sorted(names & set(FOREIGN))


def test_the_reference_imports_nothing_of_the_program():
    code = """
import importlib.util, pathlib
path = pathlib.Path(%r) / "references" / "rns_negacyclic.py"
s = importlib.util.spec_from_file_location("reference", path)
m = importlib.util.module_from_spec(s); s.loader.exec_module(m)
import torch
m.poly_mul(torch.ones(1, 2, 8, dtype=torch.int64), torch.ones(1, 2, 8, dtype=torch.int64), (2147352577, 2146959361))
""" % str(BENCH)
    names = top_level_after(code)
    assert not names & set(FOREIGN + ["repro_torch", "benchlib"]), sorted(names)


def test_a_run_refuses_a_process_that_holds_jax():
    """A run whose process holds `jax` once the window has closed exits
    with 3 and prints no result; `repro_torch` alone is no JAX package.
    The card and the run are stood in for, in a child interpreter."""
    code = """
import types
import torch
from benchlib import harness
import repro_torch.he
assert harness.foreign_modules() == [], harness.foreign_modules()
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1

def run_cell(*args, **kwargs):
    sys.modules["jax.numpy"] = types.ModuleType("jax.numpy")  # loaded by the window
    return {"correct": True, "checks": {}}

harness.run_cell = run_cell
print("rc", harness.main(["--workload", "n13l7.polymul", "--seed", "1", "--seconds", "1"], 0.0))
"""
    out = subprocess.run([sys.executable, "-c", f"import sys\nsys.path[:0] = [{str(BENCH)!r}, "
                          f"{str(ROOT / 'src')!r}]\n" + code], capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == ["rc 3"], out.stdout
    assert "the run holds jax in sys.modules" in out.stderr
