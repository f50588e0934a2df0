"""The port imports neither `jax`, the JAX package `repro`, nor `ml_dtypes`.

An AST scan covers every file of `src/repro_torch/` and `chip_smoke.py`;
a subprocess in which the three names are blocked imports the port's modules.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro", "ml_dtypes")


def imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"modmath.py", "ntt.py", "modmul.py", "ops.py", "backend.py", "rns.py", "chip_smoke.py",
            "mapping.py", "pimsim.py", "session.py"} <= names
    files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/he/ops.py" in files
    lm = {f"src/repro_torch/{m}.py" for m in (
        "configs/base", "configs/registry", "configs/qwen3_4b", "configs/whisper_small",
        "models/layers", "models/ssm", "models/transformer", "models/convert",
        "launch/steps", "launch/serve", "pimsys/fastpath/torch_backend", "kernels/fold")}
    assert lm <= files
    train = {f"src/repro_torch/{m}.py" for m in (
        "optim/__init__", "optim/optimizers", "data/pipeline", "ckpt/checkpoint",
        "distributed/compression", "launch/train", "launch/roofline", "tree")}
    assert train <= files
    dist = {f"src/repro_torch/{m}.py" for m in (
        "distributed/sharding", "launch/mesh", "launch/dryrun", "launch/perf", "launch/report_experiments")}
    assert dist <= files
    assert len([f for f in files if f.startswith("src/repro_torch/configs/")]) == 13


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.backend\n"
        "import repro_torch.core.ntt, repro_torch.kernels.ref\n"
        "import repro_torch.he, repro_torch.he.rns\n"
        "import repro_torch.pimsys, repro_torch.he.ops, repro_torch.core.mapping\n"
        "import repro_torch.pimsys.fastpath.torch_backend, repro_torch.kernels.fold\n"
        "import repro_torch.configs.registry, repro_torch.models.convert\n"
        "import repro_torch.models.transformer, repro_torch.launch.serve\n"
        "import repro_torch.optim, repro_torch.data.pipeline, repro_torch.ckpt.checkpoint\n"
        "import repro_torch.distributed.compression, repro_torch.launch.train, repro_torch.launch.roofline\n"
        "import repro_torch.distributed.sharding, repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
        "import repro_torch.launch.perf, repro_torch.launch.report_experiments\n"
        "from repro_torch.launch.steps import loss_and_grads, make_train_step, param_specs\n"
        "from repro_torch.configs.registry import ARCH_NAMES, get_config\n"
        "assert all(get_config(a).name == a for a in ARCH_NAMES)\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "assert sys.modules['ml_dtypes'] is None\n"
        "assert not any(m.startswith(('jax.', 'repro.', 'ml_dtypes.')) for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
