"""The port imports neither `jax` nor the JAX package `repro`.

An AST scan covers every file of `src/repro_torch/` and `chip_smoke.py`;
a subprocess in which both names are blocked imports the port's modules.
"""
import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "repro")


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
    he_files = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/he/ops.py" in he_files


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = imported_roots(path) & set(FORBIDDEN)
    assert not bad, f"{path} imports {sorted(bad)}"


def test_port_imports_with_jax_and_repro_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.backend\n"
        "import repro_torch.core.ntt, repro_torch.kernels.ref\n"
        "import repro_torch.he, repro_torch.he.rns\n"
        "import repro_torch.pimsys, repro_torch.he.ops, repro_torch.core.mapping\n"
        "assert sys.modules['jax'] is None and sys.modules['repro'] is None\n"
        "assert not any(m.startswith(('jax.', 'repro.')) for m in sys.modules)\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
