"""The root `conftest.py` keeps a pathless pytest run to this tree's tests.

A copy of another tree unpacked under the gitignored `artifacts/` (a
parent commit for a card comparison) holds `tests/` files of the same
basenames, and pytest cannot import two test modules of one basename
without packages: the run would report collection errors for this tree's
own files.  The test plants such a copy beside the root `conftest.py` in a
temporary tree and collects it in a child interpreter.
"""
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
TEST = "def test_one():\n    assert True\n"


def collect(tree: pathlib.Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
                           "-p", "no:randomly"], cwd=tree, capture_output=True, text=True, timeout=120)


def test_root_conftest_ignores_copies_under_artifacts(tmp_path):
    shutil.copy(ROOT / "conftest.py", tmp_path / "conftest.py")
    for d in (tmp_path / "tests", tmp_path / "artifacts" / "final" / "tests", tmp_path / "chiprun_out" / "tests"):
        d.mkdir(parents=True)
        (d / "test_dup.py").write_text(TEST)
    out = collect(tmp_path)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "tests/test_dup.py::test_one" in out.stdout, out.stdout
    assert "1 test collected" in out.stdout and "error" not in out.stdout.lower(), out.stdout


def test_without_it_the_copy_breaks_collection(tmp_path):
    """The control: the same tree without the root `conftest.py` fails to
    collect, as the pathless run did before it."""
    for d in (tmp_path / "tests", tmp_path / "artifacts" / "final" / "tests"):
        d.mkdir(parents=True)
        (d / "test_dup.py").write_text(TEST)
    out = collect(tmp_path)
    assert out.returncode != 0 and "error" in out.stdout.lower(), out.stdout
