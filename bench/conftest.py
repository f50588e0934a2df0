"""pytest settings for the benchmark's own tests: the `gpu` marker, and the
benchmark's folder and the program's `src` on the path."""
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
for path in (BENCH, BENCH.parent / "src"):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card; skips without one (run: -m gpu)")
