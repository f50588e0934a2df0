"""Runs one benchmark cell once and prints its result as the last line of
standard output:

    python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with as many CUDA cards as the
cell asks for; without them it exits with 2 and prints no result.  Build,
kernel and bytecode caches stay inside the checkout, under `bench/.cache/`
(the program builds its kernels under `src/repro_torch/kernels/_build/`).
"""
import time

T0 = time.perf_counter()  # set-up is timed from here

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(HERE / ".cache" / sub)
# Bytecode of every module the run imports, torch's included, is cached in
# the checkout too: only the first run there compiles it.
sys.pycache_prefix = str(HERE / ".cache" / "pycache")
sys.dont_write_bytecode = False
os.environ.setdefault("OMP_NUM_THREADS", "1")
sys.path.insert(0, str(HERE))

from benchlib import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T0))
