"""Seconds from the first line of `run.py` to the first timed call (host
clock): imports, the kernels' build or load, the basis and its device
tables, the operands, the warm-up calls."""


def read(run):
    return run.setup_s
