"""Runs multi-rank and fake-world code of the port's tests in child
interpreters, never in the pytest process (which opens no process group
and forks nothing).

`run_child(tmp_path, code, world)` writes `code` after `PRELUDE` into a
script under `tmp_path` and runs it with `subprocess`, started with
`start_new_session` so that a timeout kills it with every rank it spawned.
The script sees `SRC`, the port's source directory.  With `world`, the
script's `body(rank, world, tmp)` runs on that many
ranks: `torch.multiprocessing.spawn`, a gloo (or `backend`) process group
met through a `file://` store under `tmp_path` (no TCP port, so parallel
test workers never collide), a 60 s collective timeout, one intra-op
thread per rank, and `destroy_process_group` in a `finally`.  A rank
reports by returning a JSON-able value, which `run_child` returns as a
list indexed by rank.  Without `world` the script runs as written and its
stdout comes back.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import textwrap

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
TESTS = os.path.dirname(os.path.abspath(__file__))

PRELUDE = '''
import json, os, sys
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(1)


def _rank(rank, world, tmp, backend):
    dist.init_process_group(backend, init_method=f"file://{tmp}/store", rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    try:
        out = body(rank, world, tmp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def spawn_ranks(world, tmp, backend):
    if os.path.exists(os.path.join(tmp, "store")):  # an earlier child's: the ranks meet afresh
        os.remove(os.path.join(tmp, "store"))
    mp.spawn(_rank, args=(world, tmp, backend), nprocs=world, join=True)
'''

LAUNCH = '''

if __name__ == "__main__":
    spawn_ranks({world}, {tmp!r}, {backend!r})
'''


def run_child(tmp_path, code: str, world: int | None = None, backend: str = "gloo",
              timeout: float = 240) -> list | str:
    tmp = str(tmp_path)
    script = f"SRC = {os.path.abspath(SRC)!r}\n" + PRELUDE + textwrap.dedent(code)
    if world is not None:
        script += LAUNCH.format(world=world, tmp=tmp, backend=backend)
    path = os.path.join(tmp, "child.py")
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, TESTS]), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, path], cwd=tmp, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise AssertionError(f"child timed out after {timeout} s: {err[-3000:]}") from None
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    assert proc.returncode == 0, f"child exited {proc.returncode}: {err[-3000:]}"
    if world is None:
        return out
    results = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            results.append(json.load(f))
    return results
