"""Atomic, async checkpointing with auto-resume: the port of the JAX
package's `repro/ckpt/checkpoint.py`, in the same on-disk format.

Layout:
  <dir>/step_<n>.tmp/...   (in-flight write)
  <dir>/step_<n>/
      manifest.json        step, leaf keys/shapes/dtypes, extra metadata
      <leaf-key>.npy       one file per leaf
  <dir>/LATEST             text file with the newest complete step

Leaf keys are `jax.tree_util.keystr` of the leaf's path over the same tree
(`[0]['blocks'][0]['mixer']['wq']`: dicts in sorted key order), and a bf16
leaf is stored as its uint16 bits with `"dtype": "bfloat16"` in the
manifest, as the reference stores it; so either package restores the
other's checkpoints.

Atomicity: write into step_<n>.tmp then os.rename -> a crash mid-write
never corrupts a restorable checkpoint.  Async: `save(..., blocking=False)`
copies the leaves to host memory synchronously (the copies are the
snapshot: training may go on updating the tensors in place) and writes in
a daemon thread; `wait()` joins before the next save to bound in-flight
state.

Sharded state: each `DTensor` leaf in turn is gathered whole (a collective
every rank takes part in); rank 0 alone keeps a host copy, the other ranks
drop the gathered leaf at once.  Rank 0 writes before `save` returns, and
the other ranks wait for it at a barrier, so `blocking=False` has no effect
on a sharded state.  Checkpoints hold whole (logical) arrays,
so `restore(..., mesh=, shardings=)` re-shards them for the current mesh,
whatever mesh saved them (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve
from repro_torch.distributed import sharding as shd
from repro_torch.tree import keystr, leaves, leaves_with_path, unflatten


def _leaf_key(path) -> str:
    return keystr(path).replace("/", "_").replace(" ", "")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of `t` (never a view of it) and its dtype's name; bf16 as
    its bits."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":  # stored as uint16 bits
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = True, extra: dict | None = None):
        """Write `state` as step `step`: in a thread when not `blocking`.
        A sharded state (`DTensor` leaves) is written by rank 0 alone
        before `save` returns on any rank, whatever `blocking` says."""
        if any(isinstance(x, DTensor) for x in leaves(state)):
            self.wait()
            keep = dist.get_rank() == 0
            host_leaves = []
            for p, x in leaves_with_path(state):
                whole = x.full_tensor() if isinstance(x, DTensor) else x
                if keep:
                    host_leaves.append((_leaf_key(p), *_to_numpy(whole)))
                del whole  # one gathered leaf at a time, and on rank 0 alone a host copy
            if keep:
                self._write(step, host_leaves, extra or {})
            dist.barrier()
            return
        host_leaves = [(_leaf_key(p), *_to_numpy(x)) for p, x in leaves_with_path(state)]
        self.wait()
        if blocking:
            self._write(step, host_leaves, extra or {})
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host_leaves, extra or {}), daemon=True
            )
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves, extra):
        tmp = os.path.join(self.dir, f"step_{step}.tmp")
        final = os.path.join(self.dir, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": [], "extra": extra}
        for key, arr, dtype in host_leaves:
            np.save(os.path.join(tmp, key + ".npy"), arr)
            manifest["leaves"].append({"key": key, "shape": list(arr.shape), "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        with open(os.path.join(self.dir, "LATEST"), "w") as f:
            f.write(str(step))
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, example_state, device=None, mesh=None, shardings=None):
        """Restore into the structure of `example_state` (shapes must match;
        its leaves may be on the `meta` device), cast to its dtypes, on
        `device` (the card when None).  With a `DeviceMesh` `mesh`, every
        leaf comes back as a `DTensor` on it, each rank keeping its own
        shard: placed by the spec of the `NamedSharding` at the leaf's place
        in `shardings` (the rule tables, over `mesh` or any mesh of its
        axes), or replicated when `shardings` is None."""
        dev = resolve(device)
        d = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        dtypes = {leaf["key"]: leaf["dtype"] for leaf in manifest["leaves"]}
        arrays = []
        for p, ex in leaves_with_path(example_state):
            key = _leaf_key(p)
            t = _from_numpy(np.load(os.path.join(d, key + ".npy")), dtypes.get(key))
            if tuple(t.shape) != tuple(ex.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, expected {tuple(ex.shape)}")
            arrays.append(t.to(dev, ex.dtype))
        if mesh is not None:
            specs = [shd.P()] * len(arrays) if shardings is None else [
                sharding.spec for _, sharding in leaves_with_path(shardings)]
            arrays = [shd.distribute(t, mesh, shd.placements(mesh, spec)) for t, spec in zip(arrays, specs)]
        return unflatten(example_state, arrays), manifest
