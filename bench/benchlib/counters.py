"""The program's own counters, always on: the NTT lane's kernel launches
(`repro_torch.kernels.launch_counts`), host seconds in its kernel wrappers
(`kernels.host_seconds`) and in the product op, and the bytes the op's
tower split and join copy (`repro_torch.he.rns.counters`); and what a
stretch's change in them reads as per-layer numbers.

Counters only change inside calls into the program, so a snapshot taken
between calls is the stretch's edge.  The program is read from
`sys.modules`: this module imports nothing of it.
"""
from __future__ import annotations

import sys


def snapshot() -> dict[str, float] | None:
    """The counters now, summed over kernels and copies: `launches`,
    `wrapper_s`, `op_s` and `copy_bytes`; None where the program keeps no
    host seconds or copy bytes."""
    kernels = sys.modules.get("repro_torch.kernels")
    host_seconds = getattr(kernels, "host_seconds", None)
    op_counters = getattr(sys.modules.get("repro_torch.he.rns"), "counters", None)
    if host_seconds is None or op_counters is None:
        return None
    op = op_counters()
    return {"launches": sum(kernels.launch_counts().values()), "wrapper_s": sum(host_seconds().values()),
            "op_s": sum(op["host_s"].values()), "copy_bytes": sum(op["copy_bytes"].values())}


def delta(before: dict[str, float], after: dict[str, float]) -> dict[str, float]:
    return {k: after[k] - before[k] for k in after}


def dispatch_us_per_launch(d: dict[str, float]) -> float | None:
    """Host microseconds in the kernel wrappers per kernel launch."""
    return 1e6 * d["wrapper_s"] / d["launches"] if d["launches"] else None


def op_host_ms_per_call(d: dict[str, float], calls: int) -> float | None:
    """Host milliseconds per product call in the op outside its kernel
    wrappers: the broadcast, the split, the tower loop and the join."""
    return 1e3 * (d["op_s"] - d["wrapper_s"]) / calls if calls else None


def copy_bytes_ratio(d: dict[str, float], least_bytes: float) -> float | None:
    """Bytes the split and join copied over the least bytes of the products
    they served; 0.0 where nothing was copied."""
    return d["copy_bytes"] / least_bytes if least_bytes else None
