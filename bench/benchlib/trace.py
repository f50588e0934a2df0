"""The traced stretch's reading, from the profiler's Chrome trace.

The harness wraps each of its own steps in a `record_function` span named
`bench.call` (one call into the program), `bench.wait` (the wait on the
call `inflight` places back) or `bench.sync` (the final synchronise).
Device operations are the trace's kernels, copies and fills; the spans the
profiler mirrors onto the device timeline are not operations.

Operation times by name cover every operation of the stretch's calls.  The
busy and idle times cover its steady part: from the first wait, when
`inflight` calls are queued, to the end of the last operation.  Before it
the device idles while the host enqueues the first call, and after it
while the synchronise returns.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
SPAN_PREFIX = "bench."
TOP = 10


NAME_CHARS = 120


def op_name(raw: str) -> str:
    """A device operation's name without its return type, anonymous
    namespaces and argument list, cut to `NAME_CHARS` characters."""
    name = raw.removeprefix("void ").replace("(anonymous namespace)::", "")
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:NAME_CHARS] or raw[:NAME_CHARS]


@dataclasses.dataclass
class TraceReading:
    window_s: float
    busy_s: float
    ops: dict[str, list]  # name -> [seconds, count], every device operation of the stretch
    gaps: list[tuple[float, str]]  # idle stretches of the steady window, longest first: (seconds, span)

    @property
    def device_s(self) -> float:
        """The summed time of every device operation of the stretch."""
        return sum(seconds for seconds, _ in self.ops.values())

    def kernels(self, *parts: str) -> tuple[float, int]:
        """(seconds, launches) of the operations whose name holds one of `parts`."""
        hits = [v for name, v in self.ops.items() if any(p in name for p in parts)]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][0])[:TOP]
        return {"device_ops": [[name, seconds] for name, (seconds, _) in ops],
                "idle_gaps": [[span, seconds] for seconds, span in self.gaps[:TOP]]}


def _merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def _span_of(lo: float, hi: float, spans: list[tuple[float, float, str]]) -> str:
    """The harness span that overlaps [lo, hi] most, or `host` for none."""
    best, name = 0.0, "host"
    for s_lo, s_hi, s_name in spans:
        overlap = min(hi, s_hi) - max(lo, s_lo)
        if overlap > best:
            best, name = overlap, s_name
    return name


def read(events: list[dict]) -> TraceReading:
    """The reading of a trace's events (timestamps and durations in us)."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0), e["name"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    starts = {kind: [s[0] for s in spans if s[2] == f"{SPAN_PREFIX}{kind}"] for kind in ("call", "wait")}
    syncs = [s for s in spans if s[2] == f"{SPAN_PREFIX}sync"]
    if not starts["call"] or not syncs:
        raise ValueError("the trace holds no bench.call or bench.sync span")
    start, end = min(starts["wait"] or starts["call"]), max(s[1] for s in syncs)
    ops: dict[str, list] = {}
    busy = []
    for e in events:
        if e.get("ph") != "X" or str(e.get("cat", "")).lower() not in DEVICE_CATEGORIES:
            continue
        entry = ops.setdefault(op_name(e.get("name", "")), [0.0, 0])
        entry[0] += e.get("dur", 0) * 1e-6
        entry[1] += 1
        lo, hi = max(e["ts"], start), min(e["ts"] + e.get("dur", 0), end)
        if hi > lo:
            busy.append((lo, hi))
    if not busy:
        raise ValueError("the profiler recorded no device operation in the traced window")
    merged = _merge(busy)
    end = merged[-1][1]
    gaps, cursor = [], start
    for lo, hi in merged + [(end, end)]:
        if lo > cursor:
            gaps.append(((lo - cursor) * 1e-6, _span_of(cursor, lo, spans)))
        cursor = max(cursor, hi)
    gaps.sort(key=lambda g: -g[0])
    return TraceReading(window_s=(end - start) * 1e-6, busy_s=sum(hi - lo for lo, hi in merged) * 1e-6,
                        ops=ops, gaps=gaps)


def read_chrome_trace(path: pathlib.Path) -> TraceReading:
    return read(json.loads(pathlib.Path(path).read_text())["traceEvents"])
