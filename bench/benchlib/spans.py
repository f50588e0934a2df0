"""The program's own spans in the traced stretch, from the profiler's
Chrome trace.

Under the profiler the program opens `record_function` spans named
`repro_torch.*` (`repro_torch.rns.poly_mul_towers`, and in it
`repro_torch.rns.split`, `repro_torch.rns.towers`, `repro_torch.rns.join`;
the wrappers `repro_torch.kernels.ntt_cuda` and
`repro_torch.kernels.modmul_cuda`).  They land in the trace on the clock of
the device's operations.  Each device operation is put down to the
innermost program span open on the host thread that launched it: its
launch event (category `cuda_runtime` or `cuda_driver`) and the operation
share `args.correlation`.  Each idle stretch of the steady window is put
down to the innermost program span open over it, and where none is open,
to the harness.

The steady window and the device operations are `trace.py`'s: from the
first `bench.wait` (the first `bench.call` where there is none) to the end
of the last operation, which `read` checks against `trace.read`.
"""
from __future__ import annotations

import bisect
import dataclasses
import math

from benchlib import trace

PREFIX = "repro_torch."
#: The product call's own span: a trace without it holds no program spans
#: (a program that opens none), and a span share there reads nothing.
OP_SPAN = "repro_torch.rns.poly_mul_towers"
SPLIT = "repro_torch.rns.split"
JOIN = "repro_torch.rns.join"
LAUNCH_CATEGORIES = frozenset({"cuda_runtime", "cuda_driver"})
OUTSIDE = ""  # no program span open


@dataclasses.dataclass
class SpanReading:
    counts: dict[str, int]  # program span -> times opened in the stretch
    launched: dict[str, dict[str, float]]  # innermost span (OUTSIDE for none) -> op name -> device seconds
    idle_s: dict[str, float]  # innermost span over an idle stretch of the steady window -> seconds
    device_s: float  # every device operation of the stretch, as trace.py sums them
    window_s: float  # the steady window

    @property
    def has_program_spans(self) -> bool:
        return self.counts.get(OP_SPAN, 0) > 0

    def launched_s(self, span: str) -> float:
        """Device seconds of the operations launched with `span` innermost."""
        return sum(self.launched.get(span, {}).values())

    def device_share(self, span: str) -> float | None:
        """`launched_s(span)` as a percentage of all device time; 0.0 where
        the stretch opened product spans but none called `span`, None where
        it opened no product span or ran nothing on the device."""
        if not self.has_program_spans or self.device_s <= 0:
            return None
        return 100.0 * self.launched_s(span) / self.device_s

    def idle_in_program_share(self) -> float | None:
        """Idle seconds of the steady window during which a program span was
        open, as a percentage of the window; None as for `device_share`."""
        if not self.has_program_spans or self.window_s <= 0:
            return None
        inside = sum(s for span, s in self.idle_s.items() if span != OUTSIDE)
        return 100.0 * inside / self.window_s


def _innermost(spans: list[tuple[float, float, str]]) -> list[tuple[float, float, str]]:
    """Nested spans of one thread as disjoint segments (lo, hi, innermost
    span's name), in time order."""
    out: list[tuple[float, float, str]] = []
    stack: list[tuple[float, str]] = []
    cursor = -math.inf

    def close_until(t: float) -> None:
        nonlocal cursor
        while stack and stack[-1][0] <= t:
            hi, name = stack.pop()
            if hi > cursor:
                out.append((cursor, hi, name))
                cursor = hi

    for lo, hi, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        close_until(lo)
        if stack and lo > cursor:
            out.append((cursor, lo, stack[-1][1]))
        stack.append((hi, name))
        cursor = max(cursor, lo)
    close_until(math.inf)
    return out


def _at(segments: list[tuple[float, float, str]], starts: list[float], t: float) -> str:
    """The innermost span open at `t`, OUTSIDE for none."""
    i = bisect.bisect_right(starts, t) - 1
    return segments[i][2] if i >= 0 and t <= segments[i][1] else OUTSIDE


def _steady(events: list[dict], ops: list[dict]) -> tuple[float, list[tuple[float, float]]]:
    """`trace.read`'s steady window (us): its start, the first wait (or
    call), and the device's busy stretches in it, merged; the last ends the
    window (within the final synchronise)."""
    spans = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    first = [e["ts"] for e in spans if e["name"] == f"{trace.SPAN_PREFIX}wait"] or \
        [e["ts"] for e in spans if e["name"] == f"{trace.SPAN_PREFIX}call"]
    start = min(first)
    end = max(e["ts"] + e.get("dur", 0) for e in spans if e["name"] == f"{trace.SPAN_PREFIX}sync")
    clipped = [(max(e["ts"], start), min(e["ts"] + e.get("dur", 0), end)) for e in ops]
    return start, trace._merge([(lo, hi) for lo, hi in clipped if hi > lo])


def _idle_by_span(idle: list[tuple[float, float]], segments: dict) -> dict[str, float]:
    """Seconds of the idle stretches (us) under each innermost span,
    OUTSIDE where none is open."""
    out: dict[str, float] = {}
    for lo, hi in idle:
        covered = 0.0
        for segs, starts in segments.values():
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(segs) and segs[i][0] < hi:
                overlap = min(hi, segs[i][1]) - max(lo, segs[i][0])
                if overlap > 0:
                    out[segs[i][2]] = out.get(segs[i][2], 0.0) + overlap * 1e-6
                    covered += overlap
                i += 1
        if hi - lo > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (hi - lo - covered) * 1e-6
    return out


def read(events: list[dict]) -> SpanReading:
    """The reading of a trace's events (timestamps and durations in us)."""
    reference = trace.read(events)  # raises where the stretch has no steady window
    by_thread: dict[tuple, list[tuple[float, float, str]]] = {}
    counts: dict[str, int] = {}
    launches: dict[int, tuple[tuple, float]] = {}
    ops = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = str(e.get("cat", "")), str(e.get("name", ""))
        if cat == "user_annotation" and name.startswith(PREFIX):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append((e["ts"], e["ts"] + e.get("dur", 0), name))
            counts[name] = counts.get(name, 0) + 1
        elif cat.lower() in LAUNCH_CATEGORIES and "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = ((e.get("pid"), e.get("tid")), e["ts"])
        elif cat.lower() in trace.DEVICE_CATEGORIES:
            ops.append(e)
    segments = {}
    for thread, spans in by_thread.items():
        segs = _innermost(spans)
        segments[thread] = (segs, [s[0] for s in segs])

    launched: dict[str, dict[str, float]] = {}
    for e in ops:
        thread, ts = launches.get(e.get("args", {}).get("correlation"), (None, None))
        span = _at(*segments[thread], ts) if thread in segments else OUTSIDE
        per_op = launched.setdefault(span, {})
        op = trace.op_name(e.get("name", ""))
        per_op[op] = per_op.get(op, 0.0) + e.get("dur", 0) * 1e-6

    start, busy = _steady(events, ops)
    end = busy[-1][1]
    idle = [(lo, hi) for lo, hi in zip([start] + [hi for _, hi in busy], [lo for lo, _ in busy]) if hi > lo]
    reading = SpanReading(counts=counts, launched=launched, idle_s=_idle_by_span(idle, segments),
                          device_s=reference.device_s, window_s=(end - start) * 1e-6)
    if not math.isclose(reading.window_s, reference.window_s, rel_tol=1e-9, abs_tol=1e-12):
        raise ValueError(f"steady window {reading.window_s} s against trace.py's {reference.window_s} s")
    return reading
