"""Device telemetry: command spans, Perfetto export, windowed metrics.

NTT-PIM's performance story is a *timeline* story — in-place updates and
multi-buffer pipelining win by overlapping row activations, column
bursts, and CU ops — but counters only say *how much*, never *when*.
This module adds the missing axis as an opt-in, zero-overhead-when-off
layer over the whole issue hierarchy:

  * `Tracer` — a passive record sink.  Engines hold `tracer=None` by
    default and guard every append with one `is not None` check, so the
    hot loop (`benchmarks/engine_speed.py` floors it) pays nothing when
    telemetry is off.  Enabled via `PimConfig.telemetry` (session runs)
    or `ServicePolicy.telemetry` (service dispatch).  Three record
    families: per-command issue events (channel/bank track, bus-wait and
    hazard-stall attribution, param-cache hit/miss), per-phase spans
    (local NTT passes, exchange stages), and per-request lifecycle spans
    (queue/coalesce wait -> execute, tagged with qos and request id).
  * `TelemetryHandle` — the result-side view, attached to
    `RunResult.telemetry` / `SchedulerResult.telemetry`.  Exports the
    Chrome trace-event JSON dialect (banks and buses as tracks, requests
    as async spans — loads in Perfetto / `chrome://tracing`) and a
    compact JSONL dialect for large runs, and answers reconciliation
    queries (`command_totals` vs `StatsRegistry`, `request_breakdown`
    for the critical-path report).
  * `WindowedSeries` / `Reservoir` — tumbling-window time series (queue
    depth per class, bus utilization per channel, param-cache hit rate,
    bank occupancy, admission rejects) and a deterministic reservoir
    sample for percentile summaries; `device_series` derives the
    device-side series from a finished tracer, and the scheduler
    attaches them to `StatsRegistry` so `summary()` carries the
    timeline.

`scripts/report_telemetry.py` renders an exported trace as a text
report: per-request critical-path breakdown plus top-stall attribution.
"""
from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import IO, Mapping

# synthetic track pids of the Chrome trace export (real channels are
# small non-negative ints, so these can never collide)
PHASE_PID = 900000
REQUEST_PID = 900001
BUS_TID = 255  # per-channel bus track (bank tids are small)

# command-class name -> StatsRegistry per-bank counter key
STAT_KEY = {
    "Act": "act",
    "ColRead": "col_read",
    "ColWrite": "col_write",
    "C1": "c1",
    "C2": "c2",
    "CMul": "cmul",
    "WordLoad": "word_load",
    "WordStore": "word_store",
    "BUWord": "bu_word",
}

# param-cache codes, mirroring engine._P_NONE/_P_MISS/_P_HIT
_CODE_NAME = {1: "miss", 2: "hit"}


class Tracer:
    """Passive telemetry sink the engines append to when enabled.

    Records are plain tuples appended by the hot loop (no method-call
    overhead where it matters):

      commands       (channel, bank, name, gate, grant, start, done,
                      param_ns, code) — one per issued command.  `gate`
                      is dispatch visibility, `grant` the bus grant, so
                      `grant - gate` is bus wait and `start - grant` the
                      rank/bank hazard stall (incl. parameter beats).
      bursts         (ch_src, ch_dst, start, end) — inter-bank atom
                      bursts over the shared bus(es).
      phases         (track, name, start, end) — local passes, exchange
                      stages, `BankTimer` Mark segments.
      request_spans  (rid, qos, name, start, end) — request lifecycle.
      request_events (rid, qos, name, t) — instants (admission rejects).
    """

    __slots__ = ("commands", "bursts", "phases", "request_spans",
                 "request_events", "meta")

    def __init__(self):
        self.commands: list[tuple] = []
        self.bursts: list[tuple] = []
        self.phases: list[tuple] = []
        self.request_spans: list[tuple] = []
        self.request_events: list[tuple] = []
        self.meta: dict = {}

    # cold-path helpers (the hot loop appends to the lists directly)
    def phase(self, track: str, name: str, start: float, end: float) -> None:
        self.phases.append((track, name, start, end))

    def request_span(self, rid: int, qos: str, name: str,
                     start: float, end: float) -> None:
        self.request_spans.append((rid, qos, name, start, end))

    def request_event(self, rid: int, qos: str, name: str, t: float) -> None:
        self.request_events.append((rid, qos, name, t))

    def __len__(self) -> int:
        return (len(self.commands) + len(self.bursts) + len(self.phases)
                + len(self.request_spans) + len(self.request_events))


# --------------------------------------------------------------------------
# Windowed time-series metrics
# --------------------------------------------------------------------------


class WindowedSeries:
    """Tumbling-window aggregation of timestamped samples.

    Aggregations: ``mean`` (sample mean per window — hit rates,
    attainment), ``sum`` (event counts — rejects), ``max`` (peak queue
    depth), ``occupancy`` (busy-time accumulated via `record_span`,
    divided by the window length — bus/bank utilization in [0, 1+]).
    """

    AGGS = ("mean", "sum", "max", "occupancy")

    __slots__ = ("window_ns", "agg", "_buckets")

    def __init__(self, window_ns: float, agg: str = "mean"):
        if window_ns <= 0:
            raise ValueError("window_ns must be positive")
        if agg not in self.AGGS:
            raise ValueError(f"agg must be one of {self.AGGS}, got {agg!r}")
        self.window_ns = float(window_ns)
        self.agg = agg
        # mean: [sum, count]; sum/occupancy: float; max: float
        self._buckets: dict[int, object] = {}

    def record(self, t_ns: float, value: float = 1.0) -> None:
        w = int(t_ns // self.window_ns)
        b = self._buckets
        if self.agg == "mean":
            acc = b.get(w)
            if acc is None:
                b[w] = [value, 1]
            else:
                acc[0] += value
                acc[1] += 1
        elif self.agg == "max":
            cur = b.get(w)
            if cur is None or value > cur:
                b[w] = value
        else:  # sum / occupancy accumulate
            b[w] = b.get(w, 0.0) + value

    def record_span(self, start_ns: float, end_ns: float) -> None:
        """Accumulate a busy interval, split across window boundaries
        (``occupancy``/``sum`` aggregations)."""
        if end_ns <= start_ns:
            return
        win = self.window_ns
        w = int(start_ns // win)
        t = start_ns
        b = self._buckets
        while t < end_ns:
            edge = (w + 1) * win
            seg = min(end_ns, edge) - t
            b[w] = b.get(w, 0.0) + seg
            t, w = edge, w + 1

    def points(self) -> list[tuple[float, float]]:
        """Sorted [(window_start_ns, value), ...]."""
        out = []
        for w in sorted(self._buckets):
            acc = self._buckets[w]
            if self.agg == "mean":
                v = acc[0] / acc[1]
            elif self.agg == "occupancy":
                v = acc / self.window_ns
            else:
                v = acc
            out.append((w * self.window_ns, float(v)))
        return out

    def points_us(self) -> list[list[float]]:
        """JSON-friendly [[window_start_us, value], ...]."""
        return [[t / 1e3, v] for t, v in self.points()]

    def __len__(self) -> int:
        return len(self._buckets)


class Reservoir:
    """Fixed-size deterministic reservoir sample with percentiles.

    Reservoir sampling with a private xorshift32 stream (no global RNG
    state, no `random` import) so repeated runs summarize identically.
    """

    __slots__ = ("k", "n", "values", "_state")

    def __init__(self, k: int = 256, seed: int = 0x9E3779B9):
        if k < 1:
            raise ValueError("k must be >= 1")
        self.k = k
        self.n = 0
        self.values: list[float] = []
        self._state = (seed & 0xFFFFFFFF) or 1

    def _rand(self) -> int:
        x = self._state
        x ^= (x << 13) & 0xFFFFFFFF
        x ^= x >> 17
        x ^= (x << 5) & 0xFFFFFFFF
        self._state = x
        return x

    def add(self, value: float) -> None:
        self.n += 1
        if len(self.values) < self.k:
            self.values.append(float(value))
        else:
            j = self._rand() % self.n
            if j < self.k:
                self.values[j] = float(value)

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile of the sample (q in [0, 100])."""
        if not self.values:
            return 0.0
        xs = sorted(self.values)
        pos = (q / 100.0) * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1.0 - frac) + xs[hi] * frac

    def __len__(self) -> int:
        return len(self.values)


def device_series(tracer: Tracer, window_ns: float) -> dict[str, WindowedSeries]:
    """Derive the device-side windowed series from a finished tracer.

    Returns ``bus_occupancy/ch<c>`` per channel (command + parameter +
    burst beats on the shared bus), ``param_hit_rate`` (mean of hit=1 /
    miss=0 per window), and ``bank_occupancy`` (command-busy time summed
    over banks, normalized per bank — can exceed 1 transiently because
    the pipelined bank engine overlaps CU and column work).
    """
    dram_ns = float(tracer.meta.get("dram_ns", 0.0))
    bus: dict[int, WindowedSeries] = {}
    hits = WindowedSeries(window_ns, "mean")
    bank_busy = WindowedSeries(window_ns, "occupancy")
    banks = set()

    def bus_of(ch: int) -> WindowedSeries:
        s = bus.get(ch)
        if s is None:
            s = bus[ch] = WindowedSeries(window_ns, "occupancy")
        return s

    for ch, bank, _name, _gate, _grant, s, done, param_ns, code in tracer.commands:
        # the command holds the bus for its parameter beats + one beat
        bus_of(ch).record_span(s - param_ns, s + dram_ns)
        bank_busy.record_span(s, done)
        banks.add((ch, bank))
        if code:
            hits.record(s, 1.0 if code == 2 else 0.0)
    for ch_src, ch_dst, s, end in tracer.bursts:
        bus_of(ch_src).record_span(s, end)
        if ch_dst != ch_src:
            bus_of(ch_dst).record_span(s, end)

    out: dict[str, WindowedSeries] = {
        f"bus_occupancy/ch{ch}": s for ch, s in sorted(bus.items())
    }
    if len(hits):
        out["param_hit_rate"] = hits
    if len(bank_busy) and banks:
        # normalize the per-device busy sum to a per-bank occupancy
        norm = WindowedSeries(window_ns, "occupancy")
        n_banks = len(banks)
        for w, acc in bank_busy._buckets.items():
            norm._buckets[w] = acc / n_banks
        out["bank_occupancy"] = norm
    return out


# --------------------------------------------------------------------------
# Export: Chrome trace-event JSON (Perfetto) + JSONL dialect
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TelemetryHandle:
    """Result-side view of one run's tracer (`RunResult.telemetry` /
    `SchedulerResult.telemetry`)."""

    tracer: Tracer

    # -- reconciliation views ------------------------------------------------
    def command_totals(self) -> dict[tuple[int, int], dict]:
        """Per-(channel, bank): command counts by stats key + busy ns.

        The reconciliation view: with telemetry on, these counts equal
        the `StatsRegistry` per-bank command counters for the same run
        (asserted in `tests/test_telemetry.py`).
        """
        out: dict[tuple[int, int], dict] = defaultdict(
            lambda: {"commands": 0, "busy_ns": 0.0})
        for ch, bank, name, _g, _gr, s, done, _pn, _c in self.tracer.commands:
            d = out[(ch, bank)]
            key = STAT_KEY.get(name, name)
            d[key] = d.get(key, 0) + 1
            d["commands"] += 1
            d["busy_ns"] += done - s
        return dict(out)

    def request_breakdown(self) -> list[dict]:
        """Per-request lifecycle span table, sorted by request id.

        Each row: rid, qos, per-span durations (ns), end-to-end total,
        and `attributed` — the fraction of the total covered by named
        spans (the report script's >= 95% acceptance gate).
        """
        spans: dict[int, dict] = {}
        for rid, qos, name, start, end in self.tracer.request_spans:
            row = spans.setdefault(
                rid, {"rid": rid, "qos": qos, "spans": {},
                      "t0": start, "t1": end})
            row["spans"][name] = row["spans"].get(name, 0.0) + (end - start)
            if start < row["t0"]:
                row["t0"] = start
            if end > row["t1"]:
                row["t1"] = end
        out = []
        for rid in sorted(spans):
            row = spans[rid]
            total = row["t1"] - row["t0"]
            covered = sum(row["spans"].values())
            out.append({
                "rid": rid,
                "qos": row["qos"],
                "spans": row["spans"],
                "total_ns": total,
                "attributed": (covered / total) if total > 0 else 1.0,
            })
        return out

    def series(self, window_ns: float = 50_000.0) -> dict[str, WindowedSeries]:
        """Windowed device series (see `device_series`)."""
        return device_series(self.tracer, window_ns)

    # -- Chrome trace-event / Perfetto JSON ----------------------------------
    def chrome_trace(self) -> dict:
        """The trace as a Chrome trace-event document (Perfetto loads
        it).  Channels are processes, banks and the shared bus are their
        threads; phases and requests live on synthetic processes, with
        requests as async ("b"/"e") spans keyed by request id.
        """
        tr = self.tracer
        ev: list[dict] = []
        chans: set[int] = set()
        banks: set[tuple[int, int]] = set()
        bus_chans: set[int] = set()

        for ch, bank, name, gate, grant, s, done, param_ns, code in tr.commands:
            chans.add(ch)
            banks.add((ch, bank))
            args = {
                "bus_wait_us": (grant - gate) / 1e3,
                "stall_us": (s - grant) / 1e3,
            }
            if code:
                args["param"] = _CODE_NAME.get(code, str(code))
            if param_ns:
                args["param_us"] = param_ns / 1e3
            ev.append({"name": name, "cat": "cmd", "ph": "X",
                       "pid": ch, "tid": bank,
                       "ts": s / 1e3, "dur": (done - s) / 1e3, "args": args})
        for ch_src, ch_dst, s, end in tr.bursts:
            chans.add(ch_src)
            bus_chans.add(ch_src)
            ev.append({"name": "burst", "cat": "bus", "ph": "X",
                       "pid": ch_src, "tid": BUS_TID,
                       "ts": s / 1e3, "dur": (end - s) / 1e3,
                       "args": {"dst_channel": ch_dst}})
            if ch_dst != ch_src:
                chans.add(ch_dst)
                bus_chans.add(ch_dst)
                ev.append({"name": "burst", "cat": "bus", "ph": "X",
                           "pid": ch_dst, "tid": BUS_TID,
                           "ts": s / 1e3, "dur": (end - s) / 1e3,
                           "args": {"src_channel": ch_src}})

        tracks: dict[str, int] = {}
        for track, name, start, end in tr.phases:
            tid = tracks.setdefault(track, len(tracks))
            ev.append({"name": name, "cat": "phase", "ph": "X",
                       "pid": PHASE_PID, "tid": tid,
                       "ts": start / 1e3, "dur": (end - start) / 1e3,
                       "args": {}})
        for rid, qos, name, start, end in tr.request_spans:
            common = {"name": name, "cat": "request", "id": int(rid),
                      "pid": REQUEST_PID, "tid": 0}
            ev.append({**common, "ph": "b", "ts": start / 1e3,
                       "args": {"qos": qos}})
            ev.append({**common, "ph": "e", "ts": end / 1e3, "args": {}})
        for rid, qos, name, t in tr.request_events:
            ev.append({"name": name, "cat": "request", "ph": "i", "s": "g",
                       "pid": REQUEST_PID, "tid": 0, "ts": t / 1e3,
                       "args": {"rid": int(rid), "qos": qos}})

        # track naming metadata (processes, then threads)
        meta: list[dict] = []
        for ch in sorted(chans):
            meta.append({"name": "process_name", "ph": "M", "pid": ch,
                         "args": {"name": f"channel {ch}"}})
        for ch, bank in sorted(banks):
            meta.append({"name": "thread_name", "ph": "M", "pid": ch,
                         "tid": bank, "args": {"name": f"bank {bank}"}})
        for ch in sorted(bus_chans):
            meta.append({"name": "thread_name", "ph": "M", "pid": ch,
                         "tid": BUS_TID, "args": {"name": "bus"}})
        if tracks:
            meta.append({"name": "process_name", "ph": "M", "pid": PHASE_PID,
                         "args": {"name": "phases"}})
            for track, tid in tracks.items():
                meta.append({"name": "thread_name", "ph": "M",
                             "pid": PHASE_PID, "tid": tid,
                             "args": {"name": track}})
        if tr.request_spans or tr.request_events:
            meta.append({"name": "process_name", "ph": "M", "pid": REQUEST_PID,
                         "args": {"name": "requests"}})

        return {
            "traceEvents": meta + ev,
            "displayTimeUnit": "ns",
            "otherData": {"schema": "ntt-pim-telemetry-v1", **tr.meta},
        }

    def dumps(self) -> str:
        return json.dumps(self.chrome_trace(), separators=(",", ":"))

    def dump(self, f: IO[str] | str) -> None:
        """Write the Chrome trace-event JSON (open it in Perfetto)."""
        if isinstance(f, str):
            with open(f, "w") as fh:
                self.dump(fh)
            return
        json.dump(self.chrome_trace(), f, separators=(",", ":"))

    def dump_jsonl(self, f: IO[str] | str) -> None:
        """Compact JSONL dialect: one record per line, keyed by kind
        (``cmd`` / ``burst`` / ``phase`` / ``span`` / ``event`` /
        ``meta``) — the large-run format (no document-level nesting, so
        it streams)."""
        if isinstance(f, str):
            with open(f, "w") as fh:
                self.dump_jsonl(fh)
            return
        dump = json.dumps
        tr = self.tracer
        f.write(dump({"k": "meta", **tr.meta}, separators=(",", ":")) + "\n")
        for ch, bank, name, gate, grant, s, done, pn, code in tr.commands:
            f.write(dump({"k": "cmd", "ch": ch, "bank": bank, "op": name,
                          "gate": gate, "grant": grant, "s": s, "e": done,
                          "pn": pn, "code": code},
                         separators=(",", ":")) + "\n")
        for ch_src, ch_dst, s, end in tr.bursts:
            f.write(dump({"k": "burst", "src": ch_src, "dst": ch_dst,
                          "s": s, "e": end}, separators=(",", ":")) + "\n")
        for track, name, start, end in tr.phases:
            f.write(dump({"k": "phase", "track": track, "name": name,
                          "s": start, "e": end},
                         separators=(",", ":")) + "\n")
        for rid, qos, name, start, end in tr.request_spans:
            f.write(dump({"k": "span", "rid": rid, "qos": qos, "name": name,
                          "s": start, "e": end},
                         separators=(",", ":")) + "\n")
        for rid, qos, name, t in tr.request_events:
            f.write(dump({"k": "event", "rid": rid, "qos": qos, "name": name,
                          "t": t}, separators=(",", ":")) + "\n")


# --------------------------------------------------------------------------
# Trace validation (the smoke leg's JSON-schema check; no external deps)
# --------------------------------------------------------------------------

_PHASES_REQUIRING_DUR = ("X",)
_VALID_PH = ("X", "M", "b", "e", "i")


def validate_chrome_trace(doc: object) -> list[str]:
    """Structural validation of an exported Chrome trace document.

    Returns a list of human-readable violations (empty = valid).  This
    is the hand-rolled schema check `scripts/validate_trace.py` and the
    tests share — the container has no `jsonschema` package, and the
    dialect is small enough to check directly.
    """
    errs: list[str] = []
    if not isinstance(doc, Mapping):
        return ["top level must be a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents must be a list"]
    if "otherData" in doc and not isinstance(doc["otherData"], Mapping):
        errs.append("otherData must be an object")
    for i, e in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(e, Mapping):
            errs.append(f"{where}: not an object")
            continue
        ph = e.get("ph")
        if ph not in _VALID_PH:
            errs.append(f"{where}: ph must be one of {_VALID_PH}, got {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            errs.append(f"{where}: missing string name")
        if not isinstance(e.get("pid"), int):
            errs.append(f"{where}: missing integer pid")
        if ph == "M":
            if not isinstance(e.get("args"), Mapping):
                errs.append(f"{where}: metadata event needs args object")
            continue
        ts = e.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errs.append(f"{where}: ts must be a non-negative number")
        if ph in _PHASES_REQUIRING_DUR:
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errs.append(f"{where}: dur must be a non-negative number")
        if ph in ("b", "e") and not isinstance(e.get("id"), (int, str)):
            errs.append(f"{where}: async event needs an id")
        if len(errs) >= 20:
            errs.append("... (truncated)")
            break
    return errs
