"""Hierarchical resource engine: THE command-issue path of the device.

Historically the repo issued commands through three parallel
re-implementations — `core.pimsim.BankTimer.simulate`, the arbitration
loop in `pimsys.controller.ChannelController`, and the sharded exchange
loop in `pimsys.sharded` — each owning its own bus bookkeeping.  This
module unifies them into ONE engine that composes explicit resource
layers, outermost to innermost:

    DeviceEngine            channels (independent command/address buses)
      ChannelEngine         one shared bus: arbitration (rr / ready),
                            per-CU-op (w0, r_w) parameter-beat charging,
                            device-side parameter-cache accounting
        RankState           tFAW / tRRD activation windows and same-rank
                            read<->write data-bus turnaround
          BankEngine        per-bank hazards only (column path, CU,
                            buffers, refresh) — `core.pimsim.BankEngine`
            CU              compute latencies inside the bank model

`BankTimer`, `ChannelController`/`Device`, and the sharded exchange are
thin drivers of this path, so a one-bank device is bit-identical to the
paper's single-bank simulator *by construction* — there is no second
timing model to drift.

Rank layer (`RankState`)
    DRAM rank-level constraints the seed model idealized away: at most
    four activations per rank inside any `tFAW` window, `tRRD` between
    consecutive same-rank ACTs, and `tRTW`/`tWTR` data-bus turnaround
    when consecutive column accesses in a rank switch direction.  All
    four default to 0 in `PimConfig` (= the seed's idealized model, the
    differential anchor); setting them nonzero enforces the windows.
    Banks partition into ranks by `DeviceTopology.banks_per_rank`; a
    standalone `ChannelEngine` without a topology models one rank.

Device-side twiddle-parameter cache (`PimConfig.param_cache_entries`)
    Every C1/C2/CMul streams its (w0, r_w) parameter program over the
    shared bus (`param_load_cycles` beats, §IV-A) — the traffic that
    sets the multibank bus knee.  The paper's §V answer to repeated
    parameter traffic is small per-application buffers; we model an
    LRU cache of `param_cache_entries` recently-used parameter programs
    at each bank's CU: a miss pays the full `param_load_cycles` beats,
    a hit pays a single re-select beat.  `param_beat_trace` precomputes
    a stream's hit/miss residency offline (the plan layer caches it, so
    `run()` stays zero-regeneration); the engine just replays per-op
    beat counts and tracks `param_hit`/`param_miss` per bank.  Entries
    = 0 (default) disables the cache and charges the seed model's flat
    `param_load_cycles` per CU op.  `CMul` carries pointwise-operand
    parameters with no reusable generator program and always pays the
    full load; the `BUWord` word path never charged parameter beats in
    the seed model and still does not.

The hot loop is deliberately low-level Python: `__slots__` everywhere,
per-command-class dispatch tables instead of isinstance chains, bound
locals in `advance`/`drain` — see `benchmarks/engine_speed.py`.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict, deque
from typing import Sequence

from repro_torch.core.mapping import (
    Act,
    C1,
    C2,
    CMul,
    ColRead,
    ColWrite,
    Command,
    Mark,
    WordLoad,
    WordStore,
    cu_twiddle_indices,
)
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.pimsim import PARAM_OPS, BankEngine
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.topology import DeviceTopology

POLICIES = ("rr", "ready")

_INF = math.inf
_EMPTY: tuple = ()

# queue-entry param codes (slot 4 of a queue tuple)
_P_NONE, _P_MISS, _P_HIT = 0, 1, 2

# rank-gate kinds, resolved once per command class
_RK_NONE, _RK_ACT, _RK_READ, _RK_WRITE = 0, 1, 2, 3
_RANK_KIND = {
    ColRead: _RK_READ,
    WordLoad: _RK_READ,
    ColWrite: _RK_WRITE,
    WordStore: _RK_WRITE,
}


# --------------------------------------------------------------------------
# Parameter-cache residency (computed offline, replayed by the engine)
# --------------------------------------------------------------------------


def param_program_key(cfg: PimConfig, n: int, cmd: Command):
    """Cache key of a CU op's (w0, r_w) parameter program, or None.

    Two ops share a program iff they resolve the same global twiddle
    table indices (`core.mapping.cu_twiddle_indices` — the same single
    identity `session.twiddle_param_stream` makes functional) with the
    same generator schedule (op kind + butterfly direction).  CMul has
    no reusable program and BUWord's word path never charged parameter
    beats, so only C1/C2 key into the cache.
    """
    cls = cmd.__class__
    if cls is C1 or cls is C2:
        return (cls.__name__, cmd.gs, cu_twiddle_indices(cfg, n, cmd))
    return None


def param_hit_beats(cfg: PimConfig) -> int:
    """Bus beats a parameter-cache HIT pays: one re-select beat, clamped
    so a hit never costs more than a miss on degenerate configs with
    `param_load_cycles < 1`.  The single definition of the hit cost —
    the offline trace builder and the sharded exchange both use it."""
    full = cfg.param_load_cycles
    return full if full < 1 else 1


def param_beat_trace(
    cfg: PimConfig, n: int, commands: Sequence[Command],
) -> tuple[tuple[int, int], ...] | None:
    """Per-CU-op (bus_beats, code) residency trace for one command stream.

    One entry per C1/C2/CMul in issue order, under an LRU cache of
    `cfg.param_cache_entries` parameter programs: a hit pays one
    re-select beat, a miss the full `param_load_cycles`.  Returns None
    when the cache is disabled (`param_cache_entries == 0`), which the
    engine reads as "charge the flat seed-model cost" — the two spellings
    are bit-identical (`tests/test_engine_props.py` proves it).
    """
    entries = cfg.param_cache_entries
    if entries <= 0:
        return None
    full = cfg.param_load_cycles
    hit_beats = param_hit_beats(cfg)
    lru: OrderedDict = OrderedDict()
    out: list[tuple[int, int]] = []
    for cmd in commands:
        if cmd.__class__ not in PARAM_OPS:
            continue
        key = param_program_key(cfg, n, cmd)
        if key is None:  # CMul: no reusable generator program
            out.append((full, _P_MISS))
        elif key in lru:
            lru.move_to_end(key)
            out.append((hit_beats, _P_HIT))
        else:
            lru[key] = True
            if len(lru) > entries:
                lru.popitem(last=False)
            out.append((full, _P_MISS))
    return tuple(out)


def trace_param_beats(cfg: PimConfig,
                      trace: Sequence[tuple[int, int]] | None,
                      cu_ops: int) -> int:
    """Total (w0, r_w) bus beats a stream pays for `cu_ops` CU ops —
    `sum` of the residency trace, or the flat seed cost without one."""
    if trace is None:
        return cfg.param_load_cycles * cu_ops
    return sum(b for b, _ in trace)


# --------------------------------------------------------------------------
# Rank layer
# --------------------------------------------------------------------------


class RankState:
    """tFAW/tRRD activation windows + read<->write turnaround for one rank.

    Activation windows are charge-pump limits and apply rank-wide: the
    state tracks the last four ACT start times (the tFAW window is
    defined over activation *issue* times) and gates the next ACT to
    `max(last + tRRD, fourth_last + tFAW)`.  Turnaround models the
    rank-shared column strobes re-terminating on a direction switch —
    but NTT-PIM column accesses terminate at the issuing bank's own
    atom buffers, so only transitions between *different banks* of the
    rank pay `tRTW`/`tWTR`; a lone bank keeps the paper-calibrated
    single-bank timing even with rank timing enabled (asserted in
    `tests/test_engine.py`).  Every gate collapses to 0.0 when its
    `PimConfig` field is 0, so a default-config rank is exactly the
    seed's unconstrained model.

    `act_log` (enabled via `record_acts`) keeps every ACT start so tests
    can assert the tFAW invariant on a recorded trace: any `tFAW`-wide
    slice contains at most four activations.
    """

    __slots__ = ("t_faw", "t_rrd", "t_rtw", "t_wtr", "acts",
                 "col_end", "col_write", "col_bank", "act_log")

    def __init__(self, cfg: PimConfig, record_acts: bool = False):
        d = cfg.dram_ns
        self.t_faw = cfg.tFAW * d
        self.t_rrd = cfg.tRRD * d
        self.t_rtw = cfg.tRTW * d
        self.t_wtr = cfg.tWTR * d
        self.acts: deque = deque(maxlen=4)  # last 4 ACT start times
        self.col_end = 0.0
        self.col_write = False
        self.col_bank = -1
        self.act_log: list[float] | None = [] if record_acts else None

    def gate(self, kind: int, bank: int) -> float:
        """Earliest start the rank allows `bank` a command of `kind`."""
        if kind == _RK_ACT:
            acts = self.acts
            if not acts:
                return 0.0
            g = 0.0
            if self.t_rrd:
                g = acts[-1] + self.t_rrd
            if self.t_faw and len(acts) == 4:
                faw = acts[0] + self.t_faw
                if faw > g:
                    g = faw
            return g
        if self.col_bank == bank or self.col_bank < 0:
            return 0.0  # same-bank switches stay inside the atom buffers
        if kind == _RK_READ:
            return self.col_end + self.t_wtr if (self.col_write and self.t_wtr) else 0.0
        if kind == _RK_WRITE:
            return self.col_end + self.t_rtw if (not self.col_write and self.t_rtw) else 0.0
        return 0.0

    def commit(self, kind: int, bank: int, s: float, done: float) -> None:
        if kind == _RK_ACT:
            self.acts.append(s)
            if self.act_log is not None:
                self.act_log.append(s)
        else:
            if done > self.col_end:
                self.col_end = done
            self.col_write = kind == _RK_WRITE
            self.col_bank = bank


# --------------------------------------------------------------------------
# Channel layer
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Completion:
    """A job's last command finished on `channel`/`bank` at `done` ns."""

    job_id: object
    channel: int
    bank: int
    done: float


class _Job:
    __slots__ = ("remaining", "max_done")

    def __init__(self):
        self.remaining = 0
        self.max_done = 0.0


class ChannelEngine:
    """One command/address bus shared by bank ports, cycle-level.

    Each `advance` grants the bus to one bank and issues that bank's
    head command through rank gating (`RankState`) into the bank's own
    `BankEngine` — the exact hazard model of the paper's single-bank
    simulator.  With one bank the grant sequence degenerates to program
    order and the timing is bit-identical to `BankTimer`.

    Arbitration policies:
      rr      round-robin over banks whose head command is ready at the
              earliest grant time (fair, FCFS-like)
      ready   ready-first (FR-FCFS flavor): grant the bank whose head
              command would *start* soonest given its internal hazards,
              so a bank stalled on tRAS/CU latency does not block a
              ready neighbor

    Causality note: commands become visible to the arbiter at their
    `gate` time (job dispatch time), so open-loop traffic injected by
    the scheduler contends only with commands that coexist with it.

    Queue entries are `(cmd, gate, job_id, param_ns, code)`: the
    (w0, r_w) parameter-beat charge and its hit/miss code are resolved
    at `enqueue` time from a `param_beat_trace`, so the hot loop never
    re-derives cache state.
    """

    __slots__ = ("cfg", "channel_id", "policy", "bus_free", "bus_busy_ns",
                 "engines", "queues", "ranks", "_rank_of", "_jobs", "_rr",
                 "issued", "_banks_per_rank", "_rank_on", "_record_acts",
                 "_t_bus", "_t_param", "_dram_ns", "tracer")

    def __init__(self, cfg: PimConfig, channel_id: int = 0, policy: str = "rr",
                 banks_per_rank: int | None = None, record_acts: bool = False,
                 tracer=None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
        self.cfg = cfg
        self.channel_id = channel_id
        self.policy = policy
        # telemetry sink (telemetry.Tracer) or None; the issue paths pay
        # exactly one `is not None` test per command when disabled
        self.tracer = tracer
        self.bus_free = 0.0
        self.bus_busy_ns = 0.0
        self.engines: list[BankEngine] = []
        self.queues: list[deque] = []
        self.ranks: list[RankState] = []
        self._rank_of: list[int] = []
        self._jobs: dict[object, _Job] = {}
        self._rr = 0  # last granted bank (round-robin pointer)
        self.issued = 0
        self._banks_per_rank = banks_per_rank
        # record_acts routes commands through the (inert, all-zero-gate)
        # rank path so the ACT log fills even without rank timing
        self._rank_on = bool(cfg.tFAW or cfg.tRRD or cfg.tRTW or cfg.tWTR
                             or record_acts)
        self._record_acts = record_acts
        d = cfg.dram_ns
        self._t_bus = 1.0 * d
        self._t_param = cfg.param_load_cycles * d
        self._dram_ns = d

    # -- construction --------------------------------------------------------
    def add_bank(self, pipelined: bool = True, rank: int | None = None) -> int:
        """Attach one bank port; `rank` defaults to the topology-derived
        partition (`banks_per_rank` banks per rank, one rank for a
        standalone channel)."""
        idx = len(self.engines)
        if rank is None:
            rank = idx // self._banks_per_rank if self._banks_per_rank else 0
        while rank >= len(self.ranks):
            self.ranks.append(RankState(self.cfg, record_acts=self._record_acts))
        self.engines.append(BankEngine(self.cfg, pipelined=pipelined))
        self.queues.append(deque())
        self._rank_of.append(rank)
        return idx

    def enqueue(self, bank: int, commands, gate: float = 0.0, job_id=None,
                param_trace: Sequence[tuple[int, int]] | None = None) -> None:
        """Queue a command stream on `bank`, visible to the arbiter at
        `gate` (dispatch time).  `Mark`s are phase annotations with no
        hardware effect and are dropped here, exactly as `BankTimer`
        ignores them.  `param_trace` (from `param_beat_trace`) supplies
        each CU op's parameter-beat charge; without one, every CU op
        pays the flat `param_load_cycles` (the cache-disabled model)."""
        q = self.queues[bank]
        job = None
        if job_id is not None:
            job = self._jobs.get(job_id)
            if job is None:
                job = self._jobs[job_id] = _Job()
        t_param, d = self._t_param, self._dram_ns
        it = iter(param_trace) if param_trace is not None else None
        n = 0
        for cmd in commands:
            cls = cmd.__class__
            if cls is Mark:
                continue
            if cls in PARAM_OPS:
                if it is None:
                    entry = (cmd, gate, job_id, t_param, _P_NONE)
                else:
                    try:
                        beats, code = next(it)
                    except StopIteration:
                        raise ValueError(
                            "param_trace shorter than the stream's CU ops"
                        ) from None
                    entry = (cmd, gate, job_id, beats * d, code)
            else:
                entry = (cmd, gate, job_id, 0.0, _P_NONE)
            q.append(entry)
            n += 1
        if it is not None and next(it, _EMPTY) is not _EMPTY:
            raise ValueError("param_trace longer than the stream's CU ops")
        if job is not None:
            job.remaining += n

    # -- non-queued bus transactions -----------------------------------------
    def occupy_bus(self, not_before: float, hold_ns: float) -> float:
        """Grant the shared bus for a non-command transaction (an
        inter-bank atom burst — see `repro_torch.pimsys.sharded`).  Returns
        the grant time; the bus is busy for `hold_ns` from there."""
        s = max(not_before, self.bus_free)
        self.bus_free = s + hold_ns
        self.bus_busy_ns += hold_ns
        return s

    def earliest_issue(self, bank: int, cmd: Command,
                       not_before: float = 0.0,
                       param_ns: float | None = None) -> float:
        """Non-mutating: the start time `issue_direct` would produce for
        `cmd` right now (bus grant, rank gates, and the bank's internal
        hazards included).  The sharded exchange's pipelined driver
        ranks competing pair chains by this estimate so a command
        stalled on a data hazard never parks the channel bus ahead of
        work that could start sooner."""
        eng = self.engines[bank]
        if param_ns is None:
            param_ns = self._t_param if cmd.__class__ in PARAM_OPS else 0.0
        lb = not_before if not_before > self.bus_free else self.bus_free
        if self._rank_on:
            cls = cmd.__class__
            kind = _RK_ACT if cls is Act else _RANK_KIND.get(cls, _RK_NONE)
            if kind != _RK_NONE:
                g = self.ranks[self._rank_of[bank]].gate(kind, bank)
                if g > lb:
                    lb = g
        return eng.earliest_start(cmd, lb, param_ns)

    def issue_direct(self, bank: int, cmd: Command, not_before: float = 0.0,
                     param_ns: float | None = None,
                     code: int = _P_NONE) -> tuple[float, float]:
        """Issue one command on `bank` outside the queued arbitration
        path (the sharded exchange drives engines directly), with
        exactly the bus-grant, rank-gate, and parameter-beat bookkeeping
        `advance` applies.  Returns (start, done)."""
        eng = self.engines[bank]
        if param_ns is None:
            param_ns = self._t_param if cmd.__class__ in PARAM_OPS else 0.0
        lb = grant = not_before if not_before > self.bus_free else self.bus_free
        rank = None
        kind = _RK_NONE
        if self._rank_on:
            rank = self.ranks[self._rank_of[bank]]
            cls = cmd.__class__
            kind = _RK_ACT if cls is Act else _RANK_KIND.get(cls, _RK_NONE)
            if kind != _RK_NONE:
                g = rank.gate(kind, bank)
                if g > lb:
                    lb = g
        s, done = eng.issue(cmd, lb, param_ns)
        if rank is not None and kind != _RK_NONE:
            rank.commit(kind, bank, s, done)
        if code:
            eng.stats["param_hit" if code == _P_HIT else "param_miss"] += 1
        self.bus_free = s + self._t_bus
        self.bus_busy_ns += param_ns + self._t_bus
        self.issued += 1
        tr = self.tracer
        if tr is not None:
            tr.commands.append((self.channel_id, bank, cmd.__class__.__name__,
                                not_before, grant, s, done, param_ns, code))
        return s, done

    # -- arbitration ---------------------------------------------------------
    def next_grant(self) -> float:
        """Earliest time any queued command could be granted the bus."""
        g = _INF
        bus = self.bus_free
        for q in self.queues:
            if q:
                t = q[0][1]
                if t < g:
                    g = t
        if g is _INF:
            return _INF
        return g if g > bus else bus

    def _rank_gate(self, bank: int, cmd: Command) -> float:
        rank = self.ranks[self._rank_of[bank]]
        cls = cmd.__class__
        if cls is Act:
            return rank.gate(_RK_ACT, bank)
        return rank.gate(_RANK_KIND.get(cls, _RK_NONE), bank)

    def _pick(self) -> int | None:
        queues = self.queues
        n = len(queues)
        rr = self._rr
        if self.policy == "rr":
            # Fair rotation over banks grantable at the earliest grant
            # time.  Fast path: the first non-empty bank (cyclically
            # after the last grant) whose head gate <= bus_free is
            # grantable at bus_free, the minimum possible grant — O(1)
            # amortized.
            bus = self.bus_free
            best, best_gate = None, _INF
            for off in range(1, n + 1):
                q = queues[(rr + off) % n]
                if not q:
                    continue
                gate = q[0][1]
                if gate <= bus:
                    return (rr + off) % n
                if gate < best_gate:
                    best, best_gate = (rr + off) % n, gate
            return best  # None iff every queue is empty
        # ready-first: grant whichever grantable head would START soonest
        rank_on = self._rank_on
        best, best_s = None, _INF
        for off in range(1, n + 1):
            b = (rr + off) % n
            q = queues[b]
            if not q:
                continue
            head = q[0]
            g = head[1]
            if g < self.bus_free:
                g = self.bus_free
            if rank_on:
                rg = self._rank_gate(b, head[0])
                if rg > g:
                    g = rg
            s = self.engines[b].earliest_start(head[0], g, head[3])
            if s < best_s:
                best, best_s = b, s
        return best

    # -- simulation ----------------------------------------------------------
    def advance(self, horizon: float = _INF) -> Sequence[Completion] | None:
        """Grant the bus once and issue one command.

        Returns completions triggered by that issue (an empty sequence
        if none), or `None` if no queued command can be granted before
        `horizon` (the scheduler then injects the next arrival).
        """
        bank = self._pick()
        if bank is None:
            return None
        # Causality: the guard is on the CHOSEN bank's grant, not the
        # global minimum — the ready policy may pick a later-gated bank
        # than the earliest one, and issuing at/after `horizon` would
        # advance the bus past an arrival the scheduler has not injected
        # yet.  Rank gates and bank hazards may still push the START
        # past the horizon (they are dependencies, not bus grants).
        head = self.queues[bank][0]
        grant = head[1]
        if grant < self.bus_free:
            grant = self.bus_free
        if grant >= horizon:
            return None
        cmd, gate, job_id, param_ns, code = self.queues[bank].popleft()
        eng = self.engines[bank]
        lb = grant
        rank = None
        kind = _RK_NONE
        if self._rank_on:
            rank = self.ranks[self._rank_of[bank]]
            cls = cmd.__class__
            kind = _RK_ACT if cls is Act else _RANK_KIND.get(cls, _RK_NONE)
            if kind != _RK_NONE:
                g = rank.gate(kind, bank)
                if g > lb:
                    lb = g
        s, done = eng.issue(cmd, lb, param_ns)
        if kind != _RK_NONE:
            rank.commit(kind, bank, s, done)
        if code:
            eng.stats["param_hit" if code == _P_HIT else "param_miss"] += 1
        self.bus_free = s + self._t_bus
        self.bus_busy_ns += param_ns + self._t_bus
        self._rr = bank
        self.issued += 1
        tr = self.tracer
        if tr is not None:
            tr.commands.append((self.channel_id, bank, cmd.__class__.__name__,
                                gate, grant, s, done, param_ns, code))

        if job_id is None:
            return _EMPTY
        job = self._jobs[job_id]
        if done > job.max_done:
            job.max_done = done
        job.remaining -= 1
        if job.remaining:
            return _EMPTY
        del self._jobs[job_id]
        return (Completion(job_id, self.channel_id, bank, job.max_done),)

    def drain(self) -> list[Completion]:
        """Run until every queue is empty; return all completions."""
        out: list[Completion] = []
        advance = self.advance
        while True:
            evs = advance()
            if evs is None:
                return out
            if evs:
                out.extend(evs)

    # -- results -------------------------------------------------------------
    @property
    def makespan_ns(self) -> float:
        return max((e.end_t for e in self.engines), default=0.0)

    def bank_ns(self, bank: int) -> float:
        return self.engines[bank].end_t

    def act_starts(self, rank: int = 0) -> list[float]:
        """Recorded ACT start times of `rank` (requires `record_acts`)."""
        log = self.ranks[rank].act_log
        if log is None:
            raise RuntimeError("construct the engine with record_acts=True")
        return list(log)

    def record_stats(self, reg: StatsRegistry) -> None:
        for b, eng in enumerate(self.engines):
            reg.add_bank(self.channel_id, b, dict(eng.stats))
        reg.add_bus(self.channel_id, self.bus_busy_ns, self.makespan_ns)


def replay_gang(cfg: PimConfig, commands, banks: int, *,
                param_trace=None, policy: str = "rr",
                pipelined: bool = True, tracer=None) -> ChannelEngine:
    """Interpreted evaluation of one homogeneous gang: `banks` copies of
    one command stream enqueued at t=0 on one shared-bus channel and
    drained to completion.  This is the differential oracle the fastpath
    (`repro_torch.pimsys.fastpath`) verifies against — the returned engine
    carries per-bank `stats`/`end_t`, `bus_busy_ns` and `makespan_ns`
    (plus the full per-command schedule when a `tracer` is passed)."""
    eng = ChannelEngine(cfg, policy=policy, tracer=tracer)
    for i in range(banks):
        bank = eng.add_bank(pipelined=pipelined)
        eng.enqueue(bank, commands, job_id=i, param_trace=param_trace)
    eng.drain()
    return eng


# --------------------------------------------------------------------------
# Device layer
# --------------------------------------------------------------------------


class DeviceEngine:
    """A full PIM device: one `ChannelEngine` per channel.

    Channels have independent buses, so they only interact through the
    scheduler's placement decisions (and the sharded exchange's
    cross-channel bursts); `advance` always steps the channel with the
    earliest grantable command to keep event order causal.
    """

    __slots__ = ("cfg", "topo", "channels", "tracer")

    def __init__(self, cfg: PimConfig, topo: DeviceTopology | None = None,
                 policy: str = "rr", pipelined: bool = True,
                 record_acts: bool = False, tracer=None):
        self.cfg = cfg
        self.topo = topo or DeviceTopology.from_config(cfg)
        self.tracer = tracer
        if tracer is not None:
            tracer.meta.setdefault("dram_ns", cfg.dram_ns)
        self.channels = [
            ChannelEngine(cfg, channel_id=ch, policy=policy,
                          banks_per_rank=self.topo.banks_per_rank,
                          record_acts=record_acts, tracer=tracer)
            for ch in range(self.topo.channels)
        ]
        for ctrl in self.channels:
            for _ in range(self.topo.banks_per_channel):
                ctrl.add_bank(pipelined=pipelined)

    def enqueue_flat(self, flat_bank: int, commands, gate: float = 0.0,
                     job_id=None, param_trace=None):
        addr = self.topo.address_of(flat_bank)
        self.channels[addr.channel].enqueue(
            self.topo.local_id(addr), commands, gate=gate, job_id=job_id,
            param_trace=param_trace)

    def burst(self, ch_src: int, ch_dst: int, earliest: float) -> float:
        """One inter-bank atom burst over the shared bus(es).

        Same channel: one bus holds for `xfer_beats_per_atom` beats.
        Cross-channel: both buses are held for the burst and the arrival
        additionally pays `channel_hop_cycles`.  Returns the arrival
        time at the destination buffer."""
        cfg = self.cfg
        hold = cfg.xfer_beats_per_atom * cfg.dram_ns
        cs = self.channels[ch_src]
        tr = self.tracer
        if ch_src == ch_dst:
            s = cs.occupy_bus(earliest, hold)
            if tr is not None:
                tr.bursts.append((ch_src, ch_dst, s, s + hold))
            return s + hold
        cd = self.channels[ch_dst]
        s = max(earliest, cs.bus_free, cd.bus_free)
        cs.occupy_bus(s, hold)
        cd.occupy_bus(s, hold)
        end = s + hold + cfg.channel_hop_cycles * cfg.dram_ns
        if tr is not None:
            tr.bursts.append((ch_src, ch_dst, s, end))
        return end

    def advance(self, horizon: float = _INF) -> Sequence[Completion] | None:
        best, best_g = None, _INF
        for ctrl in self.channels:
            g = ctrl.next_grant()
            if g < best_g:
                best, best_g = ctrl, g
        if best is None or best_g >= horizon:
            return None
        return best.advance(horizon)

    def drain(self) -> list[Completion]:
        out: list[Completion] = []
        for ctrl in self.channels:
            out.extend(ctrl.drain())
        return out

    @property
    def makespan_ns(self) -> float:
        return max(c.makespan_ns for c in self.channels)

    def stats(self) -> StatsRegistry:
        reg = StatsRegistry(channels=len(self.channels))
        for ctrl in self.channels:
            ctrl.record_stats(reg)
        return reg
