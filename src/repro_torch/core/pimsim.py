"""Cycle-level timing model of one NTT-PIM bank (paper §VI: in-house
simulator = MC front-end + DRAMsim3-style bank timing).

The scheduler is **in-order issue, dependency-driven start** — the MC
issues commands in program order on the shared command bus, and each
command begins as soon as (a) the bus is free, (b) its hardware resources
(bank column path, CU, buffers) are free, and (c) its data dependencies
are met.  Pipelining (§V, Fig 6) *emerges* from buffer availability: with
Nb=2 the next butterfly's reads must wait for the previous writes (the
buffers are busy), while with Nb>=4 rotated buffer pairs let reads overlap
compute — exactly the paper's observation that "to overlap n executions
requires n times as many buffers".  `pipelined=False` forces strictly
serial execution (Fig 6a) for the ablation.

Clock-domain split (Fig 8 protocol): DRAM command/timing parameters are
fixed in ns (Table I cycles at 1200 MHz); CU compute latency scales with
the CU clock.

`BankEngine` is the BANK layer of the hierarchical resource engine
(`repro_torch.pimsys.engine`): pure per-bank hazards — column path, CU,
buffers, refresh.  Everything above the bank is external state owned by
the issue path: the shared bus (callers pass the grant time and keep
`bus_free = s + t_bus`), rank-level tFAW/turnaround windows
(`engine.RankState`), and the per-CU-op (w0, r_w) parameter-beat charge
(`param_ns`, resolved by the caller from `PimConfig.param_cache_entries`
via `engine.param_beat_trace`; `None` charges the flat seed-model
`param_load_cycles`).  That layering is what makes a one-bank channel
bit-identical to `BankTimer` by construction.

The per-command-class dispatch tables (`_ISSUE`/`_START`) replace the
seed's isinstance chains; see `benchmarks/engine_speed.py` for the
commands/s microbenchmark that guards the hot loop.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Iterable, Sequence

from repro_torch.core.mapping import (
    Act,
    BUWord,
    C1,
    C2,
    CMul,
    ColRead,
    ColWrite,
    Command,
    Mark,
    WordLoad,
    WordStore,
)
from repro_torch.core.pim_config import EnergyModel, PimConfig

#: CU ops that stream a (w0, r_w) parameter program over the shared bus
#: per issue (§IV-A) — the traffic `PimConfig.param_cache_entries` cuts.
#: (`BUWord` rides the Nb=1 word path and never charged parameter beats.)
PARAM_OPS = frozenset({C1, C2, CMul})


@dataclasses.dataclass
class TimingResult:
    ns: float
    stats: dict
    phase_ns: dict

    @property
    def us(self) -> float:
        return self.ns / 1e3

    def cycles(self, cfg: PimConfig) -> float:
        return self.ns / cfg.dram_ns

    def energy_nj(self, model: EnergyModel | None = None) -> float:
        return (model or EnergyModel()).energy_nj(self.stats)


class BankEngine:
    """Per-bank resource/hazard tracker: the innermost layer of the
    hierarchical issue path (`repro_torch.pimsys.engine`), also driven
    directly by `BankTimer` for the paper's single-bank experiments.

    The bus is *external* state: callers pass the bus-grant time into
    :meth:`issue` and own `bus_free = s + t_bus` bookkeeping; likewise
    the parameter-beat charge `param_ns` is resolved by the caller
    (flat `param_load_cycles` when `None` — the seed model).  Start
    semantics per command: `s = max(grant, serial_barrier, deps...)`,
    then the refresh stall window for DRAM ops, then `+ param_ns` for
    CU ops (the (w0, r_w) stream crosses the bus before the command
    proper).
    """

    __slots__ = (
        "cfg", "pipelined", "t_bus", "t_ccd", "t_cl", "t_act", "t_ras",
        "t_wr", "t_c1", "t_c2", "t_c2_extra", "t_buw", "t_param",
        "col_t", "cu_t", "row_usable_t", "act_start_ok", "open_row",
        "data_ready", "buf_free", "reg_ready", "row_quiesce", "end_t",
        "serial_barrier", "next_ref", "stats", "_trefi", "_trfc",
        "_c1_bu", "_c2_bu",
    )

    def __init__(self, cfg: PimConfig, pipelined: bool = True):
        self.cfg = cfg
        self.pipelined = pipelined
        d = cfg.dram_ns
        c = cfg.cu_ns
        # latencies in ns
        self.t_bus = 1 * d
        self.t_ccd = cfg.tCCD * d
        self.t_cl = cfg.CL * d
        self.t_act = (cfg.tRP + cfg.tRCD) * d  # PRE + ACT to column-ready
        self.t_ras = cfg.tRAS * d
        self.t_wr = cfg.tWR * d
        self.t_c1 = cfg.c1_latency * c
        self.t_c2 = cfg.c2_latency * c
        self.t_c2_extra = cfg.atom_words * c  # per extra grouped atom pair
        self.t_buw = cfg.bu_word_latency * c
        self.t_param = cfg.param_load_cycles * d  # twiddle params on the bus

        nb = max(1, cfg.num_buffers)
        self.col_t = 0.0  # column channel free
        self.cu_t = 0.0
        self.row_usable_t = 0.0
        self.act_start_ok = 0.0  # tRAS / tWR gating for the next activate
        self.open_row: int | None = None
        self.data_ready = [0.0] * nb  # buffer contents valid
        self.buf_free = [0.0] * nb  # last consumer done (WAR hazard)
        self.reg_ready = [0.0, 0.0]
        self.row_quiesce = 0.0  # last in-flight column transfer on the open row
        self.end_t = 0.0
        self.serial_barrier = 0.0
        self.next_ref = cfg.tREFI_ns
        self.stats: dict = defaultdict(int)
        self._trefi = cfg.tREFI_ns
        self._trfc = cfg.tRFC_ns
        self._c1_bu = cfg.atom_words // 2
        self._c2_bu = cfg.atom_words

    # -- arbitration support -------------------------------------------------
    def earliest_start(self, cmd: Command, bus_free: float,
                       param_ns: float | None = None) -> float:
        """The start time :meth:`issue` would produce, without mutating —
        used by the ready-first arbiter to rank competing banks."""
        if param_ns is None:
            param_ns = self.t_param if cmd.__class__ in PARAM_OPS else 0.0
        return self._START[cmd.__class__](self, cmd, bus_free, param_ns)

    # -- refresh -------------------------------------------------------------
    def _refresh(self, s: float) -> float:
        """Periodic refresh stall (bank busy tRFC every tREFI), committed."""
        nr = self.next_ref
        trfc, trefi = self._trfc, self._trefi
        stats = self.stats
        while s >= nr:
            stats["refresh"] += 1
            r = nr + trfc
            if r > s:
                s = r
            nr += trefi
        self.next_ref = nr
        return s

    def _refresh_peek(self, s: float) -> float:
        nr = self.next_ref
        trfc, trefi = self._trfc, self._trefi
        while s >= nr:
            r = nr + trfc
            if r > s:
                s = r
            nr += trefi
        return s

    # -- issue ---------------------------------------------------------------
    def issue(self, cmd: Command, bus_free: float,
              param_ns: float | None = None) -> tuple[float, float]:
        """Issue one command once the bus grants at `bus_free`.

        Returns `(s, done)`; the caller must advance the shared bus to
        `s + t_bus` (the command occupies the bus until then — for CU
        ops `s` already includes the `param_ns` parameter stream).
        """
        if param_ns is None:
            param_ns = self.t_param if cmd.__class__ in PARAM_OPS else 0.0
        s, done = self._ISSUE[cmd.__class__](self, cmd, bus_free, param_ns)
        if done > self.end_t:
            self.end_t = done
        if not self.pipelined:
            self.serial_barrier = done
        return s, done

    # -- per-command-class handlers (issue: start + commit fused) ------------
    def _i_act(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        a = self.act_start_ok
        if a > s:
            s = a
        q = self.row_quiesce
        if q > s:
            s = q
        if s >= self.next_ref:
            s = self._refresh(s)
        done = s + self.t_act
        self.open_row = cmd.row
        self.row_usable_t = done
        self.act_start_ok = s + self.t_ras
        self.stats["act"] += 1
        return s, done

    def _i_col_read(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.col_t
        if c > s:
            s = c
        r = self.row_usable_t
        if r > s:
            s = r
        f = self.buf_free[cmd.buf]
        if f > s:
            s = f
        if s >= self.next_ref:
            s = self._refresh(s)
        assert self.open_row == cmd.row
        self.col_t = s + self.t_ccd
        done = s + self.t_cl + self.t_ccd
        self.data_ready[cmd.buf] = done
        if done > self.row_quiesce:
            self.row_quiesce = done
        self.stats["col_read"] += 1
        return s, done

    def _i_col_write(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.col_t
        if c > s:
            s = c
        r = self.row_usable_t
        if r > s:
            s = r
        d = self.data_ready[cmd.buf]
        if d > s:
            s = d
        if s >= self.next_ref:
            s = self._refresh(s)
        assert self.open_row == cmd.row
        self.col_t = s + self.t_ccd
        done = s + self.t_ccd
        self.buf_free[cmd.buf] = done
        wr = done + self.t_wr
        if wr > self.act_start_ok:
            self.act_start_ok = wr
        if done > self.row_quiesce:
            self.row_quiesce = done
        self.stats["col_write"] += 1
        return s, done

    def _i_c1(self, cmd, s, pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.cu_t
        if c > s:
            s = c
        d = self.data_ready[cmd.buf]
        if d > s:
            s = d
        s += pn  # (w0, r_w) stream over the shared bus first
        done = s + self.t_c1
        self.cu_t = done
        self.data_ready[cmd.buf] = done
        self.buf_free[cmd.buf] = done
        stats = self.stats
        stats["c1"] += 1
        stats["bu_ops"] += self._c1_bu * (cmd.stages_hi - cmd.stages_lo)
        return s, done

    def _i_c2(self, cmd, s, pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.cu_t
        if c > s:
            s = c
        data_ready = self.data_ready
        bufs_u = cmd.bufs_u
        for bb in bufs_u:
            d = data_ready[bb]
            if d > s:
                s = d
        for bb in cmd.bufs_v:
            d = data_ready[bb]
            if d > s:
                s = d
        s += pn
        done = s + self.t_c2 + self.t_c2_extra * (len(bufs_u) - 1)
        self.cu_t = done
        buf_free = self.buf_free
        for bb in bufs_u:
            data_ready[bb] = done
            buf_free[bb] = done
        for bb in cmd.bufs_v:
            data_ready[bb] = done
            buf_free[bb] = done
        stats = self.stats
        stats["c2"] += 1
        stats["bu_ops"] += self._c2_bu * len(bufs_u)
        return s, done

    def _i_cmul(self, cmd, s, pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.cu_t
        if c > s:
            s = c
        d = self.data_ready[cmd.buf_u]
        if d > s:
            s = d
        d = self.data_ready[cmd.buf_v]
        if d > s:
            s = d
        s += pn
        done = s + self.t_c2
        self.cu_t = done
        self.data_ready[cmd.buf_u] = done
        self.buf_free[cmd.buf_u] = done
        self.buf_free[cmd.buf_v] = done
        self.stats["cmul"] += 1
        return s, done

    def _i_word_load(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.col_t
        if c > s:
            s = c
        r = self.row_usable_t
        if r > s:
            s = r
        g = self.reg_ready[cmd.reg]
        if g > s:
            s = g
        if s >= self.next_ref:
            s = self._refresh(s)
        assert self.open_row == cmd.row
        self.col_t = s + self.t_ccd
        done = s + self.t_cl
        self.reg_ready[cmd.reg] = done
        if done > self.row_quiesce:
            self.row_quiesce = done
        self.stats["word_load"] += 1
        return s, done

    def _i_word_store(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.col_t
        if c > s:
            s = c
        r = self.row_usable_t
        if r > s:
            s = r
        g = self.reg_ready[cmd.reg]
        if g > s:
            s = g
        if s >= self.next_ref:
            s = self._refresh(s)
        assert self.open_row == cmd.row
        self.col_t = s + self.t_ccd
        done = s + self.t_ccd
        wr = done + self.t_wr
        if wr > self.act_start_ok:
            self.act_start_ok = wr
        if done > self.row_quiesce:
            self.row_quiesce = done
        self.stats["word_store"] += 1
        return s, done

    def _i_bu_word(self, cmd, s, _pn):
        b = self.serial_barrier
        if b > s:
            s = b
        c = self.cu_t
        if c > s:
            s = c
        r = self.reg_ready
        if r[0] > s:
            s = r[0]
        if r[1] > s:
            s = r[1]
        done = s + self.t_buw
        self.cu_t = done
        r[0] = r[1] = done
        stats = self.stats
        stats["bu_word"] += 1
        stats["bu_ops"] += 1
        return s, done

    # -- per-command-class start-only handlers (no mutation) -----------------
    def _s_act(self, cmd, s, _pn):
        return self._refresh_peek(max(s, self.serial_barrier,
                                      self.act_start_ok, self.row_quiesce))

    def _s_col_read(self, cmd, s, _pn):
        return self._refresh_peek(max(s, self.serial_barrier, self.col_t,
                                      self.row_usable_t,
                                      self.buf_free[cmd.buf]))

    def _s_col_write(self, cmd, s, _pn):
        return self._refresh_peek(max(s, self.serial_barrier, self.col_t,
                                      self.row_usable_t,
                                      self.data_ready[cmd.buf]))

    def _s_c1(self, cmd, s, pn):
        return max(s, self.serial_barrier, self.cu_t,
                   self.data_ready[cmd.buf]) + pn

    def _s_c2(self, cmd, s, pn):
        data_ready = self.data_ready
        return max(s, self.serial_barrier, self.cu_t,
                   *(data_ready[b] for b in cmd.bufs_u),
                   *(data_ready[b] for b in cmd.bufs_v)) + pn

    def _s_cmul(self, cmd, s, pn):
        return max(s, self.serial_barrier, self.cu_t,
                   self.data_ready[cmd.buf_u],
                   self.data_ready[cmd.buf_v]) + pn

    def _s_word(self, cmd, s, _pn):
        return self._refresh_peek(max(s, self.serial_barrier, self.col_t,
                                      self.row_usable_t,
                                      self.reg_ready[cmd.reg]))

    def _s_bu_word(self, cmd, s, _pn):
        return max(s, self.serial_barrier, self.cu_t,
                   self.reg_ready[0], self.reg_ready[1])

    _ISSUE = {
        Act: _i_act,
        ColRead: _i_col_read,
        ColWrite: _i_col_write,
        C1: _i_c1,
        C2: _i_c2,
        CMul: _i_cmul,
        WordLoad: _i_word_load,
        WordStore: _i_word_store,
        BUWord: _i_bu_word,
    }
    _START = {
        Act: _s_act,
        ColRead: _s_col_read,
        ColWrite: _s_col_write,
        C1: _s_c1,
        C2: _s_c2,
        CMul: _s_cmul,
        WordLoad: _s_word,
        WordStore: _s_word,
        BUWord: _s_bu_word,
    }


class BankTimer:
    """One bank, private bus, program order — the paper's §VI simulator.

    A thin driver of `BankEngine`: the loop owns the bus cursor
    (`bus_t = s + t_bus`) and resolves each CU op's parameter-beat
    charge from `param_trace` (a `pimsys.engine.param_beat_trace`
    residency trace; `None` = flat `param_load_cycles`, the seed
    model).  `Mark`s delimit the per-phase breakdown.
    """

    def __init__(self, cfg: PimConfig, pipelined: bool = True):
        self.cfg = cfg
        self.pipelined = pipelined

    def simulate(self, commands: Iterable[Command],
                 param_trace: Sequence[tuple[int, int]] | None = None,
                 tracer=None) -> TimingResult:
        """Time one command stream.  `tracer` (a
        `repro_torch.pimsys.telemetry.Tracer`, duck-typed so core stays free
        of pimsys imports) records per-command issue events on the
        (0, 0) track and each Mark-delimited phase as a span; `None`
        (default) records nothing and adds no per-command work beyond
        one `is not None` test."""
        eng = BankEngine(self.cfg, pipelined=self.pipelined)
        issue = eng.issue
        t_bus = eng.t_bus
        t_param = eng.t_param
        dram_ns = self.cfg.dram_ns
        stats = eng.stats
        it = iter(param_trace) if param_trace is not None else None
        bus_t = 0.0
        phase_ns: dict = {}
        phase_name = "intra"
        phase_start = 0.0
        if tracer is not None:
            tracer.meta.setdefault("dram_ns", dram_ns)
            trace_cmds = tracer.commands
        else:
            trace_cmds = None

        for cmd in commands:
            cls = cmd.__class__
            if cls is Mark:
                phase_ns[phase_name] = phase_ns.get(phase_name, 0.0) + (eng.end_t - phase_start)
                if tracer is not None:
                    tracer.phases.append(("bank", phase_name, phase_start, eng.end_t))
                phase_name, phase_start = cmd.name, eng.end_t
                continue
            if cls in PARAM_OPS:
                if it is None:
                    pn = t_param
                    code = 0
                else:
                    try:
                        beats, code = next(it)
                    except StopIteration:
                        raise ValueError(
                            "param_trace shorter than the stream's CU ops"
                        ) from None
                    pn = beats * dram_ns
                    stats["param_hit" if code == 2 else "param_miss"] += 1
            else:
                pn = 0.0
                code = 0
            s, done = issue(cmd, bus_t, pn)
            if trace_cmds is not None:
                # single bank, private bus: gate == grant == bus cursor
                trace_cmds.append((0, 0, cls.__name__, bus_t, bus_t, s, done,
                                   pn, code))
            bus_t = s + t_bus

        if it is not None and next(it, None) is not None:
            raise ValueError("param_trace longer than the stream's CU ops")
        phase_ns[phase_name] = phase_ns.get(phase_name, 0.0) + (eng.end_t - phase_start)
        if tracer is not None and eng.end_t > phase_start:
            tracer.phases.append(("bank", phase_name, phase_start, eng.end_t))
        return TimingResult(ns=eng.end_t, stats=dict(eng.stats), phase_ns=phase_ns)


def _time_ntt(
    n: int,
    cfg: PimConfig | None = None,
    forward: bool = False,
    pipelined: bool = True,
) -> TimingResult:
    """Map + time one size-n NTT on one bank (no functional execution).

    Internal, warning-free baseline used by the analytic bound and the
    sharded plan; external callers go through `simulate_ntt` (a session
    shim) or `PimSession` directly.  Cache-aware: with
    `param_cache_entries > 0` the stream's residency trace is computed
    and charged, matching the session path.
    """
    from repro_torch.core.mapping import RowCentricMapper

    cfg = cfg or PimConfig()
    cmds = RowCentricMapper(cfg, n, forward=forward).commands()
    trace = None
    if cfg.param_cache_entries:
        from repro_torch.pimsys.engine import param_beat_trace

        trace = param_beat_trace(cfg, n, cmds)
    return BankTimer(cfg, pipelined=pipelined).simulate(cmds, trace)


def simulate_ntt(
    n: int,
    cfg: PimConfig | None = None,
    forward: bool = False,
    pipelined: bool = True,
) -> TimingResult:
    """Map + time one size-n NTT on one bank (no functional execution).

    Legacy shim over `repro_torch.pimsys.session.PimSession` — bit-identical
    to the session path by construction (same mapper stream, same
    `BankTimer`).
    """
    from repro_torch.pimsys.session import NttOp, PimSession, warn_legacy

    warn_legacy("simulate_ntt", "run(compile(NttOp(n)))")
    sess = PimSession(cfg, pipelined=pipelined)
    return sess.run(sess.compile(NttOp(n, forward=forward))).timing


@dataclasses.dataclass
class MultiBankResult:
    banks: int
    latency_ns: float
    speedup: float
    efficiency: float
    bus_utilization: float
    analytic_latency_ns: float = 0.0  # lower-bound cross-check (see below)
    policy: str = "rr"
    param_hit_rate: float = 0.0  # device-side twiddle-parameter cache


def analytic_multibank_bound(
    n: int, banks: int, cfg: PimConfig | None = None,
    single: TimingResult | None = None,
    param_trace: Sequence[tuple[int, int]] | None = None,
) -> float:
    """Analytic LOWER bound on k-bank latency under shared-bus contention.

    All banks in a channel share one command/address bus, and NTT-PIM
    additionally streams (w0, r_w) parameters over it per CU op (§IV-A),
    so the bus eventually serializes the banks:

        latency(k) >= max( single_bank_latency,
                           k * bus_cycles_one_bank * t_cycle )

    where bus_cycles_one_bank = #commands + param_beats, and param_beats
    is the stream's residency-trace total when the device-side parameter
    cache is enabled (`param_trace`, from `engine.param_beat_trace` —
    the plan layer passes its precomputed one) or the flat
    `param_load_cycles * cu_ops` when it is not.  Exact in the two
    asymptotes, conservative in between (no hazard stalls charged to
    the bus); the cycle-level controller in `repro_torch.pimsys` charges
    exactly these beats per command and can therefore never beat it.
    """
    cfg = cfg or PimConfig()
    single = single or _time_ntt(n, cfg)
    st = single.stats
    n_cmds = sum(
        st.get(k, 0)
        for k in ("act", "col_read", "col_write", "c1", "c2", "cmul",
                   "word_load", "word_store", "bu_word")
    )
    cu_ops = st.get("c1", 0) + st.get("c2", 0) + st.get("cmul", 0)
    if param_trace is None and cfg.param_cache_entries:
        from repro_torch.core.mapping import RowCentricMapper
        from repro_torch.pimsys.engine import param_beat_trace

        param_trace = param_beat_trace(cfg, n, RowCentricMapper(cfg, n).commands())
    if param_trace is None:
        param_beats = cfg.param_load_cycles * cu_ops
    else:
        param_beats = sum(b for b, _ in param_trace)
    bus_ns_one = (n_cmds + param_beats) * cfg.dram_ns
    return max(single.ns, banks * bus_ns_one)


def simulate_ntt_sharded(
    n: int,
    banks: int,
    cfg: PimConfig | None = None,
    forward: bool = False,
    policy: str = "rr",
    topo=None,
    single: TimingResult | None = None,
):
    """Time ONE size-n NTT sharded over `banks` banks (four-step split).

    Unlike `simulate_multibank` (independent NTTs, one per bank), this
    decomposes a single transform: per-bank N/banks-point local passes
    plus log2(banks) cross-bank exchange stages over the per-channel
    shared buses.  Returns a `ShardedTimingResult`.  Pass `single` (the
    one-bank `simulate_ntt(n, cfg, forward)` result) when sweeping over
    `banks` to avoid re-simulating the baseline each call.

    Legacy shim over `repro_torch.pimsys.session.PimSession`.
    """
    from repro_torch.pimsys.session import PimSession, ShardedNttOp, warn_legacy

    warn_legacy("simulate_ntt_sharded", "run(compile(ShardedNttOp(n, banks)))")
    sess = PimSession(cfg, topo=topo, policy=policy)
    plan = sess.compile(ShardedNttOp(n, banks, forward=forward))
    return sess.run(plan, single=single).timing


def simulate_multibank(
    n: int,
    banks: int,
    cfg: PimConfig | None = None,
    policy: str = "rr",
    single: TimingResult | None = None,
) -> MultiBankResult:
    """Bank-level parallelism under SHARED command-bus contention.

    The paper (§VII) expects near-linear speedup from running independent
    NTTs on independent banks, leaving the system-level check as future
    work.  This runs `banks` identical size-n NTT command streams through
    the cycle-level channel engine (`repro_torch.pimsys.engine`) — one shared
    bus, per-bank `BankEngine` hazard tracking — and cross-checks the
    result against `analytic_multibank_bound` (the controller must never
    report a latency below the bound).  Pass `single` (the one-bank
    `simulate_ntt(n, cfg)` result) when sweeping over `banks` to avoid
    re-simulating the baseline each call.

    Legacy shim over `repro_torch.pimsys.session.PimSession`."""
    from repro_torch.pimsys.session import BatchOp, NttOp, PimSession, warn_legacy

    warn_legacy("simulate_multibank", "run(compile(BatchOp(NttOp(n), banks)))")
    sess = PimSession(cfg, policy=policy)
    plan = sess.compile(BatchOp(NttOp(n), banks))
    return sess.run(plan, single=single).timing
