"""Shard ONE large NTT across many banks and channels (`ShardedNttPlan`).

The paper pipelines butterfly stages inside one bank; the ROADMAP's next
system-level step is the opposite axis: split a single size-N NTT over
B = banks x channels banks so the inter-bank butterfly stages cross the
channel boundary.  We use the four-step (Cooley-Tukey column/row)
decomposition specialized to the row-centric command stream:

  view the coefficient vector as a (B x M) matrix, M = N/B, row b living
  contiguously in bank b.  The stage set {1, ..., N/2} splits exactly at
  stride M:

  * strides t < M   -- the "row NTTs": a full size-M sub-NTT local to
    each bank.  Emitted as an unmodified `RowCentricMapper` stream with
    `twiddle_base = b*M`, which shifts the (w0, r_w) parameters so the
    local pass resolves the *global* table (the four-step twiddle
    correction is absorbed into the shifted bases; no extra passes).
  * strides t >= M  -- the "column NTTs": log2(B) cross-bank stages.
    Bank b pairs with bank b + t/M and -- because a whole bank spans
    less than half a butterfly block at these strides -- the pair shares
    ONE twiddle: the exchange moves twiddle-scaled columns wholesale.
    Each atom crosses the per-channel shared bus as a paired
    ColRead (source bank) / ColWrite-burst (target bank) transaction
    (`ChannelController.occupy_bus`); pairs that straddle channels hold
    both buses and pay `channel_hop_cycles` extra latency.

Execution order: inverse/GS (the paper orientation) runs the local pass
first, then the exchange stages; forward/CT mirrors (exchange first,
local pass second).  A forward+inverse pipeline (NTT -> INTT round trip)
is therefore the classic four-step sandwich local/exchange/.../local.

At banks=1 the plan degenerates to the single `RowCentricMapper` stream
-- command-list identical, and (through the one-bank controller) timed
bit-identically to `BankTimer`; `tests/test_sharded.py` asserts both.

Timing is a thin driver of the hierarchical resource engine
(`repro_torch.pimsys.engine`) end to end: phase A(/B) local streams run
through `DeviceEngine` (per-channel bus arbitration -> rank windows ->
`BankEngine` hazards), and the exchange phase issues genuine
Act/ColRead/C2/ColWrite commands into the SAME engines via
`issue_direct` -- butterfly compute happens on the u-bank's CU, hazards,
refresh, and rank tFAW/turnaround windows included -- with the
inter-bank burst modeled as shared-bus occupancy (`DeviceEngine.burst`).
The device-side twiddle-parameter cache reaches both phases: local
streams replay their plan-level residency traces
(`local_param_traces`), which then seed the exchange phase's per-bank
LRU walk (`exchange_param_charges`) — one cache per bank, threaded
across the phase boundary, so exchange C2s hit after the first atom of
each pair (one shared twiddle per pair).  Functional execution
(`run_functional`, surfaced as `core.polymul.pim_ntt_sharded`) drives
one `FunctionalBank` per bank and is asserted bit-equal to `core.ntt`.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.core import ntt as ntt_ref
from repro_torch.core.mapping import (
    Act,
    C1,
    C2,
    CMul,
    ColRead,
    ColWrite,
    Command,
    Mark,
    FunctionalBank,
    RowCentricMapper,
    twiddle_index,
)
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.pimsim import BankEngine, TimingResult, _time_ntt
from repro_torch.pimsys.controller import ChannelController, Device
from repro_torch.pimsys.engine import (
    PARAM_OPS,
    param_beat_trace,
    param_hit_beats,
    param_program_key,
    trace_param_beats,
)
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.topology import DeviceTopology

_INF_F = math.inf


# --------------------------------------------------------------------------
# Plan structure
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ExchangePair:
    """One cross-bank butterfly: u-bank pairs with v-bank at `stride`.

    `tw_index` is the (single) global twiddle-table index the whole pair
    shares -- at stride t >= M a bank spans less than half a 2t-block,
    so the MC programs one (w0, r_w) per pair and stage.
    """

    u: int       # sub-NTT index of the u operand (holds words [u*M, u*M+M))
    v: int       # sub-NTT index of the v operand
    stride: int  # butterfly stride in global words (a multiple of M)
    tw_index: int


@dataclasses.dataclass(frozen=True)
class ExchangeStage:
    stride: int
    pairs: tuple[ExchangePair, ...]


@dataclasses.dataclass(frozen=True)
class ExchangeStageSpan:
    """Timing breakdown of one executed exchange stage.

    `occupancy` is bus-busy over (used channels x span); `overlap` is
    the fraction of summed per-pair work hidden by cross-pair
    pipelining (0.0 = pairs ran strictly one after another, ->1.0 =
    fully concurrent).  Both come from the live engine run, so the
    knee is attributable from a committed benchmark artifact alone.
    """

    stride: int
    begin_ns: float
    end_ns: float
    busy_ns: float       # summed channel-bus busy accrued during the stage
    pairs: int
    channels: int        # distinct channels the stage's pairs touch
    occupancy: float
    overlap: float

    @property
    def span_ns(self) -> float:
        return self.end_ns - self.begin_ns


@dataclasses.dataclass
class ShardedTimingResult:
    """Cycle-level timing of one sharded NTT (see `ShardedNttPlan.simulate`)."""

    n: int
    banks: int
    latency_ns: float
    local_ns: float          # local-pass phase span (bus-arbitrated)
    exchange_ns: float       # exchange activity window: earliest pair
    #                          barrier -> last write (0.0 at banks=1).
    #                          Overlaps the local tail under skewed
    #                          placements, so local_ns + exchange_ns can
    #                          exceed latency_ns.
    single_ns: float         # one-bank BankTimer baseline for the same N
    analytic_local_ns: float  # per-channel bus lower bound on the local pass
    exchange_bus_occupancy: float  # busy/span over channels during exchange
    xfer_atoms: int
    xfer_hops: int           # atoms that crossed a channel boundary
    stats: StatsRegistry
    stage_breakdown: tuple[ExchangeStageSpan, ...] = ()

    @property
    def speedup(self) -> float:
        return self.single_ns / self.latency_ns if self.latency_ns else 0.0

    @property
    def efficiency(self) -> float:
        return self.speedup / self.banks


def conflict_aware_flat_banks(topo: DeviceTopology,
                              pool: Sequence[int]) -> tuple[int, ...]:
    """Bank-conflict-aware shard placement over `pool`.

    Exchange partners at stride M<<i differ in exactly bit i of the
    sub-NTT index, so placing sub-index b on a bank of channel
    XOR-fold(b) (index bit i folded onto channel bit i mod log2(C),
    every fold column nonzero) guarantees partners sit on DISTINCT
    channels at EVERY stage: each single-bit flip changes the target
    channel.  The default channel-interleaved identity only achieves
    this for the low log2(C) stages — the high-stride stages fight over
    one bus, which is the measured multi-bank efficiency knee.

    Returns a permutation of `pool` (sub-index -> flat bank id).  Falls
    back to pool order when the device has one channel or a
    non-power-of-two shape (the fold is undefined), and to the fullest
    remaining channel bucket when the pool is channel-skewed (e.g. a
    scheduler gang reserved on whatever banks were free).
    """
    pool = list(pool)
    nbanks = len(pool)
    chans = topo.channels
    if (chans <= 1 or chans & (chans - 1)
            or nbanks & (nbanks - 1) or nbanks <= 1):
        return tuple(pool)
    cb = chans.bit_length() - 1
    buckets: dict[int, list[int]] = {}
    for f in pool:
        buckets.setdefault(topo.address_of(f).channel, []).append(f)
    out = []
    for b in range(nbanks):
        want, bits, i = 0, b, 0
        while bits:
            if bits & 1:
                want ^= 1 << (i % cb)
            bits >>= 1
            i += 1
        bucket = buckets.get(want)
        if not bucket:
            want = min(buckets, key=lambda c: (-len(buckets[c]), c))
            bucket = buckets[want]
        out.append(bucket.pop(0))
        if not bucket:
            del buckets[want]
    return tuple(out)


class ShardedNttPlan:
    """Four-step command plan for one size-n NTT over `banks` banks.

    Sub-NTT index b (bank b's N/B-point slice) maps to topology flat bank
    id b -- channel-interleaved by `DeviceTopology`, so consecutive
    shards land on different channels and exchange partners at small
    strides sit across the channel boundary (the inter-channel hops the
    benchmark sweeps measure).
    """

    def __init__(self, cfg: PimConfig, n: int, banks: int, forward: bool = False,
                 topo: DeviceTopology | None = None,
                 flat_banks: Sequence[int] | None = None,
                 placement: str = "identity"):
        if n & (n - 1) or n <= 0:
            raise ValueError("n must be a power of two")
        if banks & (banks - 1) or banks <= 0:
            raise ValueError("banks must be a power of two")
        if n % banks:
            raise ValueError(f"banks={banks} does not divide n={n}")
        self.cfg = cfg
        self.n = n
        self.banks = banks
        self.forward = forward
        self.m = n // banks  # words per bank (the local sub-NTT size)
        if self.m < cfg.atom_words:
            raise ValueError(
                f"n/banks = {self.m} is below one atom ({cfg.atom_words} words)")
        rows_needed = max(1, self.m // cfg.row_words)
        if rows_needed > cfg.rows_per_bank:
            raise ValueError(
                f"a {self.m}-word shard needs {rows_needed} rows; a bank "
                f"has {cfg.rows_per_bank}")
        if banks > 1 and cfg.num_buffers < 2:
            raise ValueError("the exchange phase needs num_buffers >= 2")
        if topo is None:
            topo = DeviceTopology.from_config(cfg)
            if topo.total_banks < banks:
                # grow the default device to fit the plan (keeps the
                # functional API usable with the paper's 1-bank config);
                # an explicitly passed topology is never resized
                per_ch = -(-banks // (topo.channels * topo.ranks))  # ceil
                topo = DeviceTopology(channels=topo.channels, ranks=topo.ranks,
                                      banks_per_rank=per_ch)
        elif topo.total_banks < banks:
            raise ValueError(
                f"topology {topo.describe()} has fewer than {banks} banks")
        self.topo = topo
        if placement not in ("identity", "conflict"):
            raise ValueError(
                f"placement must be 'identity' or 'conflict', got {placement!r}")
        self.placement = placement
        # Sub-NTT index -> physical flat bank id.  The default identity
        # placement channel-interleaves shards; the scheduler passes the
        # gang it actually reserved.  `placement="conflict"` permutes
        # the pool so exchange partners always straddle channels
        # (`conflict_aware_flat_banks`).
        pool = tuple(flat_banks) if flat_banks is not None else tuple(range(banks))
        if placement == "conflict":
            pool = conflict_aware_flat_banks(self.topo, pool)
        self.flat_banks = pool
        if len(self.flat_banks) != banks or len(set(self.flat_banks)) != banks:
            raise ValueError(f"flat_banks must be {banks} distinct bank ids")
        for f in self.flat_banks:
            self.topo.address_of(f)  # range check
        self._local_streams: list[list[Command]] | None = None
        self._exchange_stages: list[ExchangeStage] | None = None
        self._local_traces: list | None = None
        self._exchange_charges: list | None = None

    # -- command-level structure --------------------------------------------
    def local_streams(self) -> list[list[Command]]:
        """Per-bank size-M Mapper streams with shifted twiddle bases.

        At banks=1 this is exactly `RowCentricMapper(cfg, n).commands()`
        -- command-list equality, the differential anchor of the plan.
        Cached: simulate() and the analytic bound both walk the streams.
        """
        if self._local_streams is None:
            self._local_streams = [
                RowCentricMapper(self.cfg, self.m, forward=self.forward,
                                 twiddle_base=b * self.m).commands()
                for b in range(self.banks)
            ]
        return self._local_streams

    def local_param_traces(self) -> list:
        """Per-bank `engine.param_beat_trace` residency traces (the
        device-side twiddle-parameter cache model), resolved against the
        GLOBAL transform size through the shifted twiddle bases.  Cached
        like `local_streams`: every simulate() replays one precomputed
        trace ([None]*banks when the cache is disabled)."""
        if self._local_traces is None:
            self._local_traces = [
                param_beat_trace(self.cfg, self.n, s)
                for s in self.local_streams()
            ]
        return self._local_traces

    def exchange_stages(self) -> list[ExchangeStage]:
        """Cross-bank stages, in execution order for this orientation.

        Cached (like `local_streams`): the stage set and its shared
        twiddle indices are pure functions of (n, banks, orientation), so
        repeated `simulate`/`run_functional` calls replay one schedule.
        """
        if self._exchange_stages is not None:
            return self._exchange_stages
        strides = [self.m << i for i in range(int(math.log2(self.banks)))]
        if self.forward:
            strides = strides[::-1]  # CT: large strides first
        stages = []
        for t in strides:
            tb = t // self.m  # stride in banks
            pairs = tuple(
                ExchangePair(u=b, v=b + tb, stride=t,
                             tw_index=twiddle_index(self.n, t, b * self.m))
                for b in range(self.banks)
                if (b // tb) % 2 == 0
            )
            stages.append(ExchangeStage(stride=t, pairs=pairs))
        self._exchange_stages = stages
        return stages

    def exchange_param_charges(self) -> list[tuple]:
        """Per-(stage, pair) parameter-cache charges for the exchange C2s.

        The device-side (w0, r_w) cache is ONE per bank: residency the
        local pass leaves behind is what the exchange phase walks into.
        This threads the plan-level LRU across the phase boundary — the
        same per-bank LRU `local_param_traces` resolves seeds the
        exchange lookups (GS runs local first; CT runs the exchange on
        cold caches, which the empty seed models exactly).

        Every atom of a pair shares ONE program (the pair's single
        twiddle) and program keys are unique per (stage, pair), so with
        any cache (entries >= 1) the outcome is a full load on the
        pair's first butterfly and a one-beat re-select after —
        `tests/test_sharded.py` pins this closed form against the LRU
        walk, which is why threading residency does not perturb any
        committed benchmark number: the key spaces of the two phases
        are disjoint (local strides < M, exchange strides >= M resolve
        different twiddle indices).

        Returns, per stage, a tuple of per-pair
        `(first_ns, first_code, rest_ns, rest_code)` charges; all-None
        charges when the cache is disabled.
        """
        if self._exchange_charges is not None:
            return self._exchange_charges
        cfg = self.cfg
        entries = cfg.param_cache_entries
        stages = self.exchange_stages()
        if not entries:
            cold = (None, 0, None, 0)
            self._exchange_charges = [tuple(cold for _ in st.pairs)
                                      for st in stages]
            return self._exchange_charges
        full_ns = cfg.param_load_cycles * cfg.dram_ns
        hit_ns = param_hit_beats(cfg) * cfg.dram_ns
        lru: list[OrderedDict] = [OrderedDict() for _ in range(self.banks)]
        if not self.forward:  # GS: the local pass has run when we arrive
            for b, cmds in enumerate(self.local_streams()):
                cache = lru[b]
                for c in cmds:
                    if c.__class__ not in PARAM_OPS:
                        continue
                    key = param_program_key(cfg, self.n, c)
                    if key in cache:
                        cache.move_to_end(key)
                    else:
                        cache[key] = True
                        if len(cache) > entries:
                            cache.popitem(last=False)
        charges = []
        for stage in stages:
            row = []
            for p in stage.pairs:
                probe = C2((0,), (1,), (p.u * self.m,), p.stride,
                           gs=not self.forward)
                key = param_program_key(cfg, self.n, probe)
                cache = lru[p.u]
                if key in cache:
                    cache.move_to_end(key)
                    first = (hit_ns, 2)
                else:
                    cache[key] = True
                    if len(cache) > entries:
                        cache.popitem(last=False)
                    first = (full_ns, 1)
                row.append((first[0], first[1], hit_ns, 2))
            charges.append(tuple(row))
        self._exchange_charges = charges
        return charges

    def trace_streams(self) -> dict[tuple[int, int], list[Command]]:
        """Local-pass streams keyed by (channel, bank-in-channel).

        This is the `pimsys.trace`-dumpable command-level artifact of the
        plan: the exchange phase is a bus/topology schedule (not bank
        program text) and is regenerated deterministically from
        `exchange_stages()` at replay time.
        """
        out: dict[tuple[int, int], list[Command]] = {}
        for b, cmds in enumerate(self.local_streams()):
            addr = self.topo.address_of(self.flat_banks[b])
            out[(addr.channel, self.topo.local_id(addr))] = cmds
        return out

    # -- functional execution -----------------------------------------------
    def run_functional(self, a: np.ndarray, ctx: ntt_ref.NttContext) -> np.ndarray:
        """Bit-exact execution on one `FunctionalBank` per bank.

        The exchange stages apply the shared-twiddle vector butterfly to
        whole bank images -- functionally identical to streaming the
        atoms through the u-bank's CU, which is what `simulate` times.
        """
        if a.shape[0] != self.n:
            raise ValueError(f"input length {a.shape[0]} != n={self.n}")
        if ctx.n != self.n:
            raise ValueError(f"context is for n={ctx.n}, plan is n={self.n}")
        q = ctx.q
        table = ctx.psi_brv if self.forward else ctx.psi_inv_brv
        # Size the memory image to the shard, not the device (a 32-bank
        # plan would otherwise allocate 32 full bank images).
        rows = max(1, self.m // self.cfg.row_words)
        small = self.cfg.with_(rows_per_bank=rows)
        fbanks = []
        for b in range(self.banks):
            fb = FunctionalBank(small, ctx, forward=self.forward)
            fb.load_poly(np.asarray(a[b * self.m:(b + 1) * self.m], np.uint32))
            fbanks.append(fb)

        def local_pass():
            for fb, cmds in zip(fbanks, self.local_streams()):
                fb.run(cmds)

        def exchange():
            for stage in self.exchange_stages():
                for p in stage.pairs:
                    u = fbanks[p.u].read_poly(self.m).astype(np.int64)
                    v = fbanks[p.v].read_poly(self.m).astype(np.int64)
                    w = int(table[p.tw_index])
                    if self.forward:  # CT: (u + w*v, u - w*v)
                        wv = v * w % q
                        nu, nv = (u + wv) % q, (u - wv) % q
                    else:  # GS: (u + v, (u - v)*w)
                        nu, nv = (u + v) % q, (u - v) * w % q
                    fbanks[p.u].load_poly(nu.astype(np.uint32))
                    fbanks[p.v].load_poly(nv.astype(np.uint32))

        if self.forward:
            exchange()
            local_pass()
        else:
            local_pass()
            exchange()
        return np.concatenate([fb.read_poly(self.m) for fb in fbanks])

    # -- timing ---------------------------------------------------------------
    def analytic_local_bound(self) -> float:
        """Per-channel shared-bus lower bound on the local pass.

        The channel bus serializes its banks' command+parameter traffic;
        the pass cannot finish before the busiest channel drains, nor
        before a lone sub-NTT would on a private bus.  Parameter beats
        come from each stream's cache-residency trace when the
        device-side parameter cache is enabled (the engine charges
        exactly those beats, so the bound stays a bound)."""
        cfg = self.cfg
        per_channel: dict[int, float] = {}
        traces = self.local_param_traces()
        for b, cmds in enumerate(self.local_streams()):
            n_cmds = sum(1 for c in cmds if not isinstance(c, Mark))
            cu = sum(1 for c in cmds if isinstance(c, (C1, C2, CMul)))
            bus_ns = (n_cmds + trace_param_beats(cfg, traces[b], cu)) * cfg.dram_ns
            ch = self.topo.address_of(self.flat_banks[b]).channel
            per_channel[ch] = per_channel.get(ch, 0.0) + bus_ns
        return max(per_channel.values(), default=0.0)

    def _port(self, dev: Device, sub: int) -> tuple[ChannelController, int]:
        addr = self.topo.address_of(self.flat_banks[sub])
        return dev.channels[addr.channel], self.topo.local_id(addr)

    def _engine(self, dev: Device, sub: int) -> tuple[ChannelController, BankEngine]:
        ctrl, local = self._port(dev, sub)
        return ctrl, ctrl.engines[local]

    def _issue(self, dev: Device, sub: int, cmd: Command, not_before: float = 0.0,
               param_ns: float | None = None, code: int = 0):
        """Issue one exchange-phase command through the bank's real engine,
        holding its channel's shared bus (and rank windows) exactly as
        the arbiter would."""
        ctrl, local = self._port(dev, sub)
        return ctrl.issue_direct(local, cmd, not_before, param_ns=param_ns,
                                 code=code)

    def _open(self, dev: Device, sub: int, row: int, not_before: float = 0.0) -> float:
        _, eng = self._engine(dev, sub)
        if eng.open_row != row:
            _, done = self._issue(dev, sub, Act(row), not_before)
            return done
        return not_before

    def _transfer(self, dev: Device, src: int, dst: int, earliest: float) -> float:
        """Move one atom src-bank -> dst-bank buffer over the shared bus
        (`DeviceEngine.burst`: same-channel = one bus hold, cross-channel
        = both buses held + hop latency).  Returns the arrival time at
        the destination buffer."""
        ch_s = self.topo.address_of(self.flat_banks[src]).channel
        ch_d = self.topo.address_of(self.flat_banks[dst]).channel
        if ch_s != ch_d:
            self._xfer_hops += 1
        return dev.burst(ch_s, ch_d, earliest)

    def _pair_chain(self, dev: Device, p: ExchangePair, t0: float,
                    charge: tuple, ready: list[float],
                    ends: list[float], idx: int):
        """The full atom-chain of one exchange pair, as a generator.

        Per atom: ColRead on v, burst v->u, ColRead of u's own atom, C2
        on u's CU (one shared twiddle per pair => one (w0, r_w) stream),
        ColWrite of u', burst u->v of v', ColWrite on v.

        Each `yield` publishes the earliest time the NEXT bus-occupying
        step could actually start (`ChannelEngine.earliest_issue`: bank
        hazards + rank gates, or the burst's data-ready edge).  The
        pipelined driver pops the globally soonest step across all live
        chains, so a command stalled on a data hazard never parks its
        channel bus ahead of a neighbor pair's ready work; the serial
        driver simply exhausts one chain at a time, reproducing the
        strictly ordered pre-pipelining schedule command for command.
        Interleaving is safe because a bank belongs to exactly one pair
        per stage: per-bank command order is unchanged, only the bus
        grant order moves, and the engines enforce every hazard either
        way.

        On exhaustion the chain publishes its completion into
        `ready[p.u]/ready[p.v]` and `ends[idx]` (pairs within a stage
        are bank-disjoint, so mid-stage updates cannot be observed by
        a concurrent chain).
        """
        cfg = self.cfg
        Na, R = cfg.atom_words, cfg.row_words
        slots = max(1, cfg.num_buffers // 2)
        ctrl_u, local_u = self._port(dev, p.u)
        ctrl_v, local_v = self._port(dev, p.v)
        eng_u = ctrl_u.engines[local_u]
        eng_v = ctrl_v.engines[local_v]
        pn0, code0, pn1, code1 = charge
        done_u = done_v = t0
        for a in range(self.m // Na):
            w0 = a * Na
            row, atom = w0 // R, (w0 % R) // Na
            slot = a % slots
            bu_loc, bu_recv = 2 * slot, 2 * slot + 1
            bv_send, bv_recv = 2 * slot, 2 * slot + 1
            # v reads its atom and bursts it to u's spare buffer
            rd_v = ColRead(row, atom, bv_send)
            if eng_v.open_row != row:
                yield ctrl_v.earliest_issue(local_v, Act(row), t0)
            else:
                yield ctrl_v.earliest_issue(local_v, rd_v, t0)
            t = self._open(dev, p.v, row, t0)
            _, v_read = self._issue(dev, p.v, rd_v, t)
            yield max(v_read, eng_u.buf_free[bu_recv])
            arrive_u = self._transfer(
                dev, p.v, p.u, max(v_read, eng_u.buf_free[bu_recv]))
            eng_u.data_ready[bu_recv] = arrive_u
            # the burst consumes bv_send: WAR for the next read
            eng_v.buf_free[bv_send] = max(eng_v.buf_free[bv_send], arrive_u)
            self._xfer_atoms += 1
            # u reads its own atom and runs the butterfly on its CU
            rd_u = ColRead(row, atom, bu_loc)
            if eng_u.open_row != row:
                yield ctrl_u.earliest_issue(local_u, Act(row), t0)
            else:
                yield ctrl_u.earliest_issue(local_u, rd_u, t0)
            t = self._open(dev, p.u, row, t0)
            self._issue(dev, p.u, rd_u, t)
            base = p.u * self.m + w0
            c2 = C2((bu_loc,), (bu_recv,), (base,), p.stride,
                    gs=not self.forward)
            pn, code = (pn0, code0) if a == 0 else (pn1, code1)
            yield ctrl_u.earliest_issue(local_u, c2, param_ns=pn)
            _, c2_done = self._issue(dev, p.u, c2, param_ns=pn, code=code)
            wr_u = ColWrite(row, atom, bu_loc)
            yield c2_done
            _, u_wr = self._issue(dev, p.u, wr_u)
            done_u = max(done_u, u_wr)
            # v' bursts back and is written on v
            yield max(c2_done, eng_v.buf_free[bv_recv])
            arrive_v = self._transfer(
                dev, p.u, p.v, max(c2_done, eng_v.buf_free[bv_recv]))
            eng_u.buf_free[bu_recv] = max(eng_u.buf_free[bu_recv], arrive_v)
            eng_v.data_ready[bv_recv] = arrive_v
            self._xfer_atoms += 1
            yield arrive_v
            _, v_wr = self._issue(dev, p.v, ColWrite(row, atom, bv_recv))
            done_v = max(done_v, v_wr)
        ready[p.u], ready[p.v] = done_u, done_v
        ends[idx] = done_u if done_u > done_v else done_v

    def _run_exchange(self, dev: Device, ready: list[float],
                      pipelined: bool = True
                      ) -> tuple[float | None, tuple[ExchangeStageSpan, ...]]:
        """Issue every exchange stage into the live engines.

        `ready[b]` carries each sub-NTT's data-complete time in and out.

        With `pipelined` (and the double-buffering the plan already
        requires, `num_buffers >= 2`), the pairs of a stage run as
        interleaved chains through a single earliest-step event loop:
        pair k+1's reads issue while pair k's writes drain, which is
        the paper's Nb-buffer pipelining applied one level up, to the
        channel-bus schedule.  `pipelined=False` exhausts one pair at a
        time — bit-identical to the historical strictly serial
        exchange.  Stages stay barriers either way (stage s+1's pairs
        consume both partners' stage-s outputs).

        Parameter-cache charges come from `exchange_param_charges()`,
        which threads each bank's LRU residency across the local ->
        exchange phase boundary.

        Returns `(x_start, stage_breakdown)`: the exchange activity
        START — the earliest first-stage pair barrier, which every
        exchange grant is at or after (pairs on lightly loaded channels
        begin exchanging before the slowest bank's local pass ends, so
        this can precede max(ready)-at-entry; the occupancy window must
        open here, not at the global phase boundary) — and one
        `ExchangeStageSpan` per executed stage.
        """
        x_start: float | None = None
        tr = dev.tracer
        charges = self.exchange_param_charges()
        stages = self.exchange_stages()
        nstages = len(stages)
        # per-stage accounting shared by both drivers
        t0s: list[list[float]] = [[0.0] * len(st.pairs) for st in stages]
        ends: list[list[float]] = [[0.0] * len(st.pairs) for st in stages]
        busy: list[float] = [0.0] * nstages

        if pipelined and self.cfg.num_buffers >= 2:
            # One global event loop over every (stage, pair) chain.  A
            # pair is eligible once BOTH its banks finished their
            # previous stage's chain (a bank is in exactly one pair per
            # stage, so per-bank command order is preserved); eligible
            # chains interleave by earliest next step, so pair k+1's
            # reads issue while pair k's writes drain AND a bank that
            # finishes stage s early starts its stage-s+1 work under
            # the stage-s stragglers.
            pair_of: list[dict[int, int]] = []
            for st in stages:
                m = {}
                for i, p in enumerate(st.pairs):
                    m[p.u] = i
                    m[p.v] = i
                pair_of.append(m)
            bank_stage = [-1] * self.banks  # last exhausted stage per bank
            heap: list = []

            def start(si: int, i: int) -> None:
                p = stages[si].pairs[i]
                t0 = max(ready[p.u], ready[p.v])
                t0s[si][i] = t0
                g = self._pair_chain(dev, p, t0, charges[si][i], ready,
                                     ends[si], i)
                try:
                    heapq.heappush(heap, (next(g), si, i, g))
                except StopIteration:
                    pass

            for i in range(len(stages[0].pairs)) if nstages else ():
                start(0, i)
            while heap:
                _, si, i, g = heapq.heappop(heap)
                b0 = sum(c.bus_busy_ns for c in dev.channels)
                try:
                    heapq.heappush(heap, (next(g), si, i, g))
                    busy[si] += sum(c.bus_busy_ns
                                    for c in dev.channels) - b0
                except StopIteration:
                    busy[si] += sum(c.bus_busy_ns
                                    for c in dev.channels) - b0
                    p = stages[si].pairs[i]
                    bank_stage[p.u] = bank_stage[p.v] = si
                    if si + 1 < nstages:
                        for b in (p.u, p.v):
                            j = pair_of[si + 1][b]
                            q = stages[si + 1].pairs[j]
                            if (bank_stage[q.u] == si
                                    and bank_stage[q.v] == si):
                                start(si + 1, j)
        else:
            for si, (stage, st_charges) in enumerate(zip(stages, charges)):
                b0 = sum(c.bus_busy_ns for c in dev.channels)
                for i, p in enumerate(stage.pairs):
                    t0s[si][i] = max(ready[p.u], ready[p.v])
                    for _ in self._pair_chain(dev, p, t0s[si][i],
                                              st_charges[i], ready,
                                              ends[si], i):
                        pass
                busy[si] = sum(c.bus_busy_ns for c in dev.channels) - b0

        spans: list[ExchangeStageSpan] = []
        for si, stage in enumerate(stages):
            if not stage.pairs:
                continue
            begin, end = min(t0s[si]), max(ends[si])
            if x_start is None or begin < x_start:
                x_start = begin
            used = {self.topo.address_of(self.flat_banks[p.u]).channel
                    for p in stage.pairs}
            used |= {self.topo.address_of(self.flat_banks[p.v]).channel
                     for p in stage.pairs}
            span = end - begin
            work = sum(e - t for e, t in zip(ends[si], t0s[si]))
            occ = busy[si] / (len(used) * span) if span > 0 else 0.0
            overlap = 1.0 - span / work if work > 0 else 0.0
            occ = min(1.0, occ)
            overlap = min(1.0, max(0.0, overlap))
            spans.append(ExchangeStageSpan(
                stride=stage.stride, begin_ns=begin, end_ns=end,
                busy_ns=busy[si], pairs=len(stage.pairs),
                channels=len(used), occupancy=occ, overlap=overlap))
            if tr is not None and end > 0.0:
                tr.phases.append(
                    ("exchange",
                     f"stride={stage.stride};occ={occ:.2f};"
                     f"overlap={overlap:.2f}",
                     begin, end))
        return x_start, tuple(spans)

    def simulate(self, policy: str = "rr", single: TimingResult | None = None,
                 baseline: bool = True, pipelined: bool = True,
                 tracer=None) -> ShardedTimingResult:
        """Time the full sharded NTT on the device-level memory system.

        Pass `single` (the one-bank `simulate_ntt` result) when sweeping
        bank counts, or `baseline=False` to skip the one-bank reference
        sim entirely (speedup then reads 0; the scheduler does this).
        `pipelined=False` forces strictly serial engines (the Fig 6a
        ablation), in the local passes AND the exchange butterflies.
        `tracer` (a `telemetry.Tracer`) records the full timeline:
        per-command events through the engines, per-bank local-pass
        spans, per-stage exchange spans, and every inter-bank burst.
        """
        dev = Device(self.cfg, self.topo, policy=policy, pipelined=pipelined,
                     tracer=tracer)
        self._xfer_atoms = 0
        self._xfer_hops = 0
        ready = [0.0] * self.banks
        if single is None and baseline:
            single = _time_ntt(self.n, self.cfg, forward=self.forward,
                               pipelined=pipelined)
        single_ns = single.ns if single is not None else 0.0

        def run_local(gates: list[float]) -> None:
            traces = self.local_param_traces()
            for b, cmds in enumerate(self.local_streams()):
                dev.enqueue_flat(self.flat_banks[b], cmds, gate=gates[b],
                                 job_id=("local", b), param_trace=traces[b])
            for ev in dev.drain():
                b = ev.job_id[1]
                ready[b] = ev.done
                if tracer is not None:
                    tracer.phases.append(
                        (f"bank{self.flat_banks[b]}", "local",
                         gates[b], ev.done))

        if self.forward:
            busy0 = [c.bus_busy_ns for c in dev.channels]
            x_start, breakdown = self._run_exchange(dev, ready, pipelined)
            x_end = max(ready)
            exchange_ns = (x_end - x_start) if x_start is not None else 0.0
            x_busy = sum(c.bus_busy_ns - b0 for c, b0 in zip(dev.channels, busy0))
            run_local(list(ready))
            local_ns = max(ready) - x_end
        else:
            run_local([0.0] * self.banks)
            local_ns = max(ready)
            busy0 = [c.bus_busy_ns for c in dev.channels]
            x_start, breakdown = self._run_exchange(dev, ready, pipelined)
            # the window opens at the earliest pair barrier: pairs on a
            # fast channel start exchanging before the slowest local
            # pass ends, and their bursts belong in the denominator
            exchange_ns = (max(ready) - x_start) if x_start is not None else 0.0
            x_busy = sum(c.bus_busy_ns - b0 for c, b0 in zip(dev.channels, busy0))

        latency = max(ready)
        bound = self.analytic_local_bound()
        if latency < bound - 1e-6:  # not an assert: must survive python -O
            raise RuntimeError(
                f"sharded plan beat the analytic local bus bound: {latency} < {bound}")
        used_channels = len({self.topo.address_of(f).channel
                             for f in self.flat_banks})
        occ = (x_busy / (used_channels * exchange_ns)) if exchange_ns > 0 else 0.0
        reg = StatsRegistry(channels=self.topo.channels)
        for ctrl in dev.channels:
            ctrl.record_stats(reg)
        reg.add_device({"xfer_atoms": self._xfer_atoms,
                        "xfer_hops": self._xfer_hops})
        return ShardedTimingResult(
            n=self.n,
            banks=self.banks,
            latency_ns=latency,
            local_ns=local_ns,
            exchange_ns=exchange_ns,
            single_ns=single_ns,
            analytic_local_ns=bound,
            exchange_bus_occupancy=min(1.0, occ),
            xfer_atoms=self._xfer_atoms,
            xfer_hops=self._xfer_hops,
            stats=reg,
            stage_breakdown=breakdown,
        )
