"""Ciphertext-level op specs compiled to multi-tower PIM plans.

The device half of `repro_torch.he`, the port of `repro/he/ops.py`: four
hashable op specs —

    RlweCtMulOp(n, towers)     tensor two ciphertexts -> degree-2 ct
    KeySwitchOp(n, towers)     gadget keyswitch of one polynomial
    RescaleOp(n, towers)       exact mod-down by the last tower
    CtMulRelinOp(n, towers)    fused multiply + relinearize

— registered with `PimSession.compile` through the op-handler registry
(`repro_torch.pimsys.session.register_op_handler`), so importing `repro_torch.he`
is all it takes: plans are frozen and memoized by `(cfg, op)` like the
builtins, `run()` returns the ordinary `RunResult`, and the service
dispatches them as `GangJob`s (each plan primes a latency resolver the
scheduler caches by channel pattern — O(1) replay per request, which
keeps fastpath-policy serving eligible for homogeneous HE traffic).

Lowering model (tower -> bank, phase-barriered)
-----------------------------------------------
Tower t maps to reserved bank `flats[t % banks]` — at banks = towers
each residue tower owns a bank (and, flat order being channel-
interleaved, spreads over channels), which is the embarrassingly
parallel axis of RNS: every tower's NTT/pointwise phase is an
independent single-modulus stream the paper's bank already serves.
A plan is a sequence of *segments*:

  * compute segments enqueue one identical command stream per tower
    (forward NTTs, pointwise passes, inverse NTTs + scaling) on the
    tower's bank, gated on that tower's previous segment;
  * transfer segments model real data movement over the shared buses
    with `DeviceEngine.burst` — keyswitch base-extension broadcasts
    each digit from its home bank to every other reserved bank,
    rescale broadcasts the dropped tower's polynomials; same-bank
    moves are local row traffic and free.

The parameter-cache residency trace is computed PER TOWER with the
program key salted by the tower's modulus: the device cache keys
(w0, r_w) programs, and two towers share a bank but never a modulus,
so their programs must not alias (`engine.param_program_key` alone
would).  Towers sharing a bank walk one LRU sequentially in tower
order — the coarse serialization the bank FIFO imposes anyway.

Commands are identical across towers (only parameter *values* differ,
which timing never sees), so phase command streams are built once per
plan and replayed per tower: compile-once/run-many, like every other
plan in the repo.

Where the work runs: a run's value comes from `repro_torch.he.rns` on the
session's `device` (the card by default: B1-B3, one call per tower per
phase; `device="cpu"` runs the kernels' plain versions), a uint32 tensor
there.  The timing (`HeTimingResult`) is the simulator's, on the host.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Mapping, Sequence


from repro_torch.core.mapping import Command, RowCentricMapper
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.pimsim import PARAM_OPS
from repro_torch.core.polymul import pointwise_commands, scaling_commands
from repro_torch.he import rns
from repro_torch.pimsys.engine import (
    _P_HIT,
    _P_MISS,
    DeviceEngine,
    param_hit_beats,
    param_program_key,
)
from repro_torch.pimsys.scheduler import GangJob, RequestScheduler
from repro_torch.pimsys.session import (
    CompiledPlan,
    OpHandler,
    PimSession,
    RunResult,
    register_op_handler,
)
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.telemetry import TelemetryHandle, Tracer
from repro_torch.pimsys.topology import DeviceTopology


# --------------------------------------------------------------------------
# Op specs
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RlweCtMulOp:
    """Tensor two degree-1 ciphertexts into a degree-2 one.

    Inputs `[2, towers, n]` x 2, output `[3, towers, n]`.  Per tower:
    4 forward NTTs, 4 pointwise products + 1 accumulate pass, 3 inverse
    NTTs (+ scaling).  `banks=0` reserves min(towers, device banks);
    `moduli=None` uses the default descending-prime basis.
    """

    n: int
    towers: int
    banks: int = 0
    moduli: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class KeySwitchOp:
    """Gadget keyswitch of one polynomial: `[L, n]` (+ key) -> `[2, L, n]`.

    The NTT-dominated HE kernel: base-extension broadcast (modeled as
    bus bursts), L forward NTTs per tower, 2L pointwise products
    against the bank-resident NTT-domain key, 2 inverse NTTs.
    """

    n: int
    towers: int
    banks: int = 0
    moduli: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class RescaleOp:
    """Exact mod-down by the last tower: `[2, L, n]` -> `[2, L-1, n]`.

    Movement-dominated: the dropped tower's two polynomials broadcast
    to every surviving tower's bank, then a subtract + scalar-multiply
    pass per component per tower.  No NTTs.
    """

    n: int
    towers: int
    banks: int = 0
    moduli: tuple[int, ...] | None = None


@dataclasses.dataclass(frozen=True)
class CtMulRelinOp:
    """Fused multiply + relinearize: `[2, L, n]` x 2 (+ key) -> `[2, L, n]`.

    Keeps d0/d1 and the keyswitch accumulators in the NTT domain so
    only d2 round-trips for digit decomposition — 3 inverse NTTs per
    tower against 5 for the unfused `RlweCtMulOp` + `KeySwitchOp` pair.
    """

    n: int
    towers: int
    banks: int = 0
    moduli: tuple[int, ...] | None = None


HE_OPS = (RlweCtMulOp, KeySwitchOp, RescaleOp, CtMulRelinOp)


def basis_for(op) -> rns.RnsBasis:
    """The (memoized) `RnsBasis` an HE op spec computes under."""
    return rns.make_basis(op.n, op.towers, moduli=op.moduli)


# --------------------------------------------------------------------------
# Plan segments
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class _Compute:
    """One per-tower command stream, issued on every (listed) tower's
    bank at that tower's ready time."""

    name: str
    commands: tuple[Command, ...]
    towers: tuple[int, ...] | None = None  # None = every tower


@dataclasses.dataclass(frozen=True, eq=False)
class _Xfer:
    """Broadcast `polys` polynomials from each source tower's bank to
    every other reserved bank (same-bank destinations are free local
    row traffic)."""

    name: str
    src_towers: tuple[int, ...]
    polys: int


@dataclasses.dataclass(eq=False)
class HePlan:
    """Handler-owned artifact on `CompiledPlan.ext`: the segment
    schedule plus per-(banks, channel-pattern) simulation caches."""

    op: object
    basis: rns.RnsBasis
    segments: tuple
    banks: int
    rows: int
    _sim_cache: dict = dataclasses.field(default_factory=dict, repr=False)
    _trace_cache: dict = dataclasses.field(default_factory=dict, repr=False)


def _ntt(cfg: PimConfig, n: int, row: int, forward: bool) -> list[Command]:
    return RowCentricMapper(cfg, n, forward=forward, base_row=row).commands()


def _segments(cfg: PimConfig, op) -> tuple[tuple, int]:
    """(segments, per-bank row bound) for one op spec.

    Row layout is slot-based: polynomial slot k lives at rows
    [k*R, (k+1)*R).  Streams only need plausible row addresses (timing
    counts ACT/col/CU traffic; values replay functionally off-device).
    """
    n, big_l = op.n, op.towers
    rows_per_poly = max(1, n // cfg.row_words)

    def slot(k: int) -> int:
        return k * rows_per_poly

    def cat(*streams) -> tuple[Command, ...]:
        return tuple(c for s in streams for c in s)

    segs: list = []
    if isinstance(op, RlweCtMulOp):
        # slots: a0 a1 b0 b1 | cross d2 — d0/d1 reuse a0/cross in place
        slots = 6
        segs.append(_Compute("fwd", cat(
            *(_ntt(cfg, n, slot(k), True) for k in range(4)))))
        segs.append(_Compute("pointwise", cat(
            pointwise_commands(cfg, n, slot(0), slot(2)),   # d0 = a0.b0
            pointwise_commands(cfg, n, slot(4), slot(3)),   # cross = a0.b1
            pointwise_commands(cfg, n, slot(1), slot(3)),   # d2 = a1.b1
            pointwise_commands(cfg, n, slot(5), slot(2)),   # a1.b0
            scaling_commands(cfg, n, slot(4)),              # d1 accumulate
        )))
        segs.append(_Compute("inv", cat(
            _ntt(cfg, n, slot(0), False), scaling_commands(cfg, n, slot(0)),
            _ntt(cfg, n, slot(4), False), scaling_commands(cfg, n, slot(4)),
            _ntt(cfg, n, slot(1), False), scaling_commands(cfg, n, slot(1)),
        )))
    elif isinstance(op, KeySwitchOp):
        # slots: L digits | 2L resident key halves | 2 accumulators
        slots = 3 * big_l + 2
        segs.append(_Xfer("base_extend", tuple(range(big_l)), 1))
        segs.append(_Compute("digit_ntt", cat(
            *(_ntt(cfg, n, slot(j), True) for j in range(big_l)))))
        inner: list = []
        for j in range(big_l):
            inner += pointwise_commands(cfg, n, slot(j), slot(big_l + 2 * j))
            inner += pointwise_commands(cfg, n, slot(j), slot(big_l + 2 * j + 1))
            if j:  # accumulate into the two running sums
                inner += scaling_commands(cfg, n, slot(3 * big_l))
                inner += scaling_commands(cfg, n, slot(3 * big_l + 1))
        segs.append(_Compute("inner", tuple(inner)))
        segs.append(_Compute("inv", cat(
            _ntt(cfg, n, slot(3 * big_l), False),
            scaling_commands(cfg, n, slot(3 * big_l)),
            _ntt(cfg, n, slot(3 * big_l + 1), False),
            scaling_commands(cfg, n, slot(3 * big_l + 1)),
        )))
    elif isinstance(op, RescaleOp):
        # slots: c0 c1 | the dropped tower's two broadcast polys
        slots = 4
        segs.append(_Xfer("mod_down", (big_l - 1,), 2))
        survivors = tuple(range(big_l - 1))
        segs.append(_Compute("fold", cat(
            pointwise_commands(cfg, n, slot(0), slot(2)),  # c0 - last0
            scaling_commands(cfg, n, slot(0)),             # * q_last^-1
            pointwise_commands(cfg, n, slot(1), slot(3)),
            scaling_commands(cfg, n, slot(1)),
        ), towers=survivors))
    elif isinstance(op, CtMulRelinOp):
        # slots: a0 a1 b0 b1 cross d2 | L digits | 2L key | 2 accumulators
        slots = 6 + 3 * big_l + 2
        digit0, key0, acc0 = 6, 6 + big_l, 6 + 3 * big_l
        segs.append(_Compute("fwd", cat(
            *(_ntt(cfg, n, slot(k), True) for k in range(4)))))
        segs.append(_Compute("pointwise", cat(
            pointwise_commands(cfg, n, slot(0), slot(2)),
            pointwise_commands(cfg, n, slot(4), slot(3)),
            pointwise_commands(cfg, n, slot(1), slot(3)),
            pointwise_commands(cfg, n, slot(5), slot(2)),
            scaling_commands(cfg, n, slot(4)),
        )))
        segs.append(_Compute("inv_d2", cat(
            _ntt(cfg, n, slot(5), False), scaling_commands(cfg, n, slot(5)))))
        segs.append(_Xfer("base_extend", tuple(range(big_l)), 1))
        segs.append(_Compute("digit_ntt", cat(
            *(_ntt(cfg, n, slot(digit0 + j), True) for j in range(big_l)))))
        inner = []
        for j in range(big_l):
            inner += pointwise_commands(cfg, n, slot(digit0 + j),
                                        slot(key0 + 2 * j))
            inner += pointwise_commands(cfg, n, slot(digit0 + j),
                                        slot(key0 + 2 * j + 1))
            inner += scaling_commands(cfg, n, slot(acc0))      # accumulate /
            inner += scaling_commands(cfg, n, slot(acc0 + 1))  # add d0, d1
        segs.append(_Compute("inner", tuple(inner)))
        segs.append(_Compute("inv", cat(
            _ntt(cfg, n, slot(acc0), False),
            scaling_commands(cfg, n, slot(acc0)),
            _ntt(cfg, n, slot(acc0 + 1), False),
            scaling_commands(cfg, n, slot(acc0 + 1)),
        )))
    else:  # pragma: no cover - registry only routes HE_OPS here
        raise TypeError(f"not an HE op: {op!r}")
    return tuple(segs), slots * rows_per_poly


# --------------------------------------------------------------------------
# Simulation on the device engine
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _SimOutcome:
    latency_ns: float
    bank_counters: list          # aligned with the reserved flats
    bus_busy: dict               # channel -> busy ns
    dev_counters: dict           # xfer_atoms / xfer_hops
    phase_ns: dict               # segment name -> duration ns
    tower_done_ns: tuple         # per-tower completion
    param_hit_rate: float | None
    stats: StatsRegistry


def _tower_traces(cfg: PimConfig, hp: HePlan, banks: int):
    """Per-(tower, segment) parameter-cache residency traces, q-salted.

    One LRU per bank; the towers mapped to a bank walk it sequentially
    in tower order (the bank FIFO's coarse serialization).  Keys carry
    the tower's modulus so co-located towers never alias programs.
    Cached per bank count on the plan.  None when the cache is off.
    """
    if cfg.param_cache_entries <= 0:
        return None
    hit = hp._trace_cache.get(banks)
    if hit is not None:
        return hit
    entries, full = cfg.param_cache_entries, cfg.param_load_cycles
    hit_beats = param_hit_beats(cfg)
    big_l, n = hp.basis.towers, hp.basis.n
    traces: dict[tuple[int, int], tuple] = {}
    for b in range(min(banks, big_l)):
        lru: OrderedDict = OrderedDict()
        for t in range(b, big_l, banks):
            q = hp.basis.moduli[t]
            for si, seg in enumerate(hp.segments):
                if not isinstance(seg, _Compute):
                    continue
                if seg.towers is not None and t not in seg.towers:
                    continue
                out = []
                for cmd in seg.commands:
                    if cmd.__class__ not in PARAM_OPS:
                        continue
                    key = param_program_key(cfg, n, cmd)
                    if key is None:  # CMul: no reusable program
                        out.append((full, _P_MISS))
                    elif (q, key) in lru:
                        lru.move_to_end((q, key))
                        out.append((hit_beats, _P_HIT))
                    else:
                        lru[(q, key)] = True
                        if len(lru) > entries:
                            lru.popitem(last=False)
                        out.append((full, _P_MISS))
                traces[(t, si)] = tuple(out)
    hp._trace_cache[banks] = traces
    return traces


def _simulate(cfg: PimConfig, topo: DeviceTopology, policy: str,
              pipelined: bool, hp: HePlan, flats: Sequence[int],
              tracer: Tracer | None = None) -> _SimOutcome:
    """Run the segment schedule on a fresh `DeviceEngine`.

    Tower t executes on `flats[t % len(flats)]`; each segment gates on
    the tower's previous completion (phase barrier per tower), transfer
    segments route real `burst`s over the channel buses and gate every
    destination tower on its bank's last arrival.
    """
    basis = hp.basis
    big_l, n = basis.towers, basis.n
    banks = len(flats)
    bank_of = [flats[t % banks] for t in range(big_l)]
    dev = DeviceEngine(cfg, topo, policy=policy, pipelined=pipelined,
                       tracer=tracer)
    traces = _tower_traces(cfg, hp, banks)
    ready = [0.0] * big_l
    phase_ns: dict[str, float] = {}
    xfer_atoms = xfer_hops = 0
    for si, seg in enumerate(hp.segments):
        if isinstance(seg, _Compute):
            towers = seg.towers if seg.towers is not None else range(big_l)
            start = min(ready[t] for t in towers)
            for t in towers:
                dev.enqueue_flat(
                    bank_of[t], seg.commands, gate=ready[t], job_id=t,
                    param_trace=None if traces is None else traces[(t, si)])
            end = start
            for ev in dev.drain():
                ready[ev.job_id] = ev.done
                if ev.done > end:
                    end = ev.done
        else:
            start = min(ready[t] for t in seg.src_towers)
            atoms_per_poly = max(1, n // cfg.atom_words)
            atoms = seg.polys * atoms_per_poly
            arrive: dict[int, float] = {}
            for j in seg.src_towers:
                src = bank_of[j]
                ch_src = topo.channel_of(src)
                for dst in sorted(set(bank_of)):
                    if dst == src:
                        # local: the digit already lives in this bank's rows
                        arrive[dst] = max(arrive.get(dst, 0.0), ready[j])
                        continue
                    ch_dst = topo.channel_of(dst)
                    last = ready[j]
                    for _ in range(atoms):
                        last = dev.burst(ch_src, ch_dst, last)
                    xfer_atoms += atoms
                    if ch_src != ch_dst:
                        xfer_hops += atoms
                    arrive[dst] = max(arrive.get(dst, 0.0), last)
            end = start
            for t in range(big_l):
                t_arr = arrive.get(bank_of[t], 0.0)
                if t_arr > ready[t]:
                    ready[t] = t_arr
                if t_arr > end:
                    end = t_arr
        phase_ns[seg.name] = end - start
        if tracer is not None:
            tracer.phase("he", seg.name, start, end)
    latency = max(max(ready), dev.makespan_ns)
    stats = dev.stats()
    stats.add_device({"xfer_atoms": xfer_atoms, "xfer_hops": xfer_hops})
    stats.extend_span(latency)
    counters = []
    for f in flats:
        addr = topo.address_of(f)
        counters.append(stats.bank_counts(addr.channel, topo.local_id(addr)))
    bus_busy = {ch: stats.bus_busy_ns(ch) for ch in stats.channels()}
    return _SimOutcome(
        latency_ns=latency,
        bank_counters=counters,
        bus_busy=bus_busy,
        dev_counters={"xfer_atoms": xfer_atoms, "xfer_hops": xfer_hops},
        phase_ns=phase_ns,
        tower_done_ns=tuple(ready),
        param_hit_rate=stats.param_hit_rate() if traces is not None else None,
        stats=stats,
    )


def _sim_cached(cfg, topo, policy, pipelined, hp: HePlan,
                flats: Sequence[int]) -> _SimOutcome:
    """Channel-pattern-cached simulation (the gang resolver's cache
    discipline, shared with the session run path)."""
    key = (len(flats), tuple(topo.channel_of(f) for f in flats),
           policy, pipelined)
    hit = hp._sim_cache.get(key)
    if hit is None:
        hit = hp._sim_cache[key] = _simulate(
            cfg, topo, policy, pipelined, hp, flats)
    return hit


# --------------------------------------------------------------------------
# Timing result
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeTimingResult:
    """Timing of one HE ciphertext op on its reserved gang.

    `single_ns` is the one-bank run (every tower serialized on the
    first reserved bank, movement local) — the baseline `speedup` and
    `efficiency` (= speedup / banks) divide by.  `phase_ns` has one
    entry per plan segment (keyswitch includes `base_extend`);
    `tower_done_ns` the per-tower completion times.
    """

    towers: int
    banks: int
    latency_ns: float
    single_ns: float
    speedup: float
    efficiency: float
    phase_ns: Mapping[str, float]
    tower_done_ns: tuple[float, ...]
    xfer_atoms: int
    xfer_hops: int
    param_hit_rate: float | None

    @property
    def latency_us(self) -> float:
        return self.latency_ns / 1e3


# --------------------------------------------------------------------------
# The handler
# --------------------------------------------------------------------------


class HeOpHandler(OpHandler):
    """Session integration for the four HE ciphertext ops."""

    def canonical(self, op):
        if op.n < 1 or op.n & (op.n - 1):
            raise ValueError(f"n must be a power of two, got {op.n}")
        if op.towers < 1:
            raise ValueError("towers must be >= 1")
        if op.banks < 0:
            raise ValueError("banks must be >= 0 (0 = min(towers, device))")
        if isinstance(op, RescaleOp) and op.towers < 2:
            raise ValueError("rescale needs at least 2 towers")
        return op

    def compile(self, sess: PimSession, op) -> CompiledPlan:
        cfg = sess.cfg
        if op.n < cfg.atom_words:
            raise ValueError("n must be at least one atom")
        banks = op.banks or min(op.towers, sess.topo.total_banks)
        if banks > sess.topo.total_banks:
            raise ValueError(f"{op} wants {banks} banks; topology has "
                             f"{sess.topo.total_banks}")
        segments, rows = _segments(cfg, op)
        if rows > cfg.rows_per_bank:
            raise ValueError(f"{op} working set ({rows} rows) does not fit "
                             f"in one bank ({cfg.rows_per_bank} rows)")
        hp = HePlan(op=op, basis=basis_for(op), segments=segments,
                    banks=banks, rows=rows)
        phases = {seg.name: seg.commands for seg in segments
                  if isinstance(seg, _Compute)}
        return CompiledPlan(
            cfg=cfg, op=op, commands=(), phases=phases,
            placement={"towers": op.towers, "banks": banks, "rows": rows},
            ext=hp,
        )

    # -- functional dispatch -------------------------------------------------
    def _value(self, op, hp: HePlan, inputs, device):
        basis = hp.basis
        if isinstance(op, RlweCtMulOp):
            _require(inputs, 2, "RlweCtMulOp(ct_a, ct_b)")
            return rns.ct_mul(basis, inputs[0], inputs[1], device=device)
        if isinstance(op, KeySwitchOp):
            _require(inputs, 2, "KeySwitchOp(c2, ksk)")
            return rns.keyswitch(basis, inputs[0], _ksk(basis, inputs[1]),
                                 device=device)
        if isinstance(op, RescaleOp):
            _require(inputs, 1, "RescaleOp(ct)")
            return rns.rescale(basis, inputs[0], device=device)
        _require(inputs, 3, "CtMulRelinOp(ct_a, ct_b, ksk)")
        return rns.ct_mul_relin(basis, inputs[0], inputs[1],
                                _ksk(basis, inputs[2]), device=device)

    def run(self, sess: PimSession, plan: CompiledPlan, inputs, *,
            ctx=None, single=None, time=True, backend="engine") -> RunResult:
        if backend == "fastpath":
            raise ValueError(
                "backend='fastpath' does not support HE gang plans in a "
                "direct run: the base-extension phase needs the interpreted "
                "engine's bus model (ServicePolicy(backend='fastpath') "
                "serving replays the cached gang resolver and stays valid)")
        op, hp = plan.op, plan.ext
        value = self._value(op, hp, inputs, sess.device) if inputs else None
        if not time:
            return RunResult(op=op, value=value, timing=None, stats=None,
                             trace=None)
        flats = list(range(hp.banks))
        tracer = sess._tracer()
        if tracer is None:
            out = _sim_cached(sess.cfg, sess.topo, sess.policy,
                              sess.pipelined, hp, flats)
        else:
            out = _simulate(sess.cfg, sess.topo, sess.policy,
                            sess.pipelined, hp, flats, tracer=tracer)
        base = _sim_cached(sess.cfg, sess.topo, sess.policy, sess.pipelined,
                           hp, [flats[0]])
        speedup = base.latency_ns / out.latency_ns
        timing = HeTimingResult(
            towers=op.towers,
            banks=hp.banks,
            latency_ns=out.latency_ns,
            single_ns=base.latency_ns,
            speedup=speedup,
            efficiency=speedup / hp.banks,
            phase_ns=dict(out.phase_ns),
            tower_done_ns=out.tower_done_ns,
            xfer_atoms=out.dev_counters["xfer_atoms"],
            xfer_hops=out.dev_counters["xfer_hops"],
            param_hit_rate=out.param_hit_rate,
        )
        tel = TelemetryHandle(tracer) if tracer is not None else None
        return RunResult(op=op, value=value, timing=timing, stats=out.stats,
                         trace=None, telemetry=tel)

    # -- service integration -------------------------------------------------
    def job(self, plan: CompiledPlan) -> GangJob:
        hp: HePlan = plan.ext
        return GangJob(op=plan.op, banks=hp.banks, rows=hp.rows)

    def prime(self, plan: CompiledPlan, sched: RequestScheduler) -> None:
        hp: HePlan = plan.ext

        def resolver(flats):
            out = _sim_cached(sched.cfg, sched.topo, sched.policy,
                              sched.pipelined, hp, flats)
            return (out.latency_ns, out.bank_counters, dict(out.bus_busy),
                    dict(out.dev_counters))

        sched.prime_gang(self.job(plan), resolver)


def _require(inputs, k: int, what: str) -> None:
    if len(inputs) != k:
        raise ValueError(f"{what} takes {k} input(s), got {len(inputs)}")


def _ksk(basis: rns.RnsBasis, ksk) -> rns.KeySwitchKey:
    if not isinstance(ksk, rns.KeySwitchKey):
        raise TypeError(f"expected a KeySwitchKey, got {type(ksk).__name__}")
    if ksk.basis is not basis:
        raise ValueError("keyswitch key was generated under a different basis")
    return ksk


_HANDLER = HeOpHandler()
for _cls in HE_OPS:
    register_op_handler(_cls, _HANDLER)
