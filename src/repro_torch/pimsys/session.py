"""Unified compile/execute device API: `PimSession` (the tentpole layer).

The paper's row-centric mapping owes its efficiency to *precomputation*:
the memory controller derives each CU op's (w0, r_w) twiddle-parameter
stream once and replays it (§IV-A).  The repo historically re-derived
those streams on every call and exposed the device through six
uncoordinated entry points (`pim_polymul`, `pim_ntt_sharded`,
`simulate_ntt`, `simulate_multibank`, `simulate_ntt_sharded`,
`polymul_batch`).  This module makes compile-once/run-many the default
execution model:

    sess = PimSession(PimConfig(num_buffers=4, num_channels=2, num_banks=4))
    plan = sess.compile(PolymulOp(1024))        # frozen, reusable artifact
    r    = sess.run(plan, a, b)                 # functional + timed
    r.value, r.timing, r.stats, r.trace         # one unified result type
    sess.service().submit_poisson(plan, 64, 0.1)  # queued / open-loop futures

Three layers:

  * **op specs** — declarative, hashable descriptions of device work:
    `NttOp`, `InverseNttOp`, `PolymulOp`, `ShardedNttOp`, and the batched
    variant `BatchOp(op, count)`.
  * **`compile(op) -> CompiledPlan`** — a frozen artifact holding the
    command list(s), row/bank placement, the precomputed twiddle-parameter
    stream (one table index per CU op, the functional content of the MC's
    (w0, r_w) programs), the device-side parameter-cache residency trace
    (`param_trace`, charged identically by `BankTimer`, the channel
    engine, and the analytic bus bound when
    `PimConfig.param_cache_entries > 0`), and for sharded ops the
    `ShardedNttPlan` exchange schedule.  Plans are memoized in a
    session-level cache keyed by `(cfg, op)`; a second `compile` of an
    equal op returns the SAME object and a repeated `run` performs zero
    mapper regeneration (`core.mapping.mapper_generations` counts, tests
    assert).
  * **`run(plan, *inputs) -> RunResult`** — one result type unifying the
    functional output, `TimingResult` / `ShardedTimingResult` /
    `MultiBankResult` / `SchedulerResult`, a `StatsRegistry` snapshot, and
    an optional `TraceHandle` onto the `pimsys.trace` record/replay path.
    `service()` returns the `repro_torch.pimsys.service.DeviceService` over
    this session — futures, QoS classes, admission control, batching;
    the deprecated `submit(plan, ...)` shims onto its default policy.

The legacy entry points remain available as thin shims over a session —
bit-identical in values, cycle counts, and command lists — and each emits
exactly one `DeprecationWarning` per call.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Mapping, Sequence

import numpy as np
import torch

from repro_torch.core import modmath as mm
from repro_torch.core import ntt as ntt_ref
from repro_torch.core.mapping import (
    Command,
    FunctionalBank,
    RowCentricMapper,
    cu_twiddle_indices,
)
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.pimsim import (
    BankTimer,
    MultiBankResult,
    TimingResult,
    analytic_multibank_bound,
)
from repro_torch.core.polymul import polymul_phases
from repro_torch.pimsys.controller import ChannelController
from repro_torch.pimsys.fastpath import evaluate_gang, lower_plan, phase_breakdown
from repro_torch.pimsys.scheduler import (
    NttJob,
    PolymulJob,
    RequestScheduler,
    SchedulerResult,
    ShardedNttJob,
)
from repro_torch.pimsys.sharded import ShardedNttPlan, ShardedTimingResult
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.telemetry import TelemetryHandle, Tracer
from repro_torch.pimsys.topology import DeviceTopology
from repro_torch.pimsys.trace import dump_trace, dumps_trace


# --------------------------------------------------------------------------
# Op specs — declarative, hashable device work descriptions
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NttOp:
    """One size-n negacyclic NTT on one bank.

    `forward=False` is the paper's orientation (GS butterflies, i.e. the
    inverse transform); `scale_n_inv` applies the host-side 1/N scaling
    on functional inverse runs, exactly as `core.mapping.pim_ntt` does.
    """

    n: int
    forward: bool = False
    scale_n_inv: bool = True


@dataclasses.dataclass(frozen=True)
class InverseNttOp:
    """Explicit-name alias for the inverse orientation.

    Compiles to the same plan-cache entry as `NttOp(n, forward=False)` —
    `compile(InverseNttOp(n)) is compile(NttOp(n))`.
    """

    n: int
    scale_n_inv: bool = True


@dataclasses.dataclass(frozen=True)
class PolymulOp:
    """One RLWE polynomial product: NTT(a), NTT(b), ⊙, INTT, scale."""

    n: int


@dataclasses.dataclass(frozen=True)
class ShardedNttOp:
    """ONE size-n NTT four-step-sharded over `banks` banks/channels.

    `placement` selects the sub-NTT -> bank map: "identity" (the
    channel-interleaved default) or "conflict"
    (`sharded.conflict_aware_flat_banks`: exchange partners on distinct
    channels at every stride).
    """

    n: int
    banks: int = 2
    forward: bool = False
    scale_n_inv: bool = True
    placement: str = "identity"


@dataclasses.dataclass(frozen=True)
class BatchOp:
    """`count` independent copies of `op` run bank-parallel.

    `BatchOp(NttOp(n), k)` reproduces the §VII multi-bank setting: k
    identical NTT streams contending on one channel's shared command bus
    (the `simulate_multibank` semantics, cross-checked against the
    analytic bus bound).  `BatchOp(PolymulOp(n), k)` is a closed-loop
    scheduler batch over the full topology (the `polymul_batch`
    semantics).
    """

    op: "Op"
    count: int


Op = NttOp | InverseNttOp | PolymulOp | ShardedNttOp | BatchOp


# --------------------------------------------------------------------------
# Op-handler registry — extension ops without session <-> subsystem cycles
# --------------------------------------------------------------------------


class OpHandler:
    """Compile/run protocol for an op family the session does not know.

    Subsystems (e.g. `repro_torch.he`) register a handler per op class; the
    session consults the registry before its builtin isinstance chains,
    so extension ops flow through the same memoized `compile`, the same
    `run` signature, the same `RunResult`, and the same service priming
    (`CompiledPlan.prime_scheduler`) as the builtins — without the
    session importing the subsystem.
    """

    def canonical(self, op):
        """Normalize spelling variants (default: identity)."""
        return op

    def compile(self, sess: "PimSession", op) -> "CompiledPlan":
        raise NotImplementedError

    def run(self, sess: "PimSession", plan: "CompiledPlan", inputs, *,
            ctx=None, single=None, time=True, backend="engine") -> "RunResult":
        raise NotImplementedError

    def job(self, plan: "CompiledPlan"):
        """The scheduler job spec the plan executes as."""
        raise TypeError(f"no scheduler job for {type(plan.op).__name__}")

    def prime(self, plan: "CompiledPlan", sched: RequestScheduler) -> None:
        """Prime the scheduler for queued dispatch of this plan."""
        sched.prime(plan.job(), plan.commands, param_trace=plan.param_trace)


_OP_HANDLERS: dict[type, OpHandler] = {}


def register_op_handler(op_cls: type, handler: OpHandler) -> None:
    """Register `handler` for every op of exact type `op_cls`."""
    _OP_HANDLERS[op_cls] = handler


def op_handler(op) -> OpHandler | None:
    """The registered handler for `op`'s type, or None (a builtin op)."""
    return _OP_HANDLERS.get(type(op))


def _canonical(op: Op) -> Op:
    """Normalize spelling variants so they share one plan-cache entry."""
    h = op_handler(op)
    if h is not None:
        return h.canonical(op)
    if isinstance(op, InverseNttOp):
        return NttOp(op.n, forward=False, scale_n_inv=op.scale_n_inv)
    if isinstance(op, BatchOp):
        inner = _canonical(op.op)
        if not isinstance(inner, (NttOp, PolymulOp)):
            raise TypeError(
                f"BatchOp batches NttOp/PolymulOp, not {type(op.op).__name__}; "
                "sharded work gang-schedules through submit() instead")
        if op.count < 1:
            raise ValueError("BatchOp.count must be >= 1")
        return BatchOp(inner, op.count)
    return op


# --------------------------------------------------------------------------
# Twiddle-parameter streams — the (w0, r_w) programs, precomputed
# --------------------------------------------------------------------------


def twiddle_param_stream(cfg: PimConfig, n: int,
                         commands: Sequence[Command]) -> tuple[tuple[int, ...], ...]:
    """Per-CU-op twiddle table indices, in issue order.

    The hardware streams (w0, r_w) generator parameters over the command
    bus per C1/C2/BUWord (§IV-A); functionally each such program is the
    set of global twiddle-table indices the op resolves.  Precomputing the
    stream once per `CompiledPlan` is the paper's amortization: `run()`
    replays it without touching the mapper.  `n` is the GLOBAL transform
    size (a sharded local stream resolves against the full table via its
    shifted bases, so the same function covers both).
    """
    out: list[tuple[int, ...]] = []
    for cmd in commands:
        idx = cu_twiddle_indices(cfg, n, cmd)
        if idx is not None:
            out.append(idx)
    return tuple(out)


# --------------------------------------------------------------------------
# Compiled plans and run results
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TraceHandle:
    """Lazy handle onto the `pimsys.trace` text record/replay path."""

    streams: Mapping[tuple[int, int], list[Command]]

    def dumps(self) -> str:
        return dumps_trace(self.streams)

    def dump(self, path) -> None:
        dump_trace(self.streams, path)


@dataclasses.dataclass(frozen=True)
class CompiledPlan:
    """Frozen, reusable execution artifact for one op under one config.

    Holds everything `run()` needs that does not depend on the input
    polynomials: the timed command list, per-phase functional streams,
    row/bank placement, the precomputed twiddle-parameter streams, and
    (sharded) the `ShardedNttPlan` with its exchange schedule.  Produced
    only by `PimSession.compile`, which memoizes by `(cfg, op)` — equal
    ops yield the identical object, so repeated runs regenerate nothing.
    """

    cfg: PimConfig
    op: Op
    commands: tuple[Command, ...]               # full timed stream ((); batch/sharded)
    phases: Mapping[str, tuple[Command, ...]]   # functional sub-streams by name
    placement: Mapping[str, object]             # row/bank placement decisions
    sharded_plan: ShardedNttPlan | None = None  # exchange schedule owner
    inner: "CompiledPlan | None" = None         # BatchOp: the replicated plan
    count: int = 1
    ext: object = dataclasses.field(            # handler-owned artifact
        default=None, repr=False, compare=False)
    _twiddle_cache: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)
    _param_trace_cache: tuple = dataclasses.field(
        default=("unset",), init=False, repr=False, compare=False)

    @property
    def twiddle_params(self) -> tuple:
        """Per-CU-op (w0, r_w) index streams — the parameter programs the
        MC replays per run.  Derived from the frozen command stream(s),
        materialized once per plan on first access (timing-only runs
        never pay for it) and cached thereafter."""
        if self._twiddle_cache is None:
            if self.inner is not None:
                val = self.inner.twiddle_params
            elif self.sharded_plan is not None:
                val = tuple(
                    twiddle_param_stream(self.cfg, self.op.n, s)
                    for s in self.sharded_plan.local_streams())
            else:
                val = twiddle_param_stream(self.cfg, self.op.n, self.commands)
            object.__setattr__(self, "_twiddle_cache", val)
        return self._twiddle_cache

    @property
    def param_trace(self):
        """Per-CU-op (bus_beats, hit/miss) residency trace of the
        device-side twiddle-parameter cache (`engine.param_beat_trace`),
        or None when `cfg.param_cache_entries == 0`.  Precomputed once
        per plan — `run()` replays it with zero regeneration — and
        charged identically by `BankTimer`, the channel engine, and the
        analytic bus bound."""
        cached = self._param_trace_cache
        if cached == ("unset",):
            from repro_torch.pimsys.engine import param_beat_trace

            if self.inner is not None:
                val = self.inner.param_trace
            elif self.sharded_plan is not None:
                # per-bank traces live on the sharded plan (used by its
                # simulate/analytic bound); surface them as a tuple
                val = tuple(self.sharded_plan.local_param_traces())
            else:
                val = param_beat_trace(self.cfg, self.op.n, self.commands)
            object.__setattr__(self, "_param_trace_cache", (val,))
            return val
        return cached[0]

    def job(self):
        """The `RequestScheduler` job spec this plan executes as."""
        op = self.op
        h = op_handler(op)
        if h is not None:
            return h.job(self)
        if isinstance(op, NttOp):
            return NttJob(op.n, forward=op.forward)
        if isinstance(op, PolymulOp):
            return PolymulJob(op.n)
        if isinstance(op, ShardedNttOp):
            return ShardedNttJob(op.n, banks=op.banks, forward=op.forward)
        raise TypeError(f"no scheduler job for {type(op).__name__}")

    def prime_scheduler(self, sched: RequestScheduler) -> None:
        """Prime `sched` so queued dispatch replays this frozen plan.

        Single-bank plans hand their command stream (and residency
        trace) to `RequestScheduler.prime`; sharded plans need nothing
        (the scheduler's sharded cache rebuilds from the job spec);
        handler ops delegate — gang ops prime their latency resolver.
        The ONE priming entry point `DeviceService.flush` calls.
        """
        h = op_handler(self.op)
        if h is not None:
            h.prime(self, sched)
            return
        job = self.job()
        if isinstance(job, ShardedNttJob):
            return
        sched.prime(job, self.commands, param_trace=self.param_trace)

    def trace_streams(self) -> dict[tuple[int, int], list[Command]] | None:
        """Statically placed command streams, or None when placement is
        dynamic (scheduler-routed batches have no layout to record)."""
        if self.sharded_plan is not None:
            return self.sharded_plan.trace_streams()
        if isinstance(self.op, BatchOp):
            if isinstance(self.op.op, NttOp):
                # the multibank path: `count` banks on one shared-bus channel
                return {(0, i): list(self.inner.commands) for i in range(self.count)}
            return None
        return {(0, 0): list(self.commands)}

    def param_trace_streams(self) -> dict[tuple[int, int], tuple] | None:
        """Cache-residency traces keyed like `trace_streams()` — exactly
        the mapping `pimsys.trace.replay_trace(param_traces=...)` takes
        to replay a cache-enabled recording bit-exactly.  None when the
        cache is disabled or the workload has no static placement."""
        if self.param_trace is None:
            return None
        if self.sharded_plan is not None:
            sp = self.sharded_plan
            traces = sp.local_param_traces()
            out = {}
            for b in range(sp.banks):
                addr = sp.topo.address_of(sp.flat_banks[b])
                out[(addr.channel, sp.topo.local_id(addr))] = traces[b]
            return out
        if isinstance(self.op, BatchOp):
            if isinstance(self.op.op, NttOp):
                return {(0, i): self.inner.param_trace for i in range(self.count)}
            return None
        return {(0, 0): self.param_trace}


@dataclasses.dataclass(frozen=True)
class RunResult:
    """One result type for every execution path.

    `value`  — functional output (None for timing-only runs): numpy
               uint32 for the simulator's ops, a uint32 tensor on the
               session's device for the HE ops (`repro_torch.he.ops`)
    `timing` — `TimingResult` (single bank), `ShardedTimingResult`,
               `MultiBankResult` (BatchOp of NTTs) or `SchedulerResult`
               (BatchOp of polymuls / `submit`); None when `time=False`
    `stats`  — device-level `StatsRegistry` snapshot for the run
    `trace`  — `TraceHandle` onto the command-level workload, when the
               workload is statically placed (scheduler runs place
               dynamically and carry no trace)
    `telemetry` — `telemetry.TelemetryHandle` onto the run's recorded
               timeline when the session's `PimConfig.telemetry` (or the
               service's `ServicePolicy.telemetry`) is on; None otherwise
    """

    op: Op
    value: np.ndarray | torch.Tensor | None
    timing: TimingResult | ShardedTimingResult | MultiBankResult | SchedulerResult | None
    stats: StatsRegistry | None
    trace: TraceHandle | None
    telemetry: TelemetryHandle | None = None


# --------------------------------------------------------------------------
# Deprecation shim support
# --------------------------------------------------------------------------


def _host_u32(x) -> np.ndarray:
    """An input polynomial as numpy uint32: the simulator's values are
    computed on the host, so a tensor (on any device) is copied there."""
    if isinstance(x, torch.Tensor):
        return mm.to_numpy_u32(x)
    return np.asarray(x, np.uint32)


def _trace(plan: CompiledPlan) -> TraceHandle | None:
    streams = plan.trace_streams()
    return TraceHandle(streams) if streams is not None else None


def warn_legacy(name: str, replacement: str) -> None:
    """Emit the single DeprecationWarning a legacy shim owes per call."""
    warnings.warn(
        f"{name} is a legacy shim; use repro_torch.pimsys.session.PimSession "
        f"({replacement}) to compile once and run many",
        DeprecationWarning,
        stacklevel=3,
    )


# --------------------------------------------------------------------------
# The session
# --------------------------------------------------------------------------


class PimSession:
    """Compile/execute façade over the whole `repro_torch.pimsys` stack.

    A session pins the device: `PimConfig`, `DeviceTopology`, arbitration
    `policy`, and the `pipelined` engine mode.  Everything derived from
    those — mapper command streams, twiddle-parameter streams, the
    one-bank baseline timing, scheduler command caches — is computed once
    and reused across `compile`/`run`/`submit` calls.

    `device` is where the HE ops compute their values (`repro_torch.he`'s
    convention: a tensor input stays on its device, a numpy input goes to
    `device`, by default the card; asking for the card where there is none
    raises).  The simulator's own values (`NttOp`, `PolymulOp`,
    `ShardedNttOp`) and every timing stay on the host, in numpy and python
    floats.
    """

    def __init__(self, cfg: PimConfig | None = None,
                 topo: DeviceTopology | None = None,
                 policy: str = "rr", pipelined: bool = True,
                 device=None):
        if cfg is not None and not isinstance(cfg, PimConfig):
            raise TypeError(f"expected repro_torch's PimConfig, got "
                            f"{type(cfg).__module__}.{type(cfg).__name__}")
        if topo is not None and not isinstance(topo, DeviceTopology):
            raise TypeError(f"expected repro_torch's DeviceTopology, got "
                            f"{type(topo).__module__}.{type(topo).__name__}")
        self.cfg = cfg or PimConfig()
        self.device = None if device is None else torch.device(device)
        self._explicit_topo = topo is not None
        self.topo = topo or DeviceTopology.from_config(self.cfg)
        self.policy = policy
        self.pipelined = pipelined
        self._plans: dict[tuple[PimConfig, Op], CompiledPlan] = {}
        self._lowered: dict[tuple[PimConfig, Op], object] = {}
        self.plan_hits = 0
        self.plan_misses = 0
        self._baselines: dict[tuple[int, bool], TimingResult] = {}
        self._contexts: dict[tuple[int, int], ntt_ref.NttContext] = {}
        self._sched: RequestScheduler | None = None
        self._service = None   # lazy default-policy DeviceService (service())
        self._shim_svc = None  # the submit()/run(BatchOp) shim's own service

    # -- shared caches -------------------------------------------------------
    def context(self, n: int, q: int = mm.DEFAULT_Q) -> ntt_ref.NttContext:
        """Session-cached `NttContext` (twiddle tables) for modulus q."""
        key = (q, n)
        ctx = self._contexts.get(key)
        if ctx is None:
            ctx = self._contexts[key] = ntt_ref.make_context(q, n)
        return ctx

    def baseline(self, n: int, forward: bool = False) -> TimingResult:
        """One-bank `BankTimer` reference timing, cached per (n, forward).

        This is the `single` baseline sharded/multibank speedups divide
        by; the session computes it once per size instead of once per
        sweep point.
        """
        key = (n, forward)
        hit = self._baselines.get(key)
        if hit is None:
            plan = self.compile(NttOp(n, forward=forward))
            hit = self._baselines[key] = BankTimer(
                self.cfg, pipelined=self.pipelined).simulate(
                    plan.commands, plan.param_trace)
        return hit

    # -- compile -------------------------------------------------------------
    def compile(self, op: Op) -> CompiledPlan:
        """Lower an op spec to a frozen `CompiledPlan`, memoized.

        The cache key is `(cfg, op)` after spelling normalization
        (`InverseNttOp(n)` and `NttOp(n)` share an entry); a hit returns
        the identical plan object.
        """
        op = _canonical(op)
        key = (self.cfg, op)
        plan = self._plans.get(key)
        if plan is not None:
            self.plan_hits += 1
            return plan
        self.plan_misses += 1
        plan = self._plans[key] = self._compile(op)
        return plan

    def _compile(self, op: Op) -> CompiledPlan:
        cfg = self.cfg
        h = op_handler(op)
        if h is not None:
            return h.compile(self, op)
        if isinstance(op, NttOp):
            cmds = tuple(RowCentricMapper(cfg, op.n, forward=op.forward).commands())
            return CompiledPlan(
                cfg=cfg, op=op, commands=cmds, phases={"ntt": cmds},
                placement={"base_row": 0,
                           "rows": max(1, op.n // cfg.row_words)},
            )
        if isinstance(op, PolymulOp):
            raw, row_b = polymul_phases(cfg, op.n)
            phases = {k: tuple(v) for k, v in raw.items()}
            cmds = tuple(c for p in phases.values() for c in p)
            return CompiledPlan(
                cfg=cfg, op=op, commands=cmds, phases=phases,
                placement={"row_a": 0, "row_b": row_b,
                           "rows": max(1, op.n // cfg.row_words)},
            )
        if isinstance(op, ShardedNttOp):
            sharded = ShardedNttPlan(
                cfg, op.n, op.banks, forward=op.forward,
                topo=self.topo if self._explicit_topo else None,
                placement=op.placement)
            locals_ = sharded.local_streams()
            return CompiledPlan(
                cfg=cfg, op=op, commands=(),
                phases={f"local:{b}": tuple(s) for b, s in enumerate(locals_)},
                placement={"flat_banks": sharded.flat_banks},
                sharded_plan=sharded,
            )
        if isinstance(op, BatchOp):
            inner = self.compile(op.op)
            return CompiledPlan(
                cfg=cfg, op=op, commands=inner.commands, phases=inner.phases,
                placement=inner.placement, inner=inner, count=op.count,
            )
        raise TypeError(f"cannot compile {op!r}")

    # -- run -----------------------------------------------------------------
    def run(self, plan: CompiledPlan | Op, *inputs: np.ndarray,
            ctx: ntt_ref.NttContext | None = None,
            single: TimingResult | None = None,
            time: bool = True, backend: str = "engine") -> RunResult:
        """Execute a compiled plan: functional when `*inputs` are given,
        timed unless `time=False`, both by default.

        `ctx` overrides the session's cached `NttContext` (needed for a
        non-default modulus); `single` overrides the cached one-bank
        baseline that `ShardedNttOp` / `BatchOp(NttOp)` speedups
        reference (meaningless — and ignored — for the other ops).
        `backend="fastpath"` times `NttOp` / `PolymulOp` /
        `BatchOp(NttOp)` through the compiled vectorized evaluator
        (`repro_torch.pimsys.fastpath`) — bit-identical numbers without the
        interpreted per-command event loop.  Sharded ops, queued
        `BatchOp(PolymulOp)` traffic, and telemetry runs stay on the
        interpreted engine.
        """
        if backend not in ("engine", "fastpath"):
            raise ValueError(f"unknown backend {backend!r}; "
                             "expected 'engine' or 'fastpath'")
        if backend == "fastpath" and self.cfg.telemetry:
            raise ValueError(
                "backend='fastpath' records no per-command telemetry; "
                "disable cfg.telemetry or use backend='engine'")
        if not isinstance(plan, CompiledPlan):
            plan = self.compile(plan)
        if plan.cfg != self.cfg:
            raise ValueError("plan was compiled for a different PimConfig")
        op = plan.op
        h = op_handler(op)
        if h is not None:
            return h.run(self, plan, inputs, ctx=ctx, single=single,
                         time=time, backend=backend)
        if isinstance(op, NttOp):
            return self._run_ntt(plan, inputs, ctx, time, backend)
        if isinstance(op, PolymulOp):
            return self._run_polymul(plan, inputs, ctx, time, backend)
        if isinstance(op, ShardedNttOp):
            if backend == "fastpath":
                raise ValueError(
                    "backend='fastpath' does not support sharded plans: "
                    "the cross-bank exchange phase needs the interpreted "
                    "engine's per-command bus model; run ShardedNttOp "
                    "with backend='engine'")
            return self._run_sharded(plan, inputs, ctx, single, time)
        if isinstance(op, BatchOp):
            if inputs:
                raise ValueError("BatchOp runs are timing-only; run the "
                                 "inner plan for functional output")
            if not time:  # plan-validation only: skip the device simulation
                return RunResult(op=op, value=None, timing=None, stats=None,
                                 trace=_trace(plan))
            if isinstance(op.op, NttOp):
                return self._run_multibank(plan, single, backend)
            if backend == "fastpath":
                raise ValueError("backend='fastpath' cannot drive queued "
                                 "BatchOp(PolymulOp) traffic; use "
                                 "ServicePolicy(backend='fastpath') on the "
                                 "serving path instead")
            return self._submit(plan)
        raise TypeError(f"cannot run {op!r}")

    def _require(self, inputs, k: int, what: str):
        if len(inputs) != k:
            raise ValueError(f"{what} takes {k} input polynomial(s), got {len(inputs)}")

    def _ctx_for(self, n: int, ctx: ntt_ref.NttContext | None) -> ntt_ref.NttContext:
        ctx = ctx or self.context(n)
        if ctx.n != n:
            raise ValueError(f"context is for n={ctx.n}, op is n={n}")
        return ctx

    def _tracer(self) -> Tracer | None:
        """A fresh per-run `Tracer` when `cfg.telemetry` is on."""
        return Tracer() if self.cfg.telemetry else None

    def _lowered_for(self, plan: CompiledPlan):
        """Session-cached `LoweredPlan` for a compiled plan (keyed like
        the plan cache, so repeated fastpath runs lower zero commands)."""
        inner = plan.inner if plan.inner is not None else plan
        key = (self.cfg, inner.op)
        lp = self._lowered.get(key)
        if lp is None:
            lp = self._lowered[key] = lower_plan(self.cfg, inner)
        return lp

    def _fast_timing(self, plan: CompiledPlan) -> TimingResult:
        """One-bank fastpath timing, bit-identical to `BankTimer`."""
        lp = self._lowered_for(plan)
        g = evaluate_gang(lp, 1, pipelined=self.pipelined)
        return TimingResult(ns=float(g.bank_end_ns[0]),
                            stats=dict(g.counters[0]),
                            phase_ns=phase_breakdown(lp, g.dones[:, 0]))

    def _single_bank_result(self, op, value, timing, plan,
                            tracer: Tracer | None = None) -> RunResult:
        stats = None
        if timing is not None:
            stats = StatsRegistry()
            stats.add_bank(0, 0, dict(timing.stats))
        tel = TelemetryHandle(tracer) if tracer is not None else None
        return RunResult(op=op, value=value, timing=timing, stats=stats,
                         trace=_trace(plan), telemetry=tel)

    def _run_ntt(self, plan, inputs, ctx, time, backend="engine") -> RunResult:
        op, cfg = plan.op, self.cfg
        value = None
        if inputs:
            self._require(inputs, 1, "NttOp")
            a = _host_u32(inputs[0])
            if a.shape[0] != op.n:
                raise ValueError(f"input length {a.shape[0]} != n={op.n}")
            if op.n < cfg.atom_words:
                raise ValueError("n must be at least one atom")
            ctx = self._ctx_for(op.n, ctx)
            bank = FunctionalBank(cfg, ctx, forward=op.forward)
            bank.load_poly(a)
            bank.run(plan.commands)
            value = bank.read_poly(op.n)
            if not op.forward and op.scale_n_inv:
                value = np.asarray(mm.np_mulmod(value, ctx.n_inv, ctx.q), np.uint32)
        timing = None
        tracer = None
        if time:
            if backend == "fastpath":
                timing = self._fast_timing(plan)
            else:
                tracer = self._tracer()
                timing = BankTimer(cfg, pipelined=self.pipelined).simulate(
                    plan.commands, plan.param_trace, tracer=tracer)
        return self._single_bank_result(op, value, timing, plan, tracer)

    def _run_polymul(self, plan, inputs, ctx, time,
                     backend="engine") -> RunResult:
        op, cfg = plan.op, self.cfg
        value = None
        if inputs:
            self._require(inputs, 2, "PolymulOp")
            a = _host_u32(inputs[0])
            b = _host_u32(inputs[1])
            if a.shape[0] != op.n or b.shape[0] != op.n:
                raise ValueError(
                    f"input lengths ({a.shape[0]}, {b.shape[0]}) != n={op.n}")
            ctx = self._ctx_for(op.n, ctx)
            row_b = plan.placement["row_b"]
            # phase-wise functional execution: the FunctionalBank resolves
            # twiddles by direction (same discipline as legacy pim_polymul)
            bank_f = FunctionalBank(cfg, ctx, forward=True)
            bank_f.load_poly(a, base_row=0)
            bank_f.load_poly(b, base_row=row_b)
            bank_f.run(plan.phases["fwd_a"])
            bank_f.run(plan.phases["fwd_b"])
            bank_f.run(plan.phases["pointwise"])
            bank_i = FunctionalBank(cfg, ctx, forward=False)
            bank_i.mem = bank_f.mem  # share the memory image
            bank_i.run(plan.phases["inv_a"])
            value = bank_i.read_poly(op.n)
            value = np.asarray(mm.np_mulmod(value, ctx.n_inv, ctx.q), np.uint32)
        timing = None
        tracer = None
        if time:
            if backend == "fastpath":
                timing = self._fast_timing(plan)
            else:
                tracer = self._tracer()
                timing = BankTimer(cfg, pipelined=self.pipelined).simulate(
                    plan.commands, plan.param_trace, tracer=tracer)
        return self._single_bank_result(op, value, timing, plan, tracer)

    def _run_sharded(self, plan, inputs, ctx, single, time) -> RunResult:
        op = plan.op
        sharded = plan.sharded_plan
        value = None
        if inputs:
            self._require(inputs, 1, "ShardedNttOp")
            a = _host_u32(inputs[0])
            ctx = self._ctx_for(op.n, ctx)
            value = sharded.run_functional(a, ctx)
            if not op.forward and op.scale_n_inv:
                value = np.asarray(mm.np_mulmod(value, ctx.n_inv, ctx.q), np.uint32)
        timing = None
        stats = None
        tracer = None
        if time:
            tracer = self._tracer()
            timing = sharded.simulate(
                policy=self.policy,
                single=single or self.baseline(op.n, op.forward),
                pipelined=self.pipelined, tracer=tracer)
            stats = timing.stats
        return RunResult(op=op, value=value, timing=timing, stats=stats,
                         trace=_trace(plan),
                         telemetry=(TelemetryHandle(tracer)
                                    if tracer is not None else None))

    def _run_multibank(self, plan, single, backend="engine") -> RunResult:
        """`count` identical NTT streams on one shared-bus channel — the
        §VII multi-bank experiment, cross-checked against the analytic
        bus bound (bit-identical to legacy `simulate_multibank`).

        With `backend="fastpath"` the gang is timed by the vectorized
        evaluator instead of the interpreted `ChannelController` —
        same makespan, bus occupancy, and per-bank counters to the bit
        (rr arbitration only; telemetry already rejected in `run`)."""
        op: BatchOp = plan.op
        inner: NttOp = op.op
        cfg, banks = self.cfg, op.count
        single = single or self.baseline(inner.n, inner.forward)
        trace = plan.param_trace  # one device-side cache per bank, same stream
        if backend == "fastpath":
            return self._run_multibank_fast(plan, single, banks, trace)
        tracer = self._tracer()
        ctrl = ChannelController(cfg, policy=self.policy, tracer=tracer)
        for i in range(banks):
            ctrl.enqueue(ctrl.add_bank(pipelined=self.pipelined),
                         plan.inner.commands, job_id=i, param_trace=trace)
        ctrl.drain()
        latency = ctrl.makespan_ns
        analytic = analytic_multibank_bound(inner.n, banks, cfg, single,
                                            param_trace=trace)
        if latency < analytic - 1e-6:  # not an assert: must survive python -O
            raise RuntimeError(
                f"controller beat the analytic bus bound: {latency} < {analytic}")
        speedup = banks * single.ns / latency
        if tracer is not None:
            tracer.meta.setdefault("dram_ns", cfg.dram_ns)
        stats = StatsRegistry(channels=1)
        ctrl.record_stats(stats)
        timing = MultiBankResult(
            banks=banks,
            latency_ns=latency,
            speedup=speedup,
            efficiency=speedup / banks,
            bus_utilization=min(1.0, ctrl.bus_busy_ns / latency),
            analytic_latency_ns=analytic,
            policy=self.policy,
            param_hit_rate=stats.param_hit_rate(),
        )
        return RunResult(op=op, value=None, timing=timing, stats=stats,
                         trace=_trace(plan),
                         telemetry=(TelemetryHandle(tracer)
                                    if tracer is not None else None))

    def _run_multibank_fast(self, plan, single, banks, trace) -> RunResult:
        if self.policy != "rr":
            raise ValueError(
                f"backend='fastpath' models round-robin arbitration only; "
                f"policy={self.policy!r} needs backend='engine'")
        cfg = self.cfg
        inner: NttOp = plan.op.op
        lp = self._lowered_for(plan)
        g = evaluate_gang(lp, banks, pipelined=self.pipelined)
        latency = g.makespan_ns
        analytic = analytic_multibank_bound(inner.n, banks, cfg, single,
                                            param_trace=trace)
        if latency < analytic - 1e-6:
            raise RuntimeError(
                f"fastpath beat the analytic bus bound: {latency} < {analytic}")
        speedup = banks * single.ns / latency
        stats = StatsRegistry(channels=1)
        for b in range(banks):
            stats.add_bank(0, b, dict(g.counters[b]))
        stats.add_bus(0, g.bus_busy_ns, latency)
        timing = MultiBankResult(
            banks=banks,
            latency_ns=latency,
            speedup=speedup,
            efficiency=speedup / banks,
            bus_utilization=min(1.0, g.bus_busy_ns / latency),
            analytic_latency_ns=analytic,
            policy=self.policy,
            param_hit_rate=stats.param_hit_rate(),
        )
        return RunResult(op=plan.op, value=None, timing=timing, stats=stats,
                         trace=_trace(plan))

    # -- submit: queued / open-loop traffic through the device service -------
    def scheduler(self) -> RequestScheduler:
        """The session's persistent `RequestScheduler` (lazy).

        Persisting it lets the scheduler's command and sharded-gang
        caches compound across `submit` calls; results are unaffected
        (every run simulates on a fresh `Device`)."""
        if self._sched is None:
            self._sched = RequestScheduler(self.cfg, self.topo,
                                           policy=self.policy,
                                           pipelined=self.pipelined)
        return self._sched

    def service(self, policy=None):
        """A `DeviceService` over this session — the async serving API.

        With `policy=None` returns the session's persistent
        default-policy service (FIFO-equivalent dispatch, the parity
        anchor `submit()` shims onto); pass a `ServicePolicy` for a
        dedicated service with QoS weights, admission control, or
        batching."""
        from repro_torch.pimsys.service import DeviceService

        if policy is not None:
            return DeviceService(self, policy=policy)
        if self._service is None:
            self._service = DeviceService(self)
        return self._service

    def submit(self, plan: CompiledPlan | Op, count: int = 1, *,
               rate_per_us: float | None = None, seed: int = 0) -> RunResult:
        """Deprecated shim: route `count` copies of a plan through the
        default-policy `DeviceService` (closed loop by default,
        `rate_per_us` for open-loop Poisson arrivals) — bit-identical
        to the pre-service FIFO scheduler path.  Use
        `session.service().submit(...)` / `submit_poisson(...)` for
        futures, QoS classes, admission control, and batching.
        """
        warn_legacy("PimSession.submit",
                    "service().submit / submit_poisson for futures and QoS")
        return self._submit(plan, count, rate_per_us=rate_per_us, seed=seed)

    def _submit(self, plan: CompiledPlan | Op, count: int = 1, *,
                rate_per_us: float | None = None, seed: int = 0,
                qos: str = "throughput",
                deadline_us: float | None = None) -> RunResult:
        """Warning-free service submission (the shim's body; also the
        internal path for `run(BatchOp(PolymulOp, k))` and the legacy
        entry-point shims)."""
        if not isinstance(plan, CompiledPlan):
            plan = self.compile(plan)
        if plan.cfg != self.cfg:
            raise ValueError("plan was compiled for a different PimConfig")
        if isinstance(plan.op, BatchOp):
            return dataclasses.replace(
                self._submit(plan.inner, count=count * plan.count,
                             rate_per_us=rate_per_us, seed=seed, qos=qos,
                             deadline_us=deadline_us),
                op=plan.op)
        if count < 1:  # legacy parity: an empty batch is a valid empty run
            res = self.scheduler().run_service([], seed=seed)
            return RunResult(op=plan.op, value=None, timing=res,
                             stats=res.stats, trace=None)
        # a dedicated service: the shim must not disturb (or trip over)
        # pending futures on the user-facing service() singleton
        if self._shim_svc is None:
            from repro_torch.pimsys.service import DeviceService

            self._shim_svc = DeviceService(self)
        svc = self._shim_svc
        if rate_per_us is None:
            for _ in range(count):
                svc.submit(plan, qos=qos, deadline_us=deadline_us)
        else:
            svc.submit_poisson(plan, count, rate_per_us, qos=qos,
                               deadline_us=deadline_us, seed=seed)
        # retain=False: the shim hands the result straight back, so the
        # internal service must not accumulate epoch history
        res = svc.flush(retain=False)
        return RunResult(op=plan.op, value=None, timing=res, stats=res.stats,
                         trace=None, telemetry=res.telemetry)
