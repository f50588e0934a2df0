"""Request queue + batch scheduler for the PIM device.

Accepts `NttJob` / `PolymulJob` requests, places each on a free bank
(earliest-free bank first, which channel-interleaves via the topology's
flat-id order), and injects them either

  closed-loop  a fixed batch all present at t=0 (the paper's §VI-A
               "multiple NTT functions using multiple banks" setting), or
  open-loop    Poisson arrivals at a given rate (the serving regime the
               ROADMAP's north star asks about),

then reports per-request latency percentiles and device throughput.
A bank serves one job at a time; jobs that find no free bank wait in a
FIFO request queue.  Placement is greedy over known bank-release times:
before dispatching, the controller is advanced up to the k-th best
known release (the horizon past which further progress cannot improve
this dispatch), so a bank completing sooner than a parked reservation
is always preferred — but dispatch never peeks past that horizon at
completions that could not matter.

`ShardedNttJob` coexists in the same FIFO: it gang-reserves `banks`
banks (waiting at the head until that many are free) and runs the
four-step sharded plan of `repro_torch.pimsys.sharded` on them; see its
docstring for the reservation approximation.  Gang specs are validated
(shard size, bank count, topology fit) before any simulation starts.

Service dispatch (`run_service`, the `repro_torch.pimsys.service` substrate)
--------------------------------------------------------------------
The FIFO loop above is the legacy reference.  `run_service` is the
policy-driven dispatcher underneath `DeviceService`: it takes explicit
`ServiceRequest`s (arrival, job, QoS class, optional deadline) and a
`ServicePolicy`, and adds

  * QoS classes with weighted priority aging — a request's priority is
    `weight(class) * (now - arrival)`, so a `latency`-class request
    overtakes queued `throughput` work but an aging throughput request
    eventually wins (no starvation).  With equal weights the order
    degenerates to arrival order: `ServicePolicy()` (the default) is
    bit-identical to the FIFO loop on the same arrival trace
    (`tests/test_service.py` asserts arrays and stats exactly).
  * admission control — a bound on queued-but-undispatched requests
    (`max_queue_depth`) plus a token-bucket rate limiter
    (`bucket_rate_per_us` / `bucket_burst`).  Rejected requests never
    touch the device; they are reported per class and reason in
    `SchedulerResult.rejected_by` and in `StatsRegistry.service_counts`.
  * dynamic batching — `throughput`-class single-bank requests with the
    SAME job spec that are waiting together (or arrive within
    `batch_window_us` of the issue) coalesce, up to `max_batch`, into
    one gang issue on one bank: every member's frozen command stream is
    enqueued back-to-back at one shared gate, so the pipelined bank
    engine overlaps the seams and — with the device-side parameter
    cache on — members after the first replay a WARM residency trace
    (`_batch_traces`).  Zero mapper regeneration either way; the bank
    rejoins the free pool when its last member completes.
    `latency`-class requests are never batched and never delayed.
  * deadline/SLO accounting — per-request deadlines resolve to
    attainment and per-class latency percentiles on `SchedulerResult`.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from collections import deque
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.mapping import Command, RowCentricMapper
from repro_torch.core.pim_config import PimConfig
from repro_torch.core.polymul import polymul_commands
from repro_torch.pimsys.controller import Device
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.telemetry import TelemetryHandle, Tracer, WindowedSeries, device_series
from repro_torch.pimsys.topology import DeviceTopology


# --------------------------------------------------------------------------
# Requests
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NttJob:
    """One size-n NTT (inverse by default, the paper's orientation)."""

    n: int
    forward: bool = False


@dataclasses.dataclass(frozen=True)
class PolymulJob:
    """One RLWE polynomial product: NTT(a), NTT(b), ⊙, INTT, scale."""

    n: int


@dataclasses.dataclass(frozen=True)
class ShardedNttJob:
    """ONE size-n NTT gang-scheduled over `banks` banks at once.

    Dispatched when `banks` banks are free (FIFO order is preserved, so
    a gang job at the head waits — classic head-of-line gang blocking —
    while single-bank jobs behind it keep their arrival order).  The
    reserved gang runs the four-step sharded plan of
    `repro_torch.pimsys.sharded` on the banks it was placed on; during the
    reservation the gang's channels are modeled as dedicated to it (a
    sharded job's bus traffic does not interleave with concurrent
    single-bank jobs' — the reservation approximation, noted here
    because it slightly favors the gang under mixed load).
    """

    n: int
    banks: int = 2
    forward: bool = False


@dataclasses.dataclass(frozen=True)
class GangJob:
    """A generic gang-scheduled job: `banks` banks reserved at once.

    The scheduler knows nothing about what runs inside the reservation —
    the owning compiled plan primes a *resolver* (`prime_gang`) that,
    given the reserved flat banks, returns the gang's latency and stats
    in the same shape `ShardedNttJob` uses.  `op` is the hashable op
    spec the plan compiled (the cache identity); `rows` the per-bank
    working-set bound validated against `rows_per_bank`.  The
    reservation approximation of `ShardedNttJob` applies: the gang's
    bus traffic runs on a dedicated sub-device timeline.  HE ciphertext
    ops (`repro_torch.he`) dispatch through this.
    """

    op: object
    banks: int = 1
    rows: int = 1


Job = NttJob | PolymulJob | ShardedNttJob | GangJob

#: jobs that gang-reserve `job.banks` banks per dispatch
GANG_JOBS = (ShardedNttJob, GangJob)


def job_commands(cfg: PimConfig, job: Job) -> list[Command]:
    if isinstance(job, NttJob):
        return RowCentricMapper(cfg, job.n, forward=job.forward).commands()
    if isinstance(job, PolymulJob):
        return polymul_commands(cfg, job.n)[0]
    if isinstance(job, ShardedNttJob):
        raise TypeError(
            "ShardedNttJob spans banks and has no single-bank command "
            "stream; use ShardedNttPlan(...).local_streams() instead")
    if isinstance(job, GangJob):
        raise TypeError(
            f"{job} spans banks and has no single-bank command stream; "
            "gang jobs resolve through their primed resolver")
    raise TypeError(job)


def job_rows(cfg: PimConfig, job: Job) -> int:
    """Rows of bank storage the job's working set occupies (per bank)."""
    if isinstance(job, ShardedNttJob):
        return max(1, (job.n // job.banks) // cfg.row_words)
    if isinstance(job, GangJob):
        return job.rows
    rows = max(1, job.n // cfg.row_words)
    return rows if isinstance(job, NttJob) else 2 * rows  # polymul holds a AND b


def poisson_arrivals_ns(seed: int, count: int, rate_per_us: float) -> np.ndarray:
    """Arrival times (ns) of `count` Poisson arrivals at `rate_per_us`.

    THE arrival-trace formula: `run_open_loop` and the service's
    `submit_poisson` both call it, so the two paths stay bit-identical
    on the same seed by construction.
    """
    if rate_per_us <= 0:
        raise ValueError("rate_per_us must be positive")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1e3 / rate_per_us, size=count))


# --------------------------------------------------------------------------
# Service policy: QoS classes, admission control, batching
# --------------------------------------------------------------------------


QOS_CLASSES = ("latency", "throughput")

# request status codes (SchedulerResult.status)
STATUS_COMPLETED, STATUS_REJECTED = 1, 2


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """Dispatch policy of the service layer (`run_service`).

    The default instance is deliberately neutral — equal class weights,
    no admission limits, no batching — and is bit-identical to the
    legacy FIFO loop on any arrival trace.  Every knob departs from
    that anchor:

    weight_latency / weight_throughput
        Priority-aging weights: priority = weight * (now - arrival).
        Equal weights = arrival order (FIFO).
    max_queue_depth
        Admit a request only while fewer than this many admitted
        requests are queued undispatched; excess arrivals are rejected
        (reason ``queue_full``).  None = unbounded.
    bucket_rate_per_us / bucket_burst
        Token-bucket rate limiter refilled in simulated time; an
        arrival that finds no token is shed (reason ``rate_limited``).
        None = unlimited.
    batch_window_us / max_batch
        Plan-coalescing window: throughput-class single-bank requests
        with the same job spec gang-issue together (see module
        docstring).  0.0 disables batching.
    telemetry / telemetry_window_us
        Record the run's timeline (`repro_torch.pimsys.telemetry`): per-command
        device events, per-request lifecycle spans, admission-reject
        instants, and tumbling-window series (queue depth per class,
        rejects, bus/bank occupancy) at `telemetry_window_us` windows.
        The result then carries a `TelemetryHandle` and the stats
        registry a `timeseries` summary block.  Off by default — the
        dispatch loop and the device pay nothing.
    backend / verify_every
        ``backend="fastpath"`` times every single-bank dispatch (and
        every coalesced gang) through the compiled vectorized evaluator
        (`repro_torch.pimsys.fastpath`) instead of stepping the interpreted
        device command-by-command: each (job, gang-size) gets ONE
        dedicated-bank profile, evaluated once and replayed as O(1)
        per-dispatch arithmetic — what makes million-request sweeps
        tractable.  The model is the dedicated-gang timeline the
        sharded path already uses (no cross-dispatch bus contention or
        carried bank state), so absolute timestamps are a model of the
        interpreted backend's, not a bit-copy; each profile itself IS
        bit-identical to the interpreted engine, and `verify_every=K`
        makes every K-th fastpath dispatch prove that by replaying its
        profile stream through the interpreted oracle (cached per
        profile; `FastpathMismatch` on any divergence).  Incompatible
        with telemetry (the fastpath records no per-command events).
    """

    weight_latency: float = 1.0
    weight_throughput: float = 1.0
    max_queue_depth: int | None = None
    bucket_rate_per_us: float | None = None
    bucket_burst: int = 1
    batch_window_us: float = 0.0
    max_batch: int = 8
    telemetry: bool = False
    telemetry_window_us: float = 50.0
    backend: str = "engine"
    verify_every: int = 0

    def __post_init__(self):
        if self.backend not in ("engine", "fastpath"):
            raise ValueError(f"unknown backend {self.backend!r}; "
                             "expected 'engine' or 'fastpath'")
        if self.verify_every < 0:
            raise ValueError("verify_every must be >= 0")
        if self.backend == "fastpath" and self.telemetry:
            raise ValueError(
                "backend='fastpath' records no per-command telemetry; "
                "disable telemetry or use backend='engine'")
        if self.weight_latency <= 0 or self.weight_throughput <= 0:
            raise ValueError("QoS weights must be positive")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        if self.bucket_rate_per_us is not None and self.bucket_rate_per_us <= 0:
            raise ValueError("bucket_rate_per_us must be positive (or None)")
        if self.bucket_burst < 1:
            raise ValueError("bucket_burst must be >= 1")
        if self.batch_window_us < 0:
            raise ValueError("batch_window_us must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.telemetry_window_us <= 0:
            raise ValueError("telemetry_window_us must be positive")

    def weight(self, qos: str) -> float:
        return self.weight_latency if qos == "latency" else self.weight_throughput

    @property
    def batching(self) -> bool:
        return self.batch_window_us > 0.0 and self.max_batch > 1


DEFAULT_POLICY = ServicePolicy()


@dataclasses.dataclass(frozen=True)
class ServiceRequest:
    """One request entering the service dispatcher.

    `deadline_ns` is relative to `arrival_ns` (an SLO, not an absolute
    timestamp); None means no deadline.
    """

    arrival_ns: float
    job: Job
    qos: str = "throughput"
    deadline_ns: float | None = None

    def __post_init__(self):
        if self.qos not in QOS_CLASSES:
            raise ValueError(f"qos must be one of {QOS_CLASSES}, got {self.qos!r}")
        if self.deadline_ns is not None and self.deadline_ns <= 0:
            raise ValueError("deadline_ns must be positive (or None)")
        if self.arrival_ns < 0:
            raise ValueError("arrival_ns must be >= 0")


class _TokenBucket:
    """Token-bucket rate limiter over simulated time."""

    __slots__ = ("rate_per_ns", "burst", "tokens", "t")

    def __init__(self, rate_per_us: float, burst: int):
        self.rate_per_ns = rate_per_us / 1e3
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t = 0.0

    def take(self, now: float) -> bool:
        tokens = self.tokens + (now - self.t) * self.rate_per_ns
        if tokens > self.burst:
            tokens = self.burst
        self.t = now
        if tokens >= 1.0:
            self.tokens = tokens - 1.0
            return True
        self.tokens = tokens
        return False


class _Waiting:
    """An admitted, not-yet-dispatched request."""

    __slots__ = ("arrival", "seq", "job", "qos", "deadline")

    def __init__(self, arrival, seq, job, qos, deadline):
        self.arrival = arrival
        self.seq = seq
        self.job = job
        self.qos = qos
        self.deadline = deadline


class _Batch:
    """Bank-release bookkeeping for one coalesced gang issue."""

    __slots__ = ("remaining", "flat", "max_done")

    def __init__(self, remaining: int, flat: int):
        self.remaining = remaining
        self.flat = flat
        self.max_done = 0.0


class _FastProfile:
    """Dedicated-bank timing profile of one (job, gang size) under
    `ServicePolicy(backend="fastpath")`: evaluated once by the
    vectorized fastpath, replayed per dispatch as gate + offsets."""

    __slots__ = ("member_done", "release", "counters", "bus_busy")

    def __init__(self, member_done, release, counters, bus_busy):
        self.member_done = member_done  # per-member completion offset
        self.release = release          # bank release offset (max done)
        self.counters = counters        # whole-gang bank counters
        self.bus_busy = bus_busy        # whole-gang bus occupancy (ns)


# --------------------------------------------------------------------------
# Results
# --------------------------------------------------------------------------


@dataclasses.dataclass
class SchedulerResult:
    """Aggregate result of one scheduler run.

    Rows are in DISPATCH-DECISION order (identical to arrival order for
    the FIFO loop).  The service-dispatch fields default to None/empty
    on legacy FIFO runs: `qos` (class per row), `deadline_ns` (relative
    SLO, NaN = none), `status` (STATUS_COMPLETED / STATUS_REJECTED),
    `batched` (row rode a coalesced gang), `request_ids` (submission
    index per row, the futures' join key), `rejected_by` ((qos, reason)
    -> count), `batches`/`coalesced` (gang issues and member count),
    and `seed` (the arrival-trace RNG seed, for reproducibility).
    """

    submitted: int
    completed: int
    makespan_ns: float
    arrivals_ns: np.ndarray
    dispatch_ns: np.ndarray
    done_ns: np.ndarray
    stats: StatsRegistry
    qos: list[str] | None = None
    deadline_ns: np.ndarray | None = None
    status: np.ndarray | None = None
    batched: np.ndarray | None = None
    request_ids: np.ndarray | None = None
    rejected_by: dict = dataclasses.field(default_factory=dict)
    batches: int = 0
    coalesced: int = 0
    seed: int | list | None = None
    telemetry: TelemetryHandle | None = None

    @property
    def latency_ns(self) -> np.ndarray:
        return self.done_ns - self.arrivals_ns

    @property
    def queue_delay_ns(self) -> np.ndarray:
        return self.dispatch_ns - self.arrivals_ns

    @property
    def rejected(self) -> int:
        return sum(self.rejected_by.values())

    def _mask(self, qos: str | None = None) -> np.ndarray:
        """Completed rows, optionally restricted to one QoS class."""
        if self.status is None:
            m = np.ones(self.submitted, dtype=bool)
        else:
            m = self.status == STATUS_COMPLETED
        if qos is not None:
            if self.qos is None:
                raise ValueError("this result carries no QoS classes")
            m = m & np.array([c == qos for c in self.qos])
        return m

    def class_latency_ns(self, qos: str | None = None) -> np.ndarray:
        """Latencies of completed requests (one class, or all)."""
        return self.latency_ns[self._mask(qos)]

    def latency_percentiles_us(self, qs: Sequence[float] = (50, 95, 99),
                               qos: str | None = None) -> dict:
        lat = self.class_latency_ns(qos)
        if lat.size == 0:
            return {f"p{int(q)}": 0.0 for q in qs}
        lat = lat / 1e3
        return {f"p{int(q)}": float(np.percentile(lat, q)) for q in qs}

    def deadline_attainment(self, qos: str | None = None) -> float:
        """Fraction of completed deadline-carrying requests that met
        their deadline; 1.0 when no completed request carries one."""
        if self.deadline_ns is None:
            return 1.0
        m = self._mask(qos) & np.isfinite(self.deadline_ns)
        if not m.any():
            return 1.0
        return float((self.latency_ns[m] <= self.deadline_ns[m]).mean())

    @property
    def throughput_jobs_per_ms(self) -> float:
        if self.makespan_ns <= 0:
            return 0.0
        return self.completed / (self.makespan_ns / 1e6)

    def windowed_deadline_attainment(
            self, window_us: float, qos: str | None = None,
    ) -> list[list[float]]:
        """Deadline attainment over tumbling completion-time windows:
        `[[window_start_us, attained_fraction], ...]` over completed
        deadline-carrying requests (one class, or all).  Computed from
        the result arrays, so it needs no telemetry recording — the
        per-class SLO timeline `examples/serve_polymul.py` prints.
        """
        if self.deadline_ns is None:
            return []
        m = self._mask(qos) & np.isfinite(self.deadline_ns)
        if not m.any():
            return []
        series = WindowedSeries(window_us * 1e3, "mean")
        met = self.latency_ns[m] <= self.deadline_ns[m]
        for t, ok in zip(self.done_ns[m], met):
            series.record(float(t), 1.0 if ok else 0.0)
        return series.points_us()

    def class_throughput_jobs_per_ms(self, qos: str) -> float:
        if self.makespan_ns <= 0:
            return 0.0
        return int(self._mask(qos).sum()) / (self.makespan_ns / 1e6)

    def summary(self, window_us: float | None = None) -> dict:
        """Flat report dict.  With `window_us`, per-class blocks gain
        `deadline_attainment_windows` — the tumbling-window SLO timeline
        of `windowed_deadline_attainment` (array-derived, available with
        telemetry off)."""
        out = {
            "submitted": self.submitted,
            "completed": self.completed,
            "makespan_us": self.makespan_ns / 1e3,
            "throughput_jobs_per_ms": self.throughput_jobs_per_ms,
            "mean_queue_delay_us": (
                float(self.queue_delay_ns[self._mask()].mean() / 1e3)
                if self.completed else 0.0),
            "seed": self.seed,
        }
        out.update(self.latency_percentiles_us())
        if self.qos is not None:
            out["rejected"] = self.rejected
            out["batches"] = self.batches
            out["coalesced"] = self.coalesced
            per_class = {}
            for cls in QOS_CLASSES:
                n_cls = sum(1 for c in self.qos if c == cls)
                if not n_cls:
                    continue
                block = {
                    "submitted": n_cls,
                    "completed": int(self._mask(cls).sum()),
                    "rejected": sum(v for (c, _), v in self.rejected_by.items()
                                    if c == cls),
                    "throughput_jobs_per_ms":
                        self.class_throughput_jobs_per_ms(cls),
                    "deadline_attainment": self.deadline_attainment(cls),
                }
                if window_us is not None:
                    block["deadline_attainment_windows"] = \
                        self.windowed_deadline_attainment(window_us, cls)
                block.update(self.latency_percentiles_us(qos=cls))
                per_class[cls] = block
            out["per_class"] = per_class
        return out


# --------------------------------------------------------------------------
# Scheduler
# --------------------------------------------------------------------------


class RequestScheduler:
    def __init__(self, cfg: PimConfig, topo: DeviceTopology | None = None,
                 policy: str = "rr", pipelined: bool = True):
        self.cfg = cfg
        self.topo = topo or DeviceTopology.from_config(cfg)
        self.policy = policy
        self.pipelined = pipelined
        # job -> (commands, param-cache residency trace or None)
        self._cmd_cache: dict[Job, tuple[list[Command], tuple | None]] = {}
        # job -> WARM param-cache residency trace (steady-state repeat of
        # the same stream on the same bank CU) for coalesced gang issues
        self._warm_cache: dict[Job, tuple | None] = {}
        # sharded-plan timing cache: only the shard count, orientation and
        # the gang's per-shard channel placement affect the latency.
        # Values are (latency_ns, per-shard counters, per-channel bus
        # busy ns, device counters) — see _sharded_latency.
        self._sharded_cache: dict[tuple, tuple[float, list, dict, dict]] = {}
        # GangJob -> resolver(flats) -> (latency_ns, per-bank counters,
        # per-channel bus busy, device counters); resolved results cache
        # by channel pattern exactly like the sharded cache
        self._gang_resolvers: dict[GangJob, object] = {}
        self._gang_cache: dict[tuple, tuple[float, list, dict, dict]] = {}
        # (job, gang size) -> _FastProfile for ServicePolicy(backend=
        # "fastpath"); _fast_verified holds the profiles already proven
        # against the interpreted oracle (verify_every sampling).
        self._fast_profiles: dict[tuple[Job, int], _FastProfile] = {}
        self._fast_verified: set[tuple[Job, int]] = set()

    # -- injection frontends -------------------------------------------------
    def run_closed_loop(self, jobs: Iterable[Job]) -> SchedulerResult:
        """Fixed batch: all requests present at t=0."""
        jobs = list(jobs)
        return self._run([(0.0, j) for j in jobs])

    def run_open_loop(self, jobs: Iterable[Job], rate_per_us: float,
                      seed: int = 0) -> SchedulerResult:
        """Poisson arrivals at `rate_per_us` requests/us (open loop)."""
        jobs = list(jobs)
        arrivals = poisson_arrivals_ns(seed, len(jobs), rate_per_us)
        return self._run(list(zip(arrivals.tolist(), jobs)))

    # -- plan priming (repro_torch.pimsys.session) ---------------------------------
    def prime(self, job: Job, commands: Sequence[Command],
              param_trace=None) -> None:
        """Pre-populate the per-job command cache from a compiled plan.

        `PimSession.submit` routes `CompiledPlan`s here so queued traffic
        replays the plan's frozen stream (and its precomputed
        parameter-cache residency trace) instead of re-running the
        mapper per distinct job spec.  The stream must be the job's
        canonical one (`job_commands` equivalent) — the scheduler trusts
        the session's compiler for that.
        """
        if isinstance(job, GANG_JOBS):
            raise TypeError("gang jobs have no single-bank stream to prime; "
                            "use prime_gang (the sharded plan cache handles "
                            "ShardedNttJob)")
        if job_rows(self.cfg, job) > self.cfg.rows_per_bank:
            raise ValueError(f"{job} does not fit in one bank")
        if param_trace is None and self.cfg.param_cache_entries:
            from repro_torch.pimsys.engine import param_beat_trace

            param_trace = param_beat_trace(self.cfg, job.n, commands)
        self._cmd_cache[job] = (list(commands), param_trace)

    # -- core event loop -----------------------------------------------------
    def _commands(self, job: Job) -> tuple[list[Command], tuple | None]:
        hit = self._cmd_cache.get(job)
        if hit is None:
            if job_rows(self.cfg, job) > self.cfg.rows_per_bank:
                raise ValueError(f"{job} does not fit in one bank")
            cmds = job_commands(self.cfg, job)
            trace = None
            if self.cfg.param_cache_entries:
                from repro_torch.pimsys.engine import param_beat_trace

                trace = param_beat_trace(self.cfg, job.n, cmds)
            hit = self._cmd_cache[job] = (cmds, trace)
        return hit

    def _sharded_latency(self, job: ShardedNttJob, flats: Sequence[int]):
        """Latency + stats of a gang job on the banks it was placed on.

        Simulated on an idle clone of the device (the gang reservation —
        see `ShardedNttJob`); cached by the placement's channel pattern,
        which is all the plan's timing depends on.  Counters are cached
        PER SHARD (not as a registry keyed to the first placement's
        banks) so a later gang with the same channel pattern but
        different banks attributes its work to the banks it actually
        ran on.  Returns (latency_ns, per_shard_counters, per_channel
        bus busy, device counters).
        """
        from repro_torch.pimsys.sharded import ShardedNttPlan

        key = (job.n, job.banks, job.forward,
               tuple(self.topo.channel_of(f) for f in flats))
        hit = self._sharded_cache.get(key)
        if hit is None:
            plan = ShardedNttPlan(self.cfg, job.n, job.banks,
                                  forward=job.forward, topo=self.topo,
                                  flat_banks=flats)
            r = plan.simulate(policy=self.policy, baseline=False,
                              pipelined=self.pipelined)
            shard_counters = []
            for f in flats:
                addr = self.topo.address_of(f)
                shard_counters.append(
                    r.stats.bank_counts(addr.channel, self.topo.local_id(addr)))
            bus_busy = {ch: r.stats.bus_busy_ns(ch) for ch in r.stats.channels()}
            dev = {"xfer_atoms": r.xfer_atoms, "xfer_hops": r.xfer_hops}
            hit = self._sharded_cache[key] = (
                r.latency_ns, shard_counters, bus_busy, dev)
        return hit

    # -- generic gang jobs (repro_torch.he and other extension ops) ----------------
    def prime_gang(self, job: GangJob, resolver) -> None:
        """Register the resolver a `GangJob` dispatches through.

        `resolver(flats)` simulates the gang on the reserved flat banks
        (on its own idle sub-device, the gang reservation model) and
        returns `(latency_ns, per_bank_counters, bus_busy_by_channel,
        device_counters)` — the exact shape `_sharded_latency` returns,
        so the dispatch loops and stats merging treat both identically.
        Results are cached by the placement's channel pattern, so the
        resolver runs once per distinct pattern no matter how many
        requests replay the plan.  Compiled plans prime this through
        `CompiledPlan.prime_scheduler`.
        """
        if not isinstance(job, GangJob):
            raise TypeError(f"prime_gang takes a GangJob, got {job!r}")
        self._gang_resolvers[job] = resolver

    def _gang_latency(self, job, flats: Sequence[int]):
        """Latency + stats of any gang job on its reserved banks."""
        if isinstance(job, ShardedNttJob):
            return self._sharded_latency(job, flats)
        key = (job, tuple(self.topo.channel_of(f) for f in flats))
        hit = self._gang_cache.get(key)
        if hit is None:
            resolver = self._gang_resolvers.get(job)
            if resolver is None:
                raise TypeError(
                    f"{job} has no primed resolver; submit gang plans "
                    "through the service (CompiledPlan.prime_scheduler) "
                    "or call prime_gang first")
            hit = self._gang_cache[key] = resolver(list(flats))
        return hit

    def _batch_traces(self, job: Job) -> tuple[tuple | None, tuple | None]:
        """(cold, warm) parameter-cache residency traces for one member
        of a coalesced gang issue.

        The first member starts from a cold per-bank CU cache (the
        plan's ordinary trace); members after it find the cache in the
        steady state the stream itself leaves behind, so they replay the
        WARM trace — the second pass of the stream issued twice.  LRU
        state after any full pass equals the state after the first, so
        one doubled-stream evaluation covers every subsequent member.
        Both traces derive from the frozen command list: zero mapper
        regeneration.  (None, None) when the device cache is disabled.
        """
        cmds, cold = self._commands(job)
        if cold is None:
            return None, None
        warm = self._warm_cache.get(job)
        if warm is None:
            from repro_torch.pimsys.engine import param_beat_trace

            doubled = param_beat_trace(self.cfg, job.n, cmds + cmds)
            warm = self._warm_cache[job] = doubled[len(cold):]
        return cold, warm

    def _fast_stream(self, job: Job, members: int):
        """The concatenated (commands, param_trace) one coalesced gang of
        `members` same-spec requests runs on its bank: cold first pass,
        warm steady-state repeats — exactly what the engine backend
        enqueues on the batch dispatch path."""
        cmds, trace = self._commands(job)
        if members == 1:
            return cmds, trace
        cold, warm = self._batch_traces(job)
        stream = cmds * members
        full = None if cold is None else tuple(cold) + tuple(warm) * (members - 1)
        return stream, full

    def _fast_profile(self, job: Job, members: int) -> _FastProfile:
        key = (job, members)
        hit = self._fast_profiles.get(key)
        if hit is None:
            from repro_torch.pimsys.fastpath import evaluate_gang, lower_commands

            stream, trace = self._fast_stream(job, members)
            lp = lower_commands(self.cfg, stream, trace)
            g = evaluate_gang(lp, 1, pipelined=self.pipelined)
            dones = g.dones[:, 0]
            per = lp.n_cmds // members
            member_done = tuple(float(dones[m * per:(m + 1) * per].max())
                                for m in range(members))
            hit = self._fast_profiles[key] = _FastProfile(
                member_done, float(g.bank_end_ns[0]),
                dict(g.counters[0]), g.bus_busy_ns)
        return hit

    def _verify_fast(self, job: Job, members: int) -> None:
        """Replay one fastpath profile's stream through the interpreted
        engine (`FastpathMismatch` on divergence); each distinct
        profile is proven at most once per scheduler."""
        key = (job, members)
        if key in self._fast_verified:
            return
        from repro_torch.pimsys.fastpath import verify_stream

        stream, trace = self._fast_stream(job, members)
        verify_stream(self.cfg, stream, 1, param_trace=trace,
                      pipelined=self.pipelined)
        self._fast_verified.add(key)

    def _validate_gang(self, job) -> None:
        """Fail fast on an unsatisfiable gang spec — for sharded NTTs the
        plan constructor holds the single copy of the rules (power-of-two
        banks and n, shard >= one atom, row fit, topology fit, buffer
        count); a generic `GangJob` checks its declared bank/row needs."""
        if isinstance(job, GangJob):
            if not 1 <= job.banks <= self.topo.total_banks:
                raise ValueError(
                    f"{job} needs {job.banks} banks; topology has "
                    f"{self.topo.total_banks}")
            if job.rows > self.cfg.rows_per_bank:
                raise ValueError(f"{job} does not fit in one bank")
            return
        from repro_torch.pimsys.sharded import ShardedNttPlan

        ShardedNttPlan(self.cfg, job.n, job.banks, forward=job.forward,
                       topo=self.topo)

    def _run(self, arrivals: list[tuple[float, Job]]) -> SchedulerResult:
        for job in {j for _, j in arrivals if isinstance(j, GANG_JOBS)}:
            self._validate_gang(job)
        tracer = Tracer() if self.cfg.telemetry else None
        device = Device(self.cfg, self.topo, policy=self.policy,
                        pipelined=self.pipelined, tracer=tracer)
        topo = self.topo
        pending = deque(sorted(arrivals, key=lambda p: p[0]))
        free: list[tuple[float, int]] = [(0.0, b) for b in range(topo.total_banks)]
        heapq.heapify(free)

        n = len(arrivals)
        t_arr = np.zeros(n)
        t_disp = np.zeros(n)
        t_done = np.zeros(n)
        done_count = 0
        jid = 0
        gang_makespan = 0.0
        # (flats, per-shard counters, per-channel bus busy, device counters)
        gang_stats: list[tuple] = []

        def record(ev):
            nonlocal done_count
            t_done[ev.job_id] = ev.done
            done_count += 1
            flat = topo.flat_from_local(ev.channel, ev.bank)
            heapq.heappush(free, (ev.done, flat))

        def need(job: Job) -> int:
            return job.banks if isinstance(job, GANG_JOBS) else 1

        while pending:
            t, job = pending[0]
            k = need(job)
            # surface every completion the device reaches before this arrival
            while True:
                evs = device.advance(horizon=t)
                if evs is None:
                    break
                for ev in evs:
                    record(ev)
            # Advance past any in-flight completion that beats the release
            # times currently known in `free`: gang reservations park their
            # banks in the heap with FUTURE timestamps, and a busy bank may
            # complete sooner than those — the k-th best known release is
            # exactly the horizon beyond which more device progress can't
            # improve this dispatch.  The horizon is only recomputed when a
            # completion changes `free` (advance issues ONE command per call
            # and usually completes nothing), and the common k=1 case reads
            # the heap minimum instead of scanning.
            horizon_stale = True
            while True:
                if horizon_stale:
                    if len(free) >= k:
                        horizon = free[0][0] if k == 1 else \
                            heapq.nsmallest(k, free)[-1][0]
                    else:
                        horizon = math.inf
                    horizon_stale = False
                if len(free) >= k and horizon <= t:
                    break
                evs = device.advance(horizon=horizon)
                if evs is None:
                    if len(free) < k:  # pragma: no cover - deficit implies work queued
                        raise RuntimeError("scheduler stalled with jobs in flight")
                    break
                for ev in evs:
                    record(ev)
                    horizon_stale = True
            pending.popleft()
            picked = [heapq.heappop(free) for _ in range(k)]
            gate = max(t, max(ft for ft, _ in picked))
            t_arr[jid], t_disp[jid] = t, gate
            if isinstance(job, GANG_JOBS):
                # gang reservation: the plan runs on its own sub-device
                # timeline; the banks rejoin the pool at completion
                flats = [f for _, f in picked]
                dur, shard_counters, bus_busy, dev_c = self._gang_latency(job, flats)
                done = gate + dur
                t_done[jid] = done
                done_count += 1
                gang_makespan = max(gang_makespan, done)
                gang_stats.append((flats, shard_counters, bus_busy, dev_c))
                for f in flats:
                    heapq.heappush(free, (done, f))
            else:
                cmds, trace = self._commands(job)
                device.enqueue_flat(picked[0][1], cmds, gate=gate,
                                    job_id=jid, param_trace=trace)
            jid += 1

        for ev in device.drain():
            record(ev)

        if done_count != n:  # not an assert: must survive python -O
            raise RuntimeError(f"conservation violated: {done_count} != {n}")
        stats = device.stats()
        for flats, shard_counters, bus_busy, dev_c in gang_stats:
            for f, counters in zip(flats, shard_counters):
                addr = topo.address_of(f)
                stats.add_bank(addr.channel, topo.local_id(addr), counters)
            for ch, busy in bus_busy.items():
                stats.add_bus(ch, busy, 0.0)
            stats.add_device(dev_c)
        makespan = max(device.makespan_ns, gang_makespan)
        # gang sub-device spans are gang-relative; the utilization
        # denominator must be the whole run
        stats.extend_span(makespan)
        tel = None
        if tracer is not None:
            for row in range(n):
                tracer.request_spans.append(
                    (row, "", "queue_wait", t_arr[row], t_disp[row]))
                tracer.request_spans.append(
                    (row, "", "execute", t_disp[row], t_done[row]))
            tel = TelemetryHandle(tracer)
        return SchedulerResult(
            submitted=n,
            completed=done_count,
            makespan_ns=makespan,
            arrivals_ns=t_arr,
            dispatch_ns=t_disp,
            done_ns=t_done,
            stats=stats,
            telemetry=tel,
        )

    # -- service dispatch: QoS aging, admission control, batching ------------
    def run_service(self, requests: Sequence[ServiceRequest],
                    policy: ServicePolicy | None = None,
                    seed: int | list | None = None) -> SchedulerResult:
        """Policy-driven dispatch of an explicit request trace.

        The substrate of `repro_torch.pimsys.service.DeviceService` — see the
        module docstring for the policy semantics.  `seed` is recorded
        verbatim on the result (and in `summary()`) so a run is
        reproducible from its artifact; the arrival trace itself is the
        caller's (the service generates it from that seed).

        With the default `ServicePolicy()` the dispatch sequence, every
        timestamp array, and the device stats are bit-identical to the
        legacy FIFO loop (`run_closed_loop` / `run_open_loop`) on the
        same trace.
        """
        policy = DEFAULT_POLICY if policy is None else policy
        requests = list(requests)
        for req in {r.job for r in requests if isinstance(r.job, GANG_JOBS)}:
            self._validate_gang(req)
        fast = policy.backend == "fastpath"
        if fast and self.cfg.telemetry:
            raise ValueError(
                "backend='fastpath' records no per-command telemetry; "
                "disable cfg.telemetry or use backend='engine'")
        # GangJob traffic composes with fastpath: its dispatch never steps
        # the shared device (the primed resolver runs once per channel
        # pattern and replays O(1) from the gang cache), so only sharded
        # NTTs — which interleave on the interpreted device — are rejected.
        if fast and any(isinstance(r.job, ShardedNttJob) for r in requests):
            # fail loudly rather than silently timing the gang on the
            # interpreted engine while every other dispatch is fastpath
            raise ValueError(
                "backend='fastpath' does not support sharded plans: "
                "ShardedNttJob gangs need the interpreted engine's "
                "cross-bank exchange model; use backend='engine'")
        tracer = Tracer() if (policy.telemetry or self.cfg.telemetry) else None
        window_ns = policy.telemetry_window_us * 1e3
        if tracer is not None:
            qd_series = {cls: WindowedSeries(window_ns, "max")
                         for cls in QOS_CLASSES}
            rej_series = WindowedSeries(window_ns, "sum")
        # coalesced gang members share one bank's working rows (same job
        # spec), so the single-job fit check in _commands covers batches
        device = Device(self.cfg, self.topo, policy=self.policy,
                        pipelined=self.pipelined, tracer=tracer)
        topo = self.topo
        n = len(requests)
        order = sorted(range(n), key=lambda i: (requests[i].arrival_ns, i))

        t_arr = np.zeros(n)
        t_disp = np.full(n, np.nan)
        t_done = np.full(n, np.nan)
        deadline = np.full(n, np.nan)
        status = np.zeros(n, dtype=np.int8)
        batched = np.zeros(n, dtype=bool)
        request_ids = np.zeros(n, dtype=np.int64)
        qos_rows: list[str] = [""] * n
        rejected_by: dict[tuple[str, str], int] = {}
        admitted = 0
        done_count = 0
        rid = 0  # next result row (dispatch-decision order)
        gang_makespan = 0.0
        gang_stats: list[tuple] = []
        n_batches = 0
        n_coalesced = 0
        # fastpath bookkeeping: dispatch counter for verify sampling and
        # (job, gang size, flat bank) -> use count for stats replay
        n_fast = 0
        fast_uses: dict[tuple[Job, int, int], int] = {}

        # Admitted-but-undispatched requests, one deque per QoS class.
        # Arrivals ingest in time order, so each deque stays sorted by
        # (arrival, seq) and its HEAD is the class's oldest request —
        # which, at any fixed weight, is also its highest-priority one.
        # Selection therefore compares just the two heads: O(1) per
        # dispatch instead of scanning the whole queue at saturation.
        lat_q: deque = deque()
        tput_q: deque = deque()
        n_waiting = 0
        bucket = (None if policy.bucket_rate_per_us is None
                  else _TokenBucket(policy.bucket_rate_per_us, policy.bucket_burst))
        free: list[tuple[float, int]] = [(0.0, b) for b in range(topo.total_banks)]
        heapq.heapify(free)
        batch_of: dict[int, _Batch] = {}

        def record(ev):
            nonlocal done_count
            t_done[ev.job_id] = ev.done
            done_count += 1
            b = batch_of.pop(ev.job_id, None)
            if b is None:
                flat = topo.flat_from_local(ev.channel, ev.bank)
                heapq.heappush(free, (ev.done, flat))
                return
            b.remaining -= 1
            if ev.done > b.max_done:
                b.max_done = ev.done
            if b.remaining == 0:
                heapq.heappush(free, (b.max_done, b.flat))

        def surface(t: float) -> None:
            """Surface every completion the device reaches before t."""
            while True:
                evs = device.advance(horizon=t)
                if evs is None:
                    return
                for ev in evs:
                    record(ev)

        def ingest(seq: int, queue: bool = True) -> _Waiting | None:
            """Admission-check one arrival; queue it or reject it.

            `queue=False` admits a batch joiner that dispatches
            immediately instead of waiting: the rate limiter still
            applies (it meters arrivals), the queue-depth bound does
            not (the joiner never occupies the queue).
            """
            nonlocal rid, admitted, n_waiting
            req = requests[seq]
            t = req.arrival_ns
            if (queue and policy.max_queue_depth is not None
                    and n_waiting >= policy.max_queue_depth):
                reason = "queue_full"
            elif bucket is not None and not bucket.take(t):
                reason = "rate_limited"
            else:
                admitted += 1
                w = _Waiting(t, seq, req.job, req.qos, req.deadline_ns)
                if queue:
                    q = lat_q if req.qos == "latency" else tput_q
                    q.append(w)
                    n_waiting += 1
                    if tracer is not None:
                        qd_series[req.qos].record(t, float(len(q)))
                return w
            row = rid
            rid += 1
            t_arr[row] = t
            qos_rows[row] = req.qos
            request_ids[row] = seq
            status[row] = STATUS_REJECTED
            key = (req.qos, reason)
            rejected_by[key] = rejected_by.get(key, 0) + 1
            if tracer is not None:
                tracer.request_events.append(
                    (seq, req.qos, f"rejected:{reason}", t))
                rej_series.record(t, 1.0)
            return None

        def place(w: _Waiting, row: int, gate: float) -> None:
            t_arr[row] = w.arrival
            t_disp[row] = gate
            qos_rows[row] = w.qos
            request_ids[row] = w.seq
            status[row] = STATUS_COMPLETED  # resolved by conservation check
            if w.deadline is not None:
                deadline[row] = w.deadline

        def need(job: Job) -> int:
            return job.banks if isinstance(job, GANG_JOBS) else 1

        i = 0  # arrival cursor over `order`
        while i < n or n_waiting:
            if not n_waiting:
                seq = order[i]
                t = requests[seq].arrival_ns
                surface(t)
                ingest(seq)
                i += 1
                continue

            # At full load every bank can be in flight (the heap empty);
            # surface completions until one release is known, so the
            # ingest cutoff below tracks the next dispatch opportunity.
            while not free:
                evs = device.advance()
                if evs is None:  # pragma: no cover - no free bank implies work in flight
                    raise RuntimeError(
                        "service dispatch stalled: no free bank, no work in flight")
                for ev in evs:
                    record(ev)
            # Ingest every arrival that lands by the earliest KNOWN
            # dispatch opportunity, so selection sees it.  `cutoff` is a
            # lower bound on the next dispatch gate: the best known bank
            # release (banks absent from the heap only complete later)
            # or the oldest queued arrival, whichever is later.
            cutoff = min(q[0].arrival for q in (lat_q, tput_q) if q)
            if free[0][0] > cutoff:
                cutoff = free[0][0]
            while i < n and requests[order[i]].arrival_ns <= cutoff:
                ingest(order[i])
                i += 1

            # weighted priority aging, evaluated at the decision time
            # over the two class heads (each head is its class's oldest
            # and therefore highest-priority request): ties (equal
            # weights -> pure age) break to arrival order, then
            # submission order — the FIFO anchor.
            t_sel = cutoff
            winner_q = None
            best = (-math.inf, 0.0, 0)
            for q, wt in ((lat_q, policy.weight_latency),
                          (tput_q, policy.weight_throughput)):
                if not q:
                    continue
                h = q[0]
                key = (wt * (t_sel - h.arrival), -h.arrival, -h.seq)
                if key > best:
                    best, winner_q = key, q
            winner = winner_q[0]
            k = need(winner.job)

            # the FIFO loop's horizon dance, anchored at the winner's
            # arrival: surface completions that beat the k-th best known
            # release without peeking past what could matter
            t = winner.arrival
            surface(t)
            horizon_stale = True
            while True:
                if horizon_stale:
                    if len(free) >= k:
                        horizon = free[0][0] if k == 1 else \
                            heapq.nsmallest(k, free)[-1][0]
                    else:
                        horizon = math.inf
                    horizon_stale = False
                if len(free) >= k and horizon <= t:
                    break
                evs = device.advance(horizon=horizon)
                if evs is None:
                    if len(free) < k:  # pragma: no cover - deficit implies work queued
                        raise RuntimeError("service dispatch stalled with jobs in flight")
                    break
                for ev in evs:
                    record(ev)
                    horizon_stale = True
            winner_q.popleft()
            n_waiting -= 1
            picked = [heapq.heappop(free) for _ in range(k)]
            gate = max(t, max(ft for ft, _ in picked))
            if tracer is not None:
                qd_series[winner.qos].record(gate, float(len(winner_q)))

            if isinstance(winner.job, GANG_JOBS):
                flats = [f for _, f in picked]
                dur, shard_counters, bus_busy, dev_c = self._gang_latency(
                    winner.job, flats)
                row = rid
                rid += 1
                place(winner, row, gate)
                done = gate + dur
                t_done[row] = done
                done_count += 1
                gang_makespan = max(gang_makespan, done)
                gang_stats.append((flats, shard_counters, bus_busy, dev_c))
                for f in flats:
                    heapq.heappush(free, (done, f))
                continue

            members = [winner]
            if (policy.batching and winner.qos == "throughput"):
                # Coalesce same-spec throughput work already waiting (no
                # added delay), oldest first — but stay work-conserving:
                # a batch takes at most an even share of the queue (one
                # bank's worth), so fattening one bank's gang never
                # starves the others and the drain-down tail never
                # serializes onto one bank.
                room = min(policy.max_batch - 1,
                           n_waiting // topo.total_banks)
                if room > 0:
                    keep: deque = deque()
                    wj = winner.job
                    for w in tput_q:
                        # w.arrival <= gate: the ingest cutoff can run
                        # ahead of the dispatch gate (gang reservations
                        # park banks at future release times), and a
                        # member must never issue before it arrives
                        if (len(members) <= room and w.job == wj
                                and w.arrival <= gate):
                            members.append(w)
                        else:
                            keep.append(w)
                    n_waiting -= len(members) - 1
                    tput_q.clear()
                    tput_q.extend(keep)
                # Hold the issue open inside the window for same-spec
                # arrivals still in flight (they delay the whole gang).
                # The window only consumes CONSECUTIVE matching
                # arrivals: the first non-matching one closes it and is
                # processed at its own dispatch turn, so its admission
                # check sees the queue state of its own time, not the
                # gang's (no spurious queue_full rejections).
                window_end = gate + policy.batch_window_us * 1e3
                while i < n and len(members) < policy.max_batch:
                    req = requests[order[i]]
                    if (req.arrival_ns > window_end
                            or req.qos != winner.qos
                            or req.job != winner.job):
                        break
                    w = ingest(order[i], queue=False)
                    i += 1
                    if w is not None:  # None: shed by the rate limiter
                        members.append(w)
                        if w.arrival > gate:
                            gate = w.arrival

            flat = picked[0][1]
            if fast:
                # O(1) replay of the gang's dedicated-bank profile: the
                # device never sees the commands, only the bank heap and
                # the timestamp arrays advance.
                m = len(members)
                prof = self._fast_profile(winner.job, m)
                n_fast += 1
                if policy.verify_every and n_fast % policy.verify_every == 0:
                    self._verify_fast(winner.job, m)
                if m > 1:
                    n_batches += 1
                    n_coalesced += m
                for k_m, w in enumerate(members):
                    row = rid
                    rid += 1
                    place(w, row, gate)
                    if m > 1:
                        batched[row] = True
                    t_done[row] = gate + prof.member_done[k_m]
                    done_count += 1
                release = gate + prof.release
                gang_makespan = max(gang_makespan, release)
                heapq.heappush(free, (release, flat))
                fkey = (winner.job, m, flat)
                fast_uses[fkey] = fast_uses.get(fkey, 0) + 1
            elif len(members) == 1:
                cmds, trace = self._commands(winner.job)
                row = rid
                rid += 1
                place(winner, row, gate)
                device.enqueue_flat(flat, cmds, gate=gate, job_id=row,
                                    param_trace=trace)
            else:
                cmds, _ = self._commands(winner.job)
                cold, warm = self._batch_traces(winner.job)
                batch = _Batch(len(members), flat)
                n_batches += 1
                n_coalesced += len(members)
                for m, w in enumerate(members):
                    row = rid
                    rid += 1
                    place(w, row, gate)
                    batched[row] = True
                    device.enqueue_flat(flat, cmds, gate=gate, job_id=row,
                                        param_trace=cold if m == 0 else warm)
                    batch_of[row] = batch

        for ev in device.drain():
            record(ev)

        if rid != n:  # not an assert: must survive python -O
            raise RuntimeError(f"row accounting violated: {rid} != {n}")
        if done_count != admitted:
            raise RuntimeError(
                f"conservation violated: {done_count} completed != "
                f"{admitted} admitted")
        stats = device.stats()
        for flats, shard_counters, bus_busy, dev_c in gang_stats:
            for f, counters in zip(flats, shard_counters):
                addr = topo.address_of(f)
                stats.add_bank(addr.channel, topo.local_id(addr), counters)
            for ch, busy in bus_busy.items():
                stats.add_bus(ch, busy, 0.0)
            stats.add_device(dev_c)
        # fastpath dispatches never touched the device: fold each
        # profile's counters back in, scaled by its per-bank use count
        fast_bus: dict[int, float] = {}
        for (job, m, f), cnt in fast_uses.items():
            prof = self._fast_profiles[(job, m)]
            addr = topo.address_of(f)
            stats.add_bank(addr.channel, topo.local_id(addr),
                           {k: v * cnt for k, v in prof.counters.items()})
            fast_bus[addr.channel] = (fast_bus.get(addr.channel, 0.0)
                                      + prof.bus_busy * cnt)
        for ch, busy in fast_bus.items():
            stats.add_bus(ch, busy, 0.0)
        makespan = max(device.makespan_ns, gang_makespan)
        stats.extend_span(makespan)
        for cls in QOS_CLASSES:
            n_cls = sum(1 for r in requests if r.qos == cls)
            if n_cls:
                stats.add_service(cls, "submitted", n_cls)
        for (cls, reason), count in rejected_by.items():
            stats.add_service(cls, f"rejected_{reason}", count)
        tel = None
        if tracer is not None:
            # Per-request lifecycle spans, from the result arrays: the
            # wait span (arrival -> dispatch; "coalesce_wait" when the
            # row rode a coalesced gang, whose gate may rise to joiner
            # arrivals) plus "execute" (dispatch -> completion) tile the
            # whole end-to-end latency — 100% attribution by
            # construction, which is what report_telemetry.py's >= 95%
            # gate checks survives export/import.
            for row in range(n):
                if status[row] != STATUS_COMPLETED:
                    continue
                rid_tag = int(request_ids[row])
                cls = qos_rows[row]
                wait = "coalesce_wait" if batched[row] else "queue_wait"
                tracer.request_spans.append(
                    (rid_tag, cls, wait, float(t_arr[row]), float(t_disp[row])))
                tracer.request_spans.append(
                    (rid_tag, cls, "execute", float(t_disp[row]),
                     float(t_done[row])))
            for cls, s in qd_series.items():
                if len(s):
                    stats.attach_series(f"queue_depth/{cls}", s)
            if len(rej_series):
                stats.attach_series("admission_rejects", rej_series)
            for name, s in device_series(tracer, window_ns).items():
                stats.attach_series(name, s)
            tel = TelemetryHandle(tracer)
        return SchedulerResult(
            submitted=n,
            completed=done_count,
            makespan_ns=makespan,
            arrivals_ns=t_arr,
            dispatch_ns=t_disp,
            done_ns=t_done,
            stats=stats,
            qos=qos_rows,
            deadline_ns=deadline,
            status=status,
            batched=batched,
            request_ids=request_ids,
            rejected_by=rejected_by,
            batches=n_batches,
            coalesced=n_coalesced,
            seed=seed,
            telemetry=tel,
        )
