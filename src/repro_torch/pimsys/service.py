"""Async device-service API: futures over the policy-driven dispatcher.

`PimSession` answered "how do I run ONE op efficiently" (compile once,
replay the frozen plan).  This module answers the ROADMAP's serving
question — heavy open-loop NTT/polymul traffic from many clients — by
putting an asynchronous service façade over the device:

    svc = DeviceService(session, policy=ServicePolicy(weight_latency=8.0,
                                                      batch_window_us=10.0))
    plan = svc.session.compile(NttOp(256))
    futs = svc.submit_poisson(plan, count=64, rate_per_us=1.0,
                              qos="throughput", seed=1)
    urgent = svc.submit(plan, qos="latency", deadline_us=50.0, at_us=12.5)
    for fut in svc.as_completed([*futs, urgent]):   # simulated-time order
        rec = fut.result()       # ServedRequest: latency, deadline, status
    svc.result().summary()       # epoch-level SchedulerResult rollup

Execution model (simulated time, resolved lazily)
-------------------------------------------------
Submissions accumulate into the current *epoch*; nothing simulates until
a future's `result()` (or an explicit `flush()`) forces the epoch, which
runs the whole accumulated arrival trace through
`RequestScheduler.run_service` on a fresh device timeline and resolves
every pending future at once.  That keeps the API asynchronous — callers
hold futures, compose them with `gather`/`as_completed` — while the
simulator stays deterministic: the same submissions and seeds replay to
byte-identical results (`SchedulerResult.seed` records the arrival-trace
seed for exactly that purpose).

The dispatcher underneath (see `repro_torch.pimsys.scheduler`) provides QoS
classes with weighted priority aging, bounded-queue + token-bucket
admission control (rejected requests resolve with status ``rejected``
rather than raising), window-based coalescing of same-`(cfg, op)`
arrivals into gang issues that replay the frozen `CompiledPlan` with
zero mapper regeneration, and per-request deadline/SLO accounting.
`ServicePolicy(backend="fastpath", verify_every=K)` swaps the
interpreted device for the compiled vectorized timing backend
(`repro_torch.pimsys.fastpath`) — O(1) profile replay per dispatch, the
knob that makes million-request sweeps (`benchmarks/serving.py
--full`) tractable, with every K-th dispatch differentially checked
against the interpreted oracle.

`PimSession.submit()` is now a one-`DeprecationWarning` shim over this
service with the default (FIFO-equivalent) policy — bit-identical to the
pre-service scheduler path.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

from repro_torch.core.pim_config import PimConfig
from repro_torch.pimsys.scheduler import (
    DEFAULT_POLICY,
    GANG_JOBS,
    QOS_CLASSES,
    STATUS_REJECTED,
    SchedulerResult,
    ServicePolicy,
    ServiceRequest,
    job_rows,
    poisson_arrivals_ns,
)
from repro_torch.pimsys.topology import DeviceTopology


# --------------------------------------------------------------------------
# Per-request results
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """One request's resolved outcome, in simulated microseconds.

    `status` is ``"completed"`` or ``"rejected"`` (admission control);
    rejected requests carry NaN dispatch/done/latency and never touched
    the device.  `met_deadline` is None when no deadline was given.
    `batched` marks members of a coalesced gang issue.  `epoch` is the
    flush that resolved the request — each epoch simulates on a fresh
    device timeline starting at t=0, so timestamps compare only within
    one epoch.
    """

    index: int
    epoch: int
    job: object
    qos: str
    status: str
    arrival_us: float
    dispatch_us: float
    done_us: float
    latency_us: float
    deadline_us: float | None
    met_deadline: bool | None
    batched: bool

    @property
    def ok(self) -> bool:
        return self.status == "completed"


class PimFuture:
    """Handle to one submitted request, resolved in simulated time.

    `result()` forces the owning epoch (simulating every request
    submitted so far) the first time it is called; afterwards it is a
    plain lookup.  A rejected request resolves normally with
    `status == "rejected"` — admission control is an expected outcome
    of the policy, not an error.
    """

    __slots__ = ("_service", "_index", "_record")

    def __init__(self, service: "DeviceService", index: int):
        self._service = service
        self._index = index
        self._record: ServedRequest | None = None

    def done(self) -> bool:
        return self._record is not None

    def result(self) -> ServedRequest:
        if self._record is None:
            self._service.flush()
        if self._record is None:  # pragma: no cover - flush resolves it
            raise RuntimeError("future did not resolve on flush")
        return self._record

    @property
    def latency_us(self) -> float:
        return self.result().latency_us

    def __repr__(self) -> str:
        state = self._record.status if self._record else "pending"
        return f"PimFuture(index={self._index}, {state})"


@dataclasses.dataclass(frozen=True)
class _Submission:
    index: int
    job: object
    qos: str
    deadline_ns: float | None
    arrival_ns: float
    future: PimFuture
    plan: object  # CompiledPlan | None (sharded plans prime differently)


# --------------------------------------------------------------------------
# The service
# --------------------------------------------------------------------------


class DeviceService:
    """Asynchronous serving façade over one PIM device.

    Wraps a `PimSession` (or builds one from `cfg`): plans compile once
    through the session's memoized cache, the session's persistent
    `RequestScheduler` keeps its command/gang caches warm, and every
    epoch simulates on a fresh device timeline, so results depend only
    on the submissions and seeds — never on service history.

    `policy` is the dispatch `ServicePolicy` (QoS weights, admission
    control, batching window); `seed` is the default arrival-trace seed
    recorded on every epoch's `SchedulerResult`.
    """

    def __init__(self, session=None, *, cfg: PimConfig | None = None,
                 topo: DeviceTopology | None = None,
                 policy: ServicePolicy | None = None,
                 bus_policy: str = "rr", pipelined: bool = True,
                 seed: int = 0):
        if session is None:
            from repro_torch.pimsys.session import PimSession

            session = PimSession(cfg, topo=topo, policy=bus_policy,
                                 pipelined=pipelined)
        elif cfg is not None or topo is not None:
            raise ValueError("pass either a session or cfg/topo, not both")
        self.session = session
        self.policy = policy if policy is not None else DEFAULT_POLICY
        self.seed = seed
        self._pending: list[_Submission] = []
        self._epoch_seeds: list[int] = []
        self._results: list[SchedulerResult] = []
        self._count = 0
        self._epoch = 0  # monotonic: counts every flush, retained or not

    # -- submission ----------------------------------------------------------
    def submit(self, plan, *, qos: str = "throughput",
               deadline_us: float | None = None,
               at_us: float = 0.0) -> PimFuture:
        """Submit one request; returns an unresolved `PimFuture`.

        `plan` is a `CompiledPlan` or an op spec (compiled through the
        session cache).  `at_us` is the request's simulated arrival in
        the current epoch (default 0.0 = a closed-loop submission);
        `deadline_us` an SLO relative to arrival, `qos` one of
        ``latency`` / ``throughput``.
        """
        return self._enqueue(plan, qos, deadline_us, at_us * 1e3)

    def submit_poisson(self, plan, count: int, rate_per_us: float, *,
                       qos: str = "throughput",
                       deadline_us: float | None = None,
                       seed: int | None = None,
                       start_us: float = 0.0) -> list[PimFuture]:
        """Submit `count` open-loop Poisson arrivals at `rate_per_us`.

        The arrival trace derives from `seed` (default: the service
        seed) and is recorded on the epoch's `SchedulerResult` — rerun
        with the same seeds and the results are byte-identical.
        """
        if count < 1:
            raise ValueError("count must be >= 1")
        if rate_per_us <= 0:
            raise ValueError("rate_per_us must be positive")
        seed = self.seed if seed is None else seed
        if seed not in self._epoch_seeds:
            self._epoch_seeds.append(seed)
        # the ONE arrival-trace formula (shared with run_open_loop —
        # the FIFO-parity guarantee depends on it)
        arrivals = start_us * 1e3 + poisson_arrivals_ns(seed, count,
                                                        rate_per_us)
        return [self._enqueue(plan, qos, deadline_us, float(t))
                for t in arrivals.tolist()]

    def submit_mixed_poisson(self, plan, count: int, rate_per_us: float, *,
                             latency_frac: float = 0.25,
                             deadline_us: float | None = None,
                             seed_throughput: int = 0,
                             seed_latency: int = 1) -> list[PimFuture]:
        """Submit a mixed-class open-loop trace: `latency_frac` of
        `count` as `latency`-class arrivals (with `deadline_us`), the
        rest `throughput`-class, the offered `rate_per_us` split
        proportionally, each class on its own seed.  The one definition
        of the mix convention the benchmarks and examples share.
        """
        if not 0.0 <= latency_frac <= 1.0:
            raise ValueError("latency_frac must be in [0, 1]")
        n_lat = int(round(count * latency_frac))
        n_tput = count - n_lat
        futs: list[PimFuture] = []
        if n_tput:
            futs += self.submit_poisson(
                plan, n_tput, rate_per_us * (1 - latency_frac),
                qos="throughput", seed=seed_throughput)
        if n_lat:
            futs += self.submit_poisson(
                plan, n_lat, rate_per_us * latency_frac, qos="latency",
                deadline_us=deadline_us, seed=seed_latency)
        return futs

    def _enqueue(self, plan, qos, deadline_us, arrival_ns) -> PimFuture:
        from repro_torch.pimsys.session import BatchOp, CompiledPlan

        if not isinstance(plan, CompiledPlan):
            plan = self.session.compile(plan)
        if plan.cfg != self.session.cfg:
            raise ValueError("plan was compiled for a different PimConfig")
        if isinstance(plan.op, BatchOp):
            raise TypeError("submit BatchOp plans one request at a time; "
                            "the service owns the batching")
        if qos not in QOS_CLASSES:
            raise ValueError(f"qos must be one of {QOS_CLASSES}, got {qos!r}")
        if arrival_ns < 0:
            raise ValueError("arrival (at_us/start_us) must be >= 0")
        if deadline_us is not None and deadline_us <= 0:
            raise ValueError("deadline_us must be positive (or None)")
        job = plan.job()
        # validate NOW, not at flush: a bad submission must fail alone,
        # not poison the whole epoch's pending futures (sharded plans
        # already validate at compile time; other gang jobs validate
        # their declared bank/row needs against this device)
        if isinstance(job, GANG_JOBS):
            self.session.scheduler()._validate_gang(job)
        elif job_rows(plan.cfg, job) > plan.cfg.rows_per_bank:
            raise ValueError(f"{job} does not fit in one bank")
        fut = PimFuture(self, self._count)
        deadline_ns = None if deadline_us is None else deadline_us * 1e3
        self._pending.append(_Submission(
            self._count, job, qos, deadline_ns, arrival_ns, fut, plan))
        self._count += 1
        return fut

    # -- epoch execution -----------------------------------------------------
    def flush(self, retain: bool = True) -> SchedulerResult:
        """Simulate the current epoch and resolve its futures.

        Returns the epoch's `SchedulerResult`, kept in `results` unless
        `retain=False` (long-lived callers that consume the result
        immediately — e.g. the `PimSession.submit` shim — opt out so
        the history does not grow unboundedly).  Raises if nothing is
        pending.  With `ServicePolicy.telemetry` on, the result carries
        a `telemetry` handle with the epoch's full timeline (request
        lifecycle spans tagged by submission index = the futures' join
        key) and its stats a `timeseries` summary block.
        """
        if not self._pending:
            raise RuntimeError("nothing submitted since the last flush")
        pending, self._pending = self._pending, []
        seeds, self._epoch_seeds = self._epoch_seeds, []
        try:
            sched = self.session.scheduler()
            primed = set()
            for sub in pending:
                if sub.job not in primed:
                    primed.add(sub.job)
                    sub.plan.prime_scheduler(sched)
            reqs = [ServiceRequest(sub.arrival_ns, sub.job, qos=sub.qos,
                                   deadline_ns=sub.deadline_ns)
                    for sub in pending]
            if not seeds:
                seed: int | list | None = self.seed
            elif len(seeds) == 1:
                seed = seeds[0]
            else:
                seed = list(seeds)
            res = sched.run_service(reqs, policy=self.policy, seed=seed)
        except BaseException:
            # a failed epoch must not orphan its futures: restore the
            # submissions so the caller can retry or inspect them
            self._pending = pending + self._pending
            self._epoch_seeds = seeds + self._epoch_seeds
            raise
        epoch = self._epoch
        self._epoch += 1
        if retain:
            self._results.append(res)
        self._resolve(pending, res, epoch)
        return res

    def _resolve(self, pending: Sequence[_Submission],
                 res: SchedulerResult, epoch: int) -> None:
        row_of = {int(s): row for row, s in enumerate(res.request_ids)}
        base = pending[0].index
        for sub in pending:
            row = row_of[sub.index - base]
            rejected = res.status[row] == STATUS_REJECTED
            arrival = float(res.arrivals_ns[row])
            done = float(res.done_ns[row])
            deadline = sub.deadline_ns
            met = None
            if deadline is not None and not rejected:
                met = bool(done - arrival <= deadline)
            sub.future._record = ServedRequest(
                index=sub.index,
                epoch=epoch,
                job=sub.job,
                qos=sub.qos,
                status="rejected" if rejected else "completed",
                arrival_us=arrival / 1e3,
                dispatch_us=float(res.dispatch_ns[row]) / 1e3,
                done_us=done / 1e3,
                latency_us=(done - arrival) / 1e3,
                deadline_us=None if deadline is None else deadline / 1e3,
                met_deadline=met,
                batched=bool(res.batched[row]),
            )

    # -- composition ---------------------------------------------------------
    def gather(self, futures: Iterable[PimFuture]) -> list[ServedRequest]:
        """Resolve `futures` (flushing if needed), in submission order."""
        return [f.result() for f in futures]

    def as_completed(self, futures: Iterable[PimFuture]):
        """Yield `futures` in simulated completion order.

        Epochs simulate on independent timelines (each flush restarts
        the device clock at t=0), so futures order by epoch first, then
        within an epoch by simulated done time (ties by submission
        order); an epoch's rejected requests follow its completed ones,
        in arrival order — they never complete, but a caller iterating
        the epoch must still observe them.
        """
        futures = list(futures)
        for f in futures:
            f.result()
        def key(f: PimFuture):
            r = f._record
            if r.status == "completed":
                return (r.epoch, 0, r.done_us, r.index)
            return (r.epoch, 1, r.arrival_us, r.index)
        return iter(sorted(futures, key=key))

    # -- results -------------------------------------------------------------
    @property
    def results(self) -> list[SchedulerResult]:
        """Every flushed epoch's `SchedulerResult`, oldest first."""
        return list(self._results)

    def result(self, epoch: int = -1) -> SchedulerResult:
        """One epoch's `SchedulerResult` (default: the latest), flushing
        the current epoch first if it has pending submissions."""
        if self._pending:
            self.flush()
        if not self._results:
            raise RuntimeError("no epoch has run yet")
        return self._results[epoch]

    def pending(self) -> int:
        return len(self._pending)
