"""`repro_torch.pimsys` — device-level PIM memory system (beyond the paper).

The paper models one NTT-PIM bank; this package models the device around
it, fronted by ONE compile/execute API:

    from repro_torch.pimsys import PimSession, PolymulOp

    sess = PimSession(PimConfig(num_buffers=4, num_channels=2, num_banks=4))
    plan = sess.compile(PolymulOp(1024))     # frozen: commands, placement,
                                             # twiddle-parameter streams
    r = sess.run(plan, a, b)                 # RunResult: value/timing/stats/trace
    svc = sess.service(ServicePolicy(weight_latency=8.0, batch_window_us=10.0))
    futs = svc.submit_poisson(plan, count=64, rate_per_us=0.1)  # open loop
    [f.result() for f in svc.as_completed(futs)]   # simulated-time order

`session` is the entry layer: declarative op specs (`NttOp`,
`InverseNttOp`, `PolymulOp`, `ShardedNttOp`, `BatchOp`) compile once into
memoized `CompiledPlan`s — the paper's precomputed (w0, r_w) parameter
streams made explicit — and run many times, mirroring how the MC amortizes
trace generation over replay.  `service` is the serving layer:
`DeviceService.submit(plan, qos=..., deadline_us=...) -> PimFuture` over a
policy-driven dispatcher (QoS classes with weighted priority aging,
bounded-queue + token-bucket admission control, window-based coalescing of
same-plan arrivals into gang issues, per-request SLO accounting).  Beneath
them sit `topology` (channels × ranks × banks), `controller` (per-channel
command-bus arbitration over `core.pimsim.BankEngine`), `scheduler` (the
dispatcher: legacy FIFO loop + `run_service`, gang-scheduled sharded
jobs), `sharded` (four-step split of one NTT across banks/channels),
`trace` (text record/replay), `stats` (device-wide counters, bus
utilization, energy, per-class service counters), `telemetry`
(opt-in command/phase/request tracing via `PimConfig.telemetry` or
`ServicePolicy.telemetry`: Perfetto-exportable `TelemetryHandle` on
`RunResult`/`SchedulerResult`, tumbling-window series in
`StatsRegistry.summary()`), and `fastpath` (the compiled vectorized
timing backend: `PimSession.run(plan, backend="fastpath")` and
`ServicePolicy(backend="fastpath")` — bit-identical single-run timing
without the interpreted event loop, `verify`/`verify_stream` as the
differential oracle).

The pre-session entry points (`core.pimsim.simulate_ntt`,
`simulate_multibank`, `simulate_ntt_sharded`, `core.polymul.pim_polymul`,
`pim_ntt_sharded`, `polymul_batch`) and now `PimSession.submit()` remain
as deprecated shims — bit-identical in values, cycles, and command lists.
"""
from repro_torch.pimsys.controller import ChannelController, Completion, Device
from repro_torch.pimsys.engine import (
    ChannelEngine,
    DeviceEngine,
    RankState,
    param_beat_trace,
    replay_gang,
)
from repro_torch.pimsys.fastpath import (
    FastpathMismatch,
    GangResult,
    LoweredPlan,
    evaluate_gang,
    lower_commands,
    lower_plan,
)
from repro_torch.pimsys.fastpath import verify as fastpath_verify
from repro_torch.pimsys.fastpath import verify_stream
from repro_torch.pimsys.scheduler import (
    DEFAULT_POLICY,
    QOS_CLASSES,
    STATUS_COMPLETED,
    STATUS_REJECTED,
    GangJob,
    NttJob,
    PolymulJob,
    RequestScheduler,
    SchedulerResult,
    ServicePolicy,
    ServiceRequest,
    ShardedNttJob,
    job_commands,
)
from repro_torch.pimsys.service import (
    DeviceService,
    PimFuture,
    ServedRequest,
)
from repro_torch.pimsys.session import (
    BatchOp,
    CompiledPlan,
    InverseNttOp,
    NttOp,
    OpHandler,
    PimSession,
    PolymulOp,
    RunResult,
    ShardedNttOp,
    TraceHandle,
    op_handler,
    register_op_handler,
    twiddle_param_stream,
)
from repro_torch.pimsys.sharded import (
    ExchangePair,
    ExchangeStage,
    ShardedNttPlan,
    ShardedTimingResult,
)
from repro_torch.pimsys.stats import StatsRegistry
from repro_torch.pimsys.telemetry import (
    Reservoir,
    TelemetryHandle,
    Tracer,
    WindowedSeries,
    validate_chrome_trace,
)
from repro_torch.pimsys.topology import BankAddress, DeviceTopology
from repro_torch.pimsys.trace import dump_trace, dumps_trace, load_trace, loads_trace, replay_trace

__all__ = [
    "BankAddress",
    "BatchOp",
    "ChannelController",
    "ChannelEngine",
    "CompiledPlan",
    "Completion",
    "DEFAULT_POLICY",
    "Device",
    "DeviceEngine",
    "DeviceService",
    "DeviceTopology",
    "ExchangePair",
    "ExchangeStage",
    "FastpathMismatch",
    "GangJob",
    "GangResult",
    "InverseNttOp",
    "LoweredPlan",
    "NttJob",
    "NttOp",
    "OpHandler",
    "PimFuture",
    "PimSession",
    "PolymulJob",
    "PolymulOp",
    "QOS_CLASSES",
    "RankState",
    "RequestScheduler",
    "Reservoir",
    "RunResult",
    "STATUS_COMPLETED",
    "STATUS_REJECTED",
    "SchedulerResult",
    "ServedRequest",
    "ServicePolicy",
    "ServiceRequest",
    "ShardedNttJob",
    "ShardedNttOp",
    "ShardedNttPlan",
    "ShardedTimingResult",
    "StatsRegistry",
    "TelemetryHandle",
    "TraceHandle",
    "Tracer",
    "WindowedSeries",
    "dump_trace",
    "dumps_trace",
    "evaluate_gang",
    "fastpath_verify",
    "job_commands",
    "load_trace",
    "loads_trace",
    "lower_commands",
    "lower_plan",
    "op_handler",
    "param_beat_trace",
    "register_op_handler",
    "replay_gang",
    "replay_trace",
    "verify_stream",
    "twiddle_param_stream",
    "validate_chrome_trace",
]
