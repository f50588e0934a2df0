"""repro_torch.pimsys.fastpath — compiled vectorized timing backend.

Lowers a `CompiledPlan`'s frozen command stream to dense numpy arrays
once (`lower_plan` / `lower_commands`) and evaluates homogeneous
multibank gangs as block-speculative array recurrences
(`evaluate_gang`) instead of the interpreted per-command event loop —
bit-identical results at a fraction of the cost, which is what lets
`benchmarks/serving.py --full` sweep millions of requests.

The interpreted engine stays the ground truth: `verify` /
`verify_stream` replay a workload through both and raise
`FastpathMismatch` on any divergence.  Session/serving entry points:
`PimSession.run(plan, backend="fastpath")` and
`ServicePolicy(backend="fastpath", verify_every=K)`.
"""
from .evaluate import (
    FastpathMismatch,
    GangResult,
    evaluate_gang,
    phase_breakdown,
    verify,
    verify_stream,
)
from .lowering import LoweredPlan, lower_commands, lower_plan

__all__ = [
    "FastpathMismatch",
    "GangResult",
    "LoweredPlan",
    "evaluate_gang",
    "lower_commands",
    "lower_plan",
    "phase_breakdown",
    "verify",
    "verify_stream",
]
