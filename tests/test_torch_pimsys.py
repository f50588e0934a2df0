"""The port's device stack (`repro_torch.pimsys`) against the JAX package's
`repro.pimsys` on the same inputs.

Each case builds the same workload in both packages and compares, with
`==` on floats: `RunResult` values, timing results, stats registries and
trace text for every op kind and both timing backends; the serving path
(QoS mix, admission, batching, seeded Poisson arrivals) by per-class
percentiles and rejections; the Perfetto export of a telemetry-on run;
and the fastpath differential oracle on one plan.  Inputs are numpy
uint32 drawn from a seed.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import repro.pimsys as ref_pimsys
import repro_torch.pimsys as pimsys
from repro.core import mapping as ref_mapping
from repro.core.pim_config import PimConfig as RefPimConfig
from repro_torch.core import mapping
from repro_torch.core import modmath as mm
from repro_torch.core.pim_config import PimConfig
from test_torch_sim_core import plain  # one definition for the three files

Q = mm.DEFAULT_Q
SMALL = dict(num_buffers=2, num_channels=2, num_banks=2)
PACKAGES = {"port": (pimsys, PimConfig), "ref": (ref_pimsys, RefPimConfig)}


def rand_poly(n, seed):
    return np.random.default_rng(seed).integers(0, Q, n).astype(np.uint32)


def both(fn):
    """`fn(pkg, PimConfig)` run on the port and on the reference."""
    return [fn(*PACKAGES[k]) for k in ("port", "ref")]


def run_record(r):
    return {"op": plain(r.op), "value": plain(r.value), "timing": plain(r.timing),
            "stats": plain(r.stats),
            "trace": None if r.trace is None else r.trace.dumps()}


# ---------------------------------------------------------------------------
# PimSession.run: every op kind, both timing backends
# ---------------------------------------------------------------------------

RUN_CASES = {
    "ntt-inverse": (lambda p: p.NttOp(256), 1, "engine"),
    "ntt-inverse-fastpath": (lambda p: p.NttOp(256), 1, "fastpath"),
    "ntt-forward": (lambda p: p.NttOp(512, forward=True), 1, "engine"),
    "ntt-forward-fastpath": (lambda p: p.NttOp(512, forward=True), 1, "fastpath"),
    "inverse-alias-unscaled": (lambda p: p.InverseNttOp(256, scale_n_inv=False), 1, "engine"),
    "polymul": (lambda p: p.PolymulOp(256), 2, "engine"),
    "polymul-fastpath": (lambda p: p.PolymulOp(512), 2, "fastpath"),
    "sharded-inverse": (lambda p: p.ShardedNttOp(512, banks=4), 1, "engine"),
    "sharded-forward": (lambda p: p.ShardedNttOp(256, banks=2, forward=True), 1, "engine"),
    "sharded-conflict": (lambda p: p.ShardedNttOp(512, banks=4, placement="conflict"), 1, "engine"),
    "batch-ntt": (lambda p: p.BatchOp(p.NttOp(256), 4), 0, "engine"),
    "batch-ntt-fastpath": (lambda p: p.BatchOp(p.NttOp(256), 4), 0, "fastpath"),
    "batch-polymul": (lambda p: p.BatchOp(p.PolymulOp(256), 3), 0, "engine"),
}


@pytest.mark.parametrize("cache", [0, 8])
@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_session_run_matches_reference(case, cache):
    make_op, k, backend = RUN_CASES[case]

    def go(pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(**SMALL, param_cache_entries=cache))
        plan = sess.compile(make_op(pkg))
        n = getattr(plan.op, "n", None) or plan.op.op.n
        inputs = [rand_poly(n, 7 + i) for i in range(k)]
        return run_record(sess.run(plan, *inputs, backend=backend))

    port, ref = both(go)
    assert port == ref
    if k:
        assert port["value"][1] == "<u4"


def test_tensor_inputs_go_to_the_host():
    sess = pimsys.PimSession(PimConfig(**SMALL))
    a, b = rand_poly(256, 1), rand_poly(256, 2)
    plan = sess.compile(pimsys.PolymulOp(256))
    from_np = sess.run(plan, a, b, time=False).value
    from_t = sess.run(plan, mm.to_device_u32(a, "cpu"), mm.to_device_u32(b, "cpu"),
                      time=False).value
    assert isinstance(from_t, np.ndarray) and np.array_equal(from_t, from_np)
    assert sess.device is None
    assert pimsys.PimSession(device="cpu").device == torch.device("cpu")


def test_plan_cache_and_zero_regeneration_match():
    def go(pkg, cfg_cls):
        gen = (mapping if pkg is pimsys else ref_mapping).mapper_generations
        sess = pkg.PimSession(cfg_cls(**SMALL))
        plan = sess.compile(pkg.NttOp(256))
        assert sess.compile(pkg.InverseNttOp(256)) is plan
        before = gen()
        sess.run(plan, rand_poly(256, 3))
        sess.run(plan)
        return sess.plan_hits, sess.plan_misses, gen() - before

    port, ref = both(go)
    assert port == ref == (1, 1, 0)


def test_cross_package_plans_are_refused():
    ref_sess = ref_pimsys.PimSession(RefPimConfig(**SMALL))
    ref_plan = ref_sess.compile(ref_pimsys.NttOp(256))
    sess = pimsys.PimSession(PimConfig(**SMALL))
    with pytest.raises(TypeError):
        sess.run(ref_plan)
    with pytest.raises(TypeError):
        sess.compile(ref_pimsys.NttOp(256))


# ---------------------------------------------------------------------------
# Serving: QoS classes, admission, batching, seeded arrivals
# ---------------------------------------------------------------------------

POLICIES = {
    "fifo": {},
    "qos": dict(weight_latency=8.0),
    "admission": dict(weight_latency=4.0, max_queue_depth=4, bucket_rate_per_us=0.05,
                      bucket_burst=3),
    "batch": dict(batch_window_us=10.0, max_batch=4),
    "fastpath": dict(weight_latency=8.0, backend="fastpath", verify_every=2),
}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_service_matches_reference(policy):
    def go(pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(**SMALL, param_cache_entries=8))
        svc = sess.service(pkg.ServicePolicy(**POLICIES[policy]))
        ntt_plan = sess.compile(pkg.NttOp(256))
        futs = svc.submit_mixed_poisson(ntt_plan, 16, 0.2, latency_frac=0.25, deadline_us=30.0)
        futs += svc.submit_poisson(sess.compile(pkg.PolymulOp(256)), 6, 0.05, seed=0)
        done = [plain(f.result()) for f in svc.as_completed(futs)]
        res = svc.result()
        per_class = {c: res.latency_percentiles_us(qos=c) for c in pkg.QOS_CLASSES}
        return {"summary": plain(res.summary(window_us=50.0)), "per_class": plain(per_class),
                "rejected_by": plain(res.rejected_by), "done": done,
                "result": plain(dataclasses.replace(res, telemetry=None))}

    port, ref = both(go)
    assert port == ref


def test_service_poisson_seed_zero_matches_reference():
    def go(pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(**SMALL))
        svc = sess.service()
        svc.submit_poisson(sess.compile(pkg.PolymulOp(256)), 12, 0.1, seed=0)
        res = svc.flush()
        return plain(res.arrivals_ns), plain(res.done_ns), res.seed

    port, ref = both(go)
    assert port == ref


# ---------------------------------------------------------------------------
# Telemetry and the fastpath oracle
# ---------------------------------------------------------------------------


def test_telemetry_perfetto_json_matches_reference():
    def go(pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(**SMALL, telemetry=True))
        r = sess.run(sess.compile(pkg.ShardedNttOp(512, banks=4)))
        doc = r.telemetry.dumps()
        assert pkg.validate_chrome_trace(json.loads(doc)) == []
        svc = sess.service(pkg.ServicePolicy(telemetry=True, weight_latency=4.0))
        svc.submit_mixed_poisson(sess.compile(pkg.NttOp(256)), 8, 0.1, deadline_us=40.0)
        res = svc.flush()
        return (doc, res.telemetry.dumps(), plain(res.telemetry.request_breakdown()),
                plain(res.stats.summary()))

    port, ref = both(go)
    assert port == ref


@pytest.mark.parametrize("banks", [1, 5])
def test_fastpath_verify_matches_reference(banks):
    def go(pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(num_buffers=2, param_cache_entries=4))
        plan = sess.compile(pkg.PolymulOp(256))
        lp = pkg.lower_plan(sess.cfg, plan)
        g = pkg.evaluate_gang(lp, banks)
        return pkg.fastpath_verify(plan, banks=banks), plain(g)

    port, ref = both(go)
    assert port == ref


def test_fastpath_backend_is_numpy_only():
    """Beside `numpy`, the port's one chain backend is `torch`: the JAX
    package's `jax` backend, or any other name, is refused."""
    sess = pimsys.PimSession(PimConfig(num_buffers=2))
    lp = pimsys.lower_plan(sess.cfg, sess.compile(pimsys.NttOp(256)))
    for backend in ("jax", "warp"):
        with pytest.raises(ValueError, match="unknown backend"):
            pimsys.evaluate_gang(lp, 2, backend=backend)


# The pinned grid of tests/test_fastpath_props.py: (n, banks, entries, nb, pipelined).
FASTPATH_GRID = [(64, 1, 0, 2, True), (64, 16, 128, 2, False), (128, 3, 4, 4, True),
                 (128, 8, 0, 4, False), (256, 5, 128, 2, True), (256, 12, 4, 4, True),
                 (256, 2, 32, 4, True), (256, 8, 32, 4, True)]


@pytest.mark.parametrize("n,banks,entries,nb,pipelined", FASTPATH_GRID)
def test_fastpath_torch_backend_bit_identical(n, banks, entries, nb, pipelined):
    """`backend="torch"` on the CPU (a `torch.cumsum` left fold) equals
    `backend="numpy"`, and the JAX package's `evaluate_gang` on its own
    lowering of the same stream, with `==` on every start, done, end time
    and counter; and the differential oracle accepts it."""
    from repro.pimsys.engine import param_beat_trace as ref_param_beat_trace
    from repro_torch.pimsys.engine import param_beat_trace

    cfg = PimConfig(num_buffers=nb, param_cache_entries=entries)
    cmds = mapping.RowCentricMapper(cfg, n).commands()
    trace = param_beat_trace(cfg, n, cmds) if entries else None
    lp = pimsys.lower_commands(cfg, cmds, trace)
    a = pimsys.evaluate_gang(lp, banks, pipelined=pipelined)
    b = pimsys.evaluate_gang(lp, banks, pipelined=pipelined, backend="torch", device="cpu")
    assert plain(a) == plain(b)
    assert np.array_equal(a.starts, b.starts) and np.array_equal(a.dones, b.dones)
    ref_cfg = RefPimConfig(num_buffers=nb, param_cache_entries=entries)
    ref_cmds = ref_mapping.RowCentricMapper(ref_cfg, n).commands()
    ref_trace = ref_param_beat_trace(ref_cfg, n, ref_cmds) if entries else None
    r = ref_pimsys.evaluate_gang(ref_pimsys.lower_commands(ref_cfg, ref_cmds, ref_trace), banks,
                                 pipelined=pipelined)
    assert plain(r) == plain(b)
    assert np.array_equal(r.starts, b.starts) and np.array_equal(r.dones, b.dones)
    g = pimsys.verify_stream(cfg, cmds, banks, param_trace=trace, pipelined=pipelined,
                             backend="torch", device="cpu")
    assert g.makespan_ns == a.makespan_ns


def test_fastpath_torch_backend_needs_a_card_or_the_cpu():
    sess = pimsys.PimSession(PimConfig(num_buffers=2))
    plan = sess.compile(pimsys.NttOp(256))
    if not torch.cuda.is_available():
        lp = pimsys.lower_plan(sess.cfg, plan)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pimsys.evaluate_gang(lp, 2, backend="torch")
    assert pimsys.fastpath_verify(plan, banks=3, backend="torch", device="cpu") == \
        pimsys.fastpath_verify(plan, banks=3)
