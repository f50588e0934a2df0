"""The port's simulator core (`repro_torch.core`: pim_config, area, mapping,
pimsim, polymul) against the JAX package's on the same inputs.

  1. every record of `tests/golden/engine_goldens.json`, replayed through
     the port exactly as `tests/test_engine.py` replays it through the
     reference: ns, latency, bus-busy, analytic bound and stats, with `==`;
  2. both golden traces byte-equal, and replaying to the live timing, as
     `tests/test_sharded.py` checks the reference;
  3. the mapper's command streams, the functional bank's values and the
     cycle model, port against reference (values numpy uint32 from a seed);
  4. each legacy shim emits exactly one DeprecationWarning and gives the
     reference shim's result;
  5. module-level state (mapper counters) is per package: no crosstalk.
"""
import dataclasses
import json
import os
import warnings

import numpy as np
import pytest

from repro.core import area as ref_area
from repro.core import mapping as ref_mapping
from repro.core import ntt as ref_ntt
from repro.core import pimsim as ref_pimsim
from repro.core import polymul as ref_polymul
from repro.core.pim_config import EnergyModel as RefEnergyModel
from repro.core.pim_config import PimConfig as RefPimConfig
from repro.pimsys import PimSession as RefPimSession
from repro_torch.core import area, mapping, pimsim, polymul
from repro_torch.core import modmath as mm
from repro_torch.core import ntt
from repro_torch.core.mapping import RowCentricMapper
from repro_torch.core.pim_config import EnergyModel, PimConfig
from repro_torch.core.pimsim import BankTimer, analytic_multibank_bound
from repro_torch.pimsys import (
    ChannelController,
    NttJob,
    PimSession,
    PolymulJob,
    RequestScheduler,
    ShardedNttPlan,
    dumps_trace,
    loads_trace,
    param_beat_trace,
    replay_trace,
)
from repro.pimsys import param_beat_trace as ref_param_beat_trace

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")
Q = mm.DEFAULT_Q


def _goldens():
    with open(os.path.join(GOLDEN_DIR, "engine_goldens.json")) as f:
        return json.load(f)


def rand_poly(n, seed):
    return np.random.default_rng(seed).integers(0, Q, n).astype(np.uint32)


def plain(x):
    """A value of either package as plain python, so that `==` compares the
    two: dataclasses and objects become (class name, fields), dicts keep
    their insertion order, arrays become (dtype, shape, values), NaN the
    string "nan" (it equals nothing, not even itself)."""
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, plain(x.tolist()))
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and x != x:
        return "nan"
    if isinstance(x, dict):
        return [(plain(k), plain(v)) for k, v in x.items()]
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, [(f.name, plain(getattr(x, f.name)))
                                   for f in dataclasses.fields(x)])
    if hasattr(x, "__dict__") and not isinstance(x, type):
        return (type(x).__name__, plain(vars(x)))
    return x


def cfg_pair(**kw):
    return PimConfig(**kw), RefPimConfig(**kw)


# ---------------------------------------------------------------------------
# 1. golden records, exactly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rec", _goldens()["single"],
                         ids=lambda r: f"n{r['n']}-nb{r['nb']}-f{int(r['forward'])}")
def test_golden_single_bank(rec):
    cfg = PimConfig(num_buffers=rec["nb"])
    cmds = RowCentricMapper(cfg, rec["n"], forward=rec["forward"]).commands()
    assert len(cmds) == rec["commands"]
    r = BankTimer(cfg).simulate(cmds)
    assert r.ns == rec["ns"]
    assert dict(sorted(r.stats.items())) == rec["stats"]


@pytest.mark.parametrize("rec", _goldens()["multibank"],
                         ids=lambda r: f"n{r['n']}-nb{r['nb']}-b{r['banks']}-{r['policy']}")
def test_golden_multibank(rec):
    cfg = PimConfig(num_buffers=rec["nb"])
    cmds = RowCentricMapper(cfg, rec["n"]).commands()
    ctrl = ChannelController(cfg, policy=rec["policy"])
    for i in range(rec["banks"]):
        ctrl.enqueue(ctrl.add_bank(), cmds, job_id=i)
    ctrl.drain()
    assert ctrl.makespan_ns == rec["latency_ns"]
    assert ctrl.bus_busy_ns == rec["bus_busy_ns"]
    assert analytic_multibank_bound(rec["n"], rec["banks"], cfg) == rec["analytic_ns"]


@pytest.mark.parametrize("rec", _goldens()["sharded"],
                         ids=lambda r: f"n{r['n']}-b{r['banks']}-f{int(r['forward'])}")
def test_golden_sharded(rec):
    cfg = PimConfig(num_buffers=rec["nb"], num_channels=rec["channels"],
                    num_banks=rec["banks_per_rank"])
    r = ShardedNttPlan(cfg, rec["n"], rec["banks"],
                       forward=rec["forward"]).simulate(baseline=False)
    assert r.latency_ns == rec["latency_ns"]
    assert r.local_ns == rec["local_ns"]
    assert r.exchange_ns == rec["exchange_ns"]
    assert (r.xfer_atoms, r.xfer_hops) == (rec["xfer_atoms"], rec["xfer_hops"])


def test_golden_scheduler():
    rec = _goldens()["scheduler"][0]
    cfg = PimConfig(num_buffers=2, num_channels=2, num_banks=2)
    jobs = [NttJob(512), PolymulJob(256), NttJob(1024), NttJob(512),
            PolymulJob(512), NttJob(256)]
    closed = RequestScheduler(cfg).run_closed_loop(jobs)
    assert [float(x) for x in closed.done_ns] == rec["closed_done_ns"]
    assert closed.makespan_ns == rec["closed_makespan_ns"]
    open_ = RequestScheduler(cfg).run_open_loop(jobs, rate_per_us=0.1, seed=3)
    assert [float(x) for x in open_.done_ns] == rec["open_done_ns"]
    assert open_.makespan_ns == rec["open_makespan_ns"]


# ---------------------------------------------------------------------------
# 2. golden traces
# ---------------------------------------------------------------------------

GOLDEN_TRACES = {
    "sharded_n256_b4.trace": (dict(num_buffers=2, num_channels=2, num_banks=2), 256, 4),
    "sharded_n512_b2.trace": (dict(num_buffers=4, num_channels=1, num_banks=2), 512, 2),
}


@pytest.mark.parametrize("fname", sorted(GOLDEN_TRACES))
def test_golden_trace_byte_equal_and_replays(fname):
    kw, n, banks = GOLDEN_TRACES[fname]
    cfg = PimConfig(**kw)
    plan = ShardedNttPlan(cfg, n, banks)
    text = dumps_trace(plan.trace_streams())
    with open(os.path.join(GOLDEN_DIR, fname)) as f:
        golden = f.read()
    assert text == golden
    dev = replay_trace(cfg, loads_trace(golden))
    assert dev.makespan_ns == plan.simulate(baseline=False).local_ns


# ---------------------------------------------------------------------------
# 3. mapper, functional bank and cycle model against the reference
# ---------------------------------------------------------------------------


def test_config_energy_and_area_match():
    cfg, ref = cfg_pair()
    assert plain(cfg) == plain(ref)
    assert plain(EnergyModel()) == plain(RefEnergyModel())
    assert plain(cfg.with_(num_buffers=4)) == plain(ref.with_(num_buffers=4))
    assert area.fit_area_model() == ref_area.fit_area_model()
    for nb in (1, 2, 4, 6):
        assert area.cu_area_mm2(nb) == ref_area.cu_area_mm2(nb)
        assert area.area_overhead_pct(nb) == ref_area.area_overhead_pct(nb)
    assert area.newton_overhead_pct() == ref_area.newton_overhead_pct()


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("nb", [1, 2, 4])
@pytest.mark.parametrize("n", [256, 1024])
def test_mapper_streams_and_cycles_match(n, nb, forward):
    cfg, ref = cfg_pair(num_buffers=nb, param_cache_entries=8)
    cmds = RowCentricMapper(cfg, n, forward=forward).commands()
    ref_cmds = ref_mapping.RowCentricMapper(ref, n, forward=forward).commands()
    assert plain(cmds) == plain(ref_cmds)
    assert [mapping.cu_twiddle_indices(cfg, n, c) for c in cmds] == \
        [ref_mapping.cu_twiddle_indices(ref, n, c) for c in ref_cmds]
    trace = param_beat_trace(cfg, n, cmds)
    assert plain(trace) == plain(ref_param_beat_trace(ref, n, ref_cmds))
    r = BankTimer(cfg).simulate(cmds, trace)
    r_ref = ref_pimsim.BankTimer(ref).simulate(ref_cmds, ref_param_beat_trace(ref, n, ref_cmds))
    assert plain(r) == plain(r_ref)


@pytest.mark.parametrize("forward", [False, True])
@pytest.mark.parametrize("n", [64, 512])
def test_pim_ntt_values_match(n, forward):
    cfg, ref = cfg_pair(num_buffers=2)
    a = rand_poly(n, n + forward)
    out, cmds = mapping.pim_ntt(a, ntt.make_context(Q, n), cfg, forward=forward)
    exp, ref_cmds = ref_mapping.pim_ntt(a, ref_ntt.make_context(Q, n), ref, forward=forward)
    assert out.dtype == np.uint32 and np.array_equal(out, np.asarray(exp))
    assert plain(cmds) == plain(ref_cmds)
    oracle = ntt.ntt_forward_np if forward else ntt.ntt_inverse_np
    assert np.array_equal(out, oracle(a, ntt.make_context(Q, n)))


def test_polymul_phases_and_commands_match():
    cfg, ref = cfg_pair(num_buffers=2)
    phases, row_b = polymul.polymul_phases(cfg, 512)
    ref_phases, ref_row_b = ref_polymul.polymul_phases(ref, 512)
    assert row_b == ref_row_b and plain(phases) == plain(ref_phases)
    assert plain(polymul.pointwise_commands(cfg, 512, 0, 8)) == \
        plain(ref_polymul.pointwise_commands(ref, 512, 0, 8))
    assert plain(polymul.scaling_commands(cfg, 512, 4)) == \
        plain(ref_polymul.scaling_commands(ref, 512, 4))


# ---------------------------------------------------------------------------
# 4. legacy shims: one DeprecationWarning each, the reference's result
# ---------------------------------------------------------------------------

SHIMS = {
    "simulate_ntt": lambda m, cfg, a, ctx: m["pimsim"].simulate_ntt(256, cfg),
    "simulate_multibank": lambda m, cfg, a, ctx: m["pimsim"].simulate_multibank(256, 2, cfg),
    "simulate_ntt_sharded": lambda m, cfg, a, ctx: m["pimsim"].simulate_ntt_sharded(256, 2, cfg),
    "pim_polymul": lambda m, cfg, a, ctx: m["polymul"].pim_polymul(a, a, ctx, cfg),
    "pim_ntt_sharded": lambda m, cfg, a, ctx: m["polymul"].pim_ntt_sharded(a, ctx, cfg, banks=2),
    "polymul_batch": lambda m, cfg, a, ctx: m["polymul"].polymul_batch(256, 2, cfg),
    "PimSession.submit": lambda m, cfg, a, ctx: m["session"](cfg).submit(m["PolymulOp"](256), count=2),
}


def _call_shim(name, port: bool):
    import repro.pimsys as ref_pimsys
    import repro_torch.pimsys as pimsys

    if port:
        m = {"pimsim": pimsim, "polymul": polymul, "session": PimSession,
             "PolymulOp": pimsys.PolymulOp}
        cfg, ctx = PimConfig(num_buffers=2, num_channels=2, num_banks=2), ntt.make_context(Q, 256)
    else:
        m = {"pimsim": ref_pimsim, "polymul": ref_polymul, "session": RefPimSession,
             "PolymulOp": ref_pimsys.PolymulOp}
        cfg = RefPimConfig(num_buffers=2, num_channels=2, num_banks=2)
        ctx = ref_ntt.make_context(Q, 256)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = SHIMS[name](m, cfg, rand_poly(256, 9), ctx)
    return out, [x for x in w if issubclass(x.category, DeprecationWarning)]


@pytest.mark.parametrize("name", sorted(SHIMS))
def test_legacy_shim_warns_once_and_matches(name):
    out, dep = _call_shim(name, port=True)
    assert len(dep) == 1, f"{name}: {len(dep)} DeprecationWarnings"
    assert name in str(dep[0].message) and "repro_torch" in str(dep[0].message)
    exp, _ = _call_shim(name, port=False)
    if name == "PimSession.submit":
        out, exp = (out.timing, out.stats), (exp.timing, exp.stats)
    assert plain(out) == plain(exp)


# ---------------------------------------------------------------------------
# 5. module-level state is per package
# ---------------------------------------------------------------------------


def test_mapper_counters_are_per_package():
    port0, ref0 = mapping.mapper_generations(), ref_mapping.mapper_generations()
    RowCentricMapper(PimConfig(), 256).commands()
    assert mapping.mapper_generations() == port0 + 1
    assert ref_mapping.mapper_generations() == ref0
    ref_mapping.RowCentricMapper(RefPimConfig(), 256).commands()
    assert ref_mapping.mapper_generations() == ref0 + 1
    assert mapping.mapper_generations() == port0 + 1


def test_reference_config_is_refused():
    with pytest.raises(TypeError, match="PimConfig"):
        PimSession(RefPimConfig())
    assert PimConfig() != RefPimConfig()
