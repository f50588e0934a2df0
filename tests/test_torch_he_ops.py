"""The port's HE device ops (`repro_torch.he.ops`) against `repro.he.ops`.

The four ciphertext ops run through the port's `PimSession` with
`device="cpu"` (the kernels' plain versions) and through the reference's
session on the same inputs: the values must be bit-exact with
`repro.he.rns`, and `HeTimingResult` and the stats equal field by field.
The reference's key is carried over with `keyswitch_key_from_reference`
onto the plan's memoized basis.  Also: the serving and telemetry paths,
the device rules (no card, no fallback), per-package state, and
`chip_smoke.py`'s pimsys phase rehearsed on the CPU at a small size.
"""
import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.he as ref_he
import repro.pimsys as ref_pimsys
import repro_torch.pimsys as pimsys
from repro.core.pim_config import PimConfig as RefPimConfig
from repro_torch import he, kernels
from repro_torch.core import modmath as mm
from repro_torch.core.pim_config import PimConfig
from repro_torch.he import ops as he_ops
from test_torch_sim_core import plain  # one definition for the three files

ROOT = pathlib.Path(__file__).resolve().parents[1]
CFG = dict(num_channels=2, num_banks=4, param_cache_entries=8)
OPS = {"ct_mul": "RlweCtMulOp", "keyswitch": "KeySwitchOp", "rescale": "RescaleOp",
       "ct_mul_relin": "CtMulRelinOp"}


def ref_inputs(kind, basis):
    """The reference's inputs of one op (numpy; the key a reference key)."""
    if kind == "keyswitch":
        return [ref_he.random_poly(basis, 9), ref_he.relin_key(basis, ref_he.make_secret(basis, 0), seed=7)]
    if kind == "rescale":
        return [ref_he.random_ct(basis, 6)]
    ins = [ref_he.random_ct(basis, 1), ref_he.random_ct(basis, 2)]
    if kind == "ct_mul_relin":
        ins.append(ref_he.relin_key(basis, ref_he.make_secret(basis, 0), seed=7))
    return ins


def port_inputs(ins, basis):
    """The same inputs for the port: arrays as they are, the key carried
    over onto the port's basis, on the CPU."""
    return [he.keyswitch_key_from_reference(x, basis, device="cpu")
            if isinstance(x, ref_he.KeySwitchKey) else x for x in ins]


@pytest.mark.parametrize("banks", ["1", "L"])
@pytest.mark.parametrize("towers", [2, 4])
@pytest.mark.parametrize("n", [64, 256])
@pytest.mark.parametrize("kind", sorted(OPS))
def test_he_op_value_and_timing_match_reference(kind, n, towers, banks):
    nb = 1 if banks == "1" else towers
    ref_sess = ref_pimsys.PimSession(RefPimConfig(**CFG))
    ref_plan = ref_sess.compile(getattr(ref_he, OPS[kind])(n=n, towers=towers, banks=nb))
    ref_basis = ref_he.basis_for(ref_plan.op)
    ins = ref_inputs(kind, ref_basis)
    exp = ref_sess.run(ref_plan, *ins)

    sess = pimsys.PimSession(PimConfig(**CFG), device="cpu")
    plan = sess.compile(getattr(he, OPS[kind])(n=n, towers=towers, banks=nb))
    basis = he.basis_for(plan.op)
    assert basis.moduli == he.basis_from_reference(ref_basis).moduli
    kernels.reset_launch_counts()
    got = sess.run(plan, *port_inputs(ins, basis))
    assert not any(kernels.launch_counts().values())  # the CPU runs the plain versions

    assert isinstance(got.value, torch.Tensor) and got.value.device.type == "cpu"
    assert got.value.dtype == torch.uint32
    value = mm.to_numpy_u32(got.value)
    assert np.array_equal(value, exp.value)
    ref_fn = getattr(ref_he, kind)
    assert np.array_equal(value, ref_fn(ref_basis, *ins))
    assert plain(got.timing) == plain(exp.timing)
    assert type(got.timing).__name__ == "HeTimingResult"
    assert plain(got.stats) == plain(exp.stats)
    assert plain(got.op) == plain(exp.op) and got.trace is None is exp.trace


@pytest.mark.parametrize("backend", ["engine", "fastpath"])
def test_he_serving_matches_reference(backend):
    def go(pkg, he_pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(**CFG))
        svc = sess.service(pkg.ServicePolicy(weight_latency=4.0, backend=backend))
        futs = svc.submit_mixed_poisson(sess.compile(he_pkg.RlweCtMulOp(n=256, towers=4)), 8, 0.02,
                                        deadline_us=200.0)
        futs += svc.submit_poisson(sess.compile(he_pkg.KeySwitchOp(n=256, towers=2)), 4, 0.01, seed=0)
        futs += svc.submit_poisson(sess.compile(pkg.PolymulOp(256)), 4, 0.05, seed=2)
        res = svc.flush()
        return plain(res.summary()), [plain(f.result()) for f in futs]

    assert go(pimsys, he, PimConfig) == go(ref_pimsys, ref_he, RefPimConfig)


def test_he_telemetry_matches_reference():
    def go(pkg, he_pkg, cfg_cls):
        sess = pkg.PimSession(cfg_cls(num_channels=4, num_banks=2, param_cache_entries=16,
                                      telemetry=True))
        r = sess.run(sess.compile(he_pkg.KeySwitchOp(n=256, towers=4)))
        return r.telemetry.dumps(), plain(r.timing)

    doc, timing = go(pimsys, he, PimConfig)
    assert (doc, timing) == go(ref_pimsys, ref_he, RefPimConfig)
    names = {e["name"] for e in json.loads(doc)["traceEvents"] if e.get("cat") == "phase"}
    assert "base_extend" in names


def test_tensor_inputs_stay_on_their_device_and_numpy_goes_to_the_session_device():
    sess = pimsys.PimSession(PimConfig(**CFG), device="cpu")
    plan = sess.compile(he.RlweCtMulOp(n=64, towers=2))
    basis = he.basis_for(plan.op)
    a, b = he.random_ct(basis, 1, device="cpu"), he.random_ct(basis, 2, device="cpu")
    from_t = sess.run(plan, a, b, time=False)
    assert from_t.timing is None and from_t.stats is None
    from_np = sess.run(plan, mm.to_numpy_u32(a), mm.to_numpy_u32(b), time=False)
    assert torch.equal(from_t.value.view(torch.int32), from_np.value.view(torch.int32))
    # with no device named, tensors stay where they are
    default = pimsys.PimSession(PimConfig(**CFG))
    r = default.run(default.compile(he.RlweCtMulOp(n=64, towers=2)), a, b, time=False)
    assert r.value.device.type == "cpu"


def test_no_card_raises_and_nothing_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ref_basis = ref_he.make_basis(64, 2)
    ins = ref_inputs("ct_mul", ref_basis)
    for sess in (pimsys.PimSession(PimConfig(**CFG)), pimsys.PimSession(PimConfig(**CFG), device="cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sess.run(sess.compile(he.RlweCtMulOp(n=64, towers=2)), *ins, time=False)


def test_key_must_come_from_the_plans_basis():
    sess = pimsys.PimSession(PimConfig(**CFG), device="cpu")
    plan = sess.compile(he.KeySwitchOp(n=64, towers=2))
    ref_basis = ref_he.make_basis(64, 2)
    c2, ref_key = ref_inputs("keyswitch", ref_basis)
    foreign = he.basis_from_reference(ref_basis)  # equal moduli, another object
    assert foreign is not he.basis_for(plan.op)
    with pytest.raises(ValueError, match="different basis"):
        sess.run(plan, c2, he.keyswitch_key_from_reference(ref_key, foreign, device="cpu"))
    with pytest.raises(TypeError, match="KeySwitchKey"):
        sess.run(plan, c2, ref_key)


def test_plans_and_registries_are_per_package():
    sess = pimsys.PimSession(PimConfig(**CFG))
    op = he.CtMulRelinOp(n=64, towers=2)
    assert sess.compile(op) is sess.compile(op)
    assert pimsys.op_handler(op) is he_ops._HANDLER
    assert ref_pimsys.op_handler(op) is None
    assert pimsys.op_handler(ref_he.CtMulRelinOp(n=64, towers=2)) is None
    assert he.basis_for(op) is he.make_basis(64, 2)
    with pytest.raises(TypeError):
        sess.compile(ref_he.CtMulRelinOp(n=64, towers=2))


def test_direct_fastpath_run_is_refused():
    sess = pimsys.PimSession(PimConfig(**CFG))
    with pytest.raises(ValueError, match="fastpath"):
        sess.run(sess.compile(he.RescaleOp(n=64, towers=2)), backend="fastpath")


# ---------------------------------------------------------------------------
# chip_smoke.py's pimsys phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_pimsys_phase_on_cpu():
    cs = _load_chip_smoke()
    kept = {}
    cs.drive_rns("cpu", n=1024, towers=3, sample=1, keep=kept)
    card = cs.drive_pimsys("cpu", kept, cfg=CFG, reps=1)
    assert card["value_bit_exact_vs_rns_phase"]
    assert card["launches"] == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0}  # CPU: plain versions
    assert card["expected_launches"] == cs.rns_launches(1024, 3, "ct_mul_relin")
    names = cs.golden_names()
    assert len(names) == 55 and len(set(names)) == 55
    picked = [n for n in names if n.startswith(("sharded/", "scheduler/"))] + names[:4]
    replay = cs.replay_goldens(names=picked)
    assert replay["records"] == picked and replay["mismatches"] == []
    mix = cs.he_mix_points(levels=(2,))
    assert mix["mismatches"] == [] and len(mix["modeled_us"]) == 4
    committed = {p["name"]: p["us_per_call"]
                 for p in json.loads((ROOT / "BENCH_he.json").read_text())["points"]}
    assert all(committed[k] == v for k, v in mix["modeled_us"].items())
    modeled = cs.modeled_latency(256, 2, cfg=CFG)
    ref_sess = ref_pimsys.PimSession(RefPimConfig(**CFG))
    ref_t = ref_sess.run(ref_sess.compile(ref_he.CtMulRelinOp(n=256, towers=2))).timing
    assert modeled["modeled_pim_latency_us"] == ref_t.latency_ns / 1e3


def test_chip_smoke_golden_replay_catches_a_wrong_record(tmp_path):
    cs = _load_chip_smoke()
    g = json.loads((ROOT / "tests" / "golden" / "engine_goldens.json").read_text())
    g["sharded"][0]["latency_ns"] += 1e-9
    path = tmp_path / "goldens.json"
    path.write_text(json.dumps(g))
    name = cs.golden_names(str(path))[48]
    assert name.startswith("sharded/")
    out = cs.replay_goldens(str(path), names=[name])
    assert [m["record"] for m in out["mismatches"]] == [name]
