"""The port's train step and training loop (`repro_torch.launch.{steps,
train,roofline}`) on the CPU: one whole `make_train_step` step against the
JAX package's, twins of `tests/test_substrate.py`'s train-loop tests,
`tests/test_archs.py::test_train_step_updates_params` and
`tests/test_perf_variants.py::test_train_step_works_with_all_perf_flags`,
the step's effect on a served model, `train`'s device rule, and
`chip_smoke.py`'s train phase rehearsed at a small size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import get_config as ref_get_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import roofline as ref_roofline
from repro.launch import steps as ref_steps
from repro.models import transformer as RT
from repro.optim import OptConfig as RefOptConfig
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.launch import roofline, steps
from repro_torch.launch import serve as serve_lib
from repro_torch.launch.serve import make_inputs, to_device
from repro_torch.launch.train import FaultInjector, train
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import OptConfig
from repro_torch.tree import leaves
from test_torch_grads import TOL_GRAD, TOL_LOSS, grad_tol, one_thread, rel_err  # noqa: F401

# One step from zero moments at step 1 moves each weight by lr x 0.735 x
# sign(grad) (+ decay): where the two packages' grads differ in sign (tiny
# grads) the params differ by 2 x 0.735 x lr = 1.47 lr, and otherwise by
# rounding.  m = 0.1 g and v = 0.05 g^2 carry the grads' relative error
# (v twice it).  grad_norm: worst 5.6e-4 relative (mamba2).
TOL_GRAD_NORM = 1.2e-3


@pytest.mark.parametrize("arch,moments", [("qwen3-4b", "float32"), ("mamba2-780m", "bfloat16"),
                                          ("qwen3-moe-30b-a3b", "float32")])
def test_train_step_matches_reference(arch, moments):
    ref_cfg = ref_get_config(arch).reduced(capacity_factor=8.0)
    cfg = get_config(arch).reduced(capacity_factor=8.0)
    ref_opt = RefOptConfig(total_steps=10, warmup_steps=1, moment_dtype=moments)
    opt = OptConfig(total_steps=10, warmup_steps=1, moment_dtype=moments)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    state = ref_steps.make_opt_init(ref_cfg, ref_opt)(params)
    inputs = make_inputs(ref_cfg, 2, 16, seed=0)
    pt, st = (params_from_reference(jax.tree.map(np.asarray, t), device="cpu") for t in (params, state))
    jp, js, jm = ref_steps.make_train_step(ref_cfg, ref_opt)(
        params, state, {k: jnp.asarray(v) for k, v in inputs.items()}, jnp.int32(1))
    tp, ts, tm = steps.make_train_step(cfg, opt)(pt, st, to_device(inputs, "cpu"), 1)
    assert float(tm["lr"]) == float(jm["lr"])
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= TOL_GRAD_NORM * float(jm["grad_norm"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 0.01 * float(jm["loss"])
    lr = float(jm["lr"])
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(jp)[0], leaves(tp)):
        assert str(a.dtype) == str(b.dtype).removeprefix("torch.")
        assert float(np.abs(np.asarray(a, np.float32) - b.float().numpy()).max()) <= 1.5 * lr, path
    for name, scale in (("m", 1), ("v", 2)):
        for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(js[name])[0], leaves(ts[name])):
            key = jax.tree_util.keystr(path)
            assert str(a.dtype) == moments and b.dtype == getattr(torch, moments)
            assert rel_err(a, b) <= scale * grad_tol(key, TOL_GRAD), (name, key)


#: Steps of the train trajectory held against the reference, on
#: `chip_smoke.py`'s schedule (warmup_steps=1, total_steps=steps + 1).
TRAJECTORY_STEPS = 4


def test_train_trajectory_matches_reference():
    """Steps 1..4 of reduced qwen3-4b in both packages from the same weights
    (`params_from_reference`) on the same `SyntheticStream` batches (4 x
    32), with `chip_smoke.py`'s schedule and its bf16 AdamW moments for
    qwen3-4b, each package on its own params and state: every step's loss
    within `TOL_LOSS` and its grad norm within `TOL_GRAD_NORM` of the
    reference's."""
    moments = "bfloat16"
    ref_cfg, cfg = ref_get_config("qwen3-4b").reduced(), get_config("qwen3-4b").reduced()
    ref_opt = RefOptConfig(moment_dtype=moments, warmup_steps=1, total_steps=TRAJECTORY_STEPS + 1)
    opt = OptConfig(moment_dtype=moments, warmup_steps=1, total_steps=TRAJECTORY_STEPS + 1)
    jp = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    js = ref_steps.make_opt_init(ref_cfg, ref_opt)(jp)
    tp, ts = (params_from_reference(jax.tree.map(np.asarray, t), device="cpu") for t in (jp, js))
    ref_step, port_step = ref_steps.make_train_step(ref_cfg, ref_opt), steps.make_train_step(cfg, opt)
    stream = SyntheticStream(cfg, 4, 32, seed=0)
    rows = []
    for step in range(1, TRAJECTORY_STEPS + 1):
        batch = stream.batch_at(step)
        jp, js, jm = ref_step(jp, js, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.int32(step))
        tp, ts, tm = port_step(tp, ts, to_device(batch, "cpu"), step)
        rows.append({k: (float(jm[k]), float(tm[k])) for k in ("loss", "grad_norm", "lr")})
    for row in rows:
        assert row["lr"][0] == row["lr"][1], rows
        (jl, tl), (jg, tg) = row["loss"], row["grad_norm"]
        assert abs(tl - jl) <= TOL_LOSS * jl and abs(tg - jg) <= TOL_GRAD_NORM * jg, rows


def _step_moves_params(cfg, batch):
    """`test_archs.py::test_train_step_updates_params` on the port: step 1
    (step 0 has lr == 0 under linear warmup), loss finite, a weight moved,
    shapes and dtypes kept."""
    opt_cfg = OptConfig(total_steps=10, warmup_steps=1)
    gen = torch.Generator().manual_seed(0)
    params = PT.init_params(cfg, gen, "cpu")
    before = [p.clone() for p in leaves(params)]
    opt_state = steps.make_opt_init(cfg, opt_cfg)(params)
    new_params, _, metrics = steps.make_train_step(cfg, opt_cfg)(params, opt_state, batch, 1)
    assert np.isfinite(float(metrics["loss"]))
    after = leaves(new_params)
    assert max(float((a.float() - b.float()).abs().max()) for a, b in zip(after, before)) > 0
    assert all(a.shape == b.shape and a.dtype == b.dtype for a, b in zip(after, before))


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_updates_params(arch):
    cfg = get_config(arch).reduced()
    batch = SyntheticStream(cfg, 2, 16, seed=0).batch_at(0)
    _step_moves_params(cfg, to_device(batch, "cpu"))


def test_train_step_works_with_all_perf_flags():
    """Optimized production settings still train (loss finite, params move)."""
    cfg = dataclasses.replace(get_config("qwen3-moe-30b-a3b").reduced(), moe_dispatch="local", remat=False)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)
    _step_moves_params(cfg, {"tokens": torch.from_numpy(tokens)})


def test_train_step_keeps_serving_unchanged(monkeypatch):
    """Serve, then a train step on the served model's own (frozen) params,
    in one process: the step updates them in place, leaves them frozen,
    holds f32 accumulation through the backward, and the model serves on
    with the new weights (nothing cached under inference mode reaches the
    backward)."""
    from repro_torch.models import layers as PL

    res = serve_lib.serve("qwen3-4b", batch=2, prompt_len=8, gen=3, device="cpu")
    model, cfg = res["model"], res["model"].cfg
    params = model.params
    frozen = [p for p in leaves(params)]
    before = [p.detach().clone() for p in frozen]
    opt_cfg = OptConfig(total_steps=10, warmup_steps=1)
    opt_state = steps.make_opt_init(cfg, opt_cfg)(params)
    flag = torch.backends.cuda.matmul
    seen, rmsnorm = [], PL.rmsnorm

    def spy(*args, **kwargs):  # called in the forward and again in the backward's recompute
        seen.append(flag.allow_bf16_reduced_precision_reduction)
        return rmsnorm(*args, **kwargs)

    monkeypatch.setattr(PL, "rmsnorm", spy)
    monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction", True)
    batch = to_device(SyntheticStream(cfg, 2, 16, seed=0).batch_at(1), "cpu")
    steps.make_train_step(dataclasses.replace(cfg, remat=True), opt_cfg)(params, opt_state, batch, 1)
    assert seen and not any(seen) and flag.allow_bf16_reduced_precision_reduction
    assert len(seen) == (4 * cfg.reps + 1) + 4 * cfg.reps  # forward (4 a rep, the final norm), recompute
    monkeypatch.setattr(PL, "rmsnorm", rmsnorm)
    assert all(p is q and not p.requires_grad for p, q in zip(leaves(model.params), frozen))
    assert any(not torch.equal(p, b) for p, b in zip(frozen, before))
    again = serve_lib.generate(model, res["inputs"], 8, 3)
    assert again["generated"].shape == (2, 3)


def test_roofline_counts_equal_the_reference():
    for arch in ARCH_NAMES:
        for reduce in (False, True):
            cfg, ref_cfg = get_config(arch), ref_get_config(arch)
            if reduce:
                cfg, ref_cfg = cfg.reduced(), ref_cfg.reduced()
            assert roofline.count_params(cfg) == ref_roofline.count_params(ref_cfg)
            for name in SHAPES:
                assert roofline.model_flops(cfg, SHAPES[name]) == ref_roofline.model_flops(ref_cfg, REF_SHAPES[name])


# ---------------------------------------------------------------------------
# the training loop: twins of tests/test_substrate.py
# ---------------------------------------------------------------------------


def test_train_loop_resume_and_fault_injection(tmp_path):
    kwargs = dict(arch="qwen3-4b", batch=4, seq=64, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=100,
                  device="cpu")
    # phase 1: run 10 steps
    _, _, hist1 = train(steps=10, **kwargs)
    assert [h["step"] for h in hist1] == list(range(10))
    # phase 2: resume at 10 (not 0); the injected fault at 13 rolls back to
    # the checkpoint at 10 and re-runs 10..12 with the same data
    injector = FaultInjector([13])
    params, opt_state, hist2 = train(steps=16, injector=injector, **kwargs)
    assert [h["step"] for h in hist2] == [10, 11, 12, 10, 11, 12, 13, 14, 15]
    losses = {}
    for h in hist2:
        assert losses.setdefault(h["step"], h["loss"]) == h["loss"]  # the retried steps repeat exactly
    from repro_torch.ckpt.checkpoint import CheckpointManager

    restored, manifest = CheckpointManager(str(tmp_path)).restore(16, (params, opt_state), device="cpu")
    assert manifest["step"] == 16
    assert all(torch.equal(a, b) for a, b in zip(leaves((params, opt_state)), leaves(restored)))


def test_train_loss_decreases(tmp_path):
    _, _, hist = train(arch="qwen3-4b", steps=30, batch=8, seq=64, ckpt_dir=str(tmp_path), ckpt_every=50,
                       log_every=100, device="cpu")
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def test_train_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train("qwen3-4b", steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())  # nothing was saved


# ---------------------------------------------------------------------------
# chip_smoke.py's train phase, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------


def test_chip_smoke_train_phase_on_cpu():
    cs = __import__("test_torch_serve")._load_chip_smoke()
    for arch, moments in cs.TRAIN_FULL:
        rec = cs.drive_train_steps(arch, moments, "cpu", batch=2, seq=32, steps=6, reduced=True)
        assert [r["step"] for r in rec["steps"]] == list(range(1, 7)) and rec["moment_dtype"] == moments
        assert rec["launches"] == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0, "chain_fold": 0, "silu_fwd": 0,
                                   "silu_bwd": 0}  # CPU: the plain versions
        assert rec["tokens_per_s"] > 0 and "mfu_vs_bf16_peak" not in rec and "profile" not in rec
    loop = cs.drive_train_loop("cpu")
    assert loop["step_lists"] == [list(range(10)), [10, 11, 12, 10, 11, 12, 13, 14, 15]]
    assert loop["restore_bit_exact"] and loop["retried_losses_equal"]
    for arch in ("whisper-small", "jamba-1.5-large-398b"):
        out = cs.train_card_vs_cpu(get_config(arch).reduced(capacity_factor=8.0), "cpu")
        assert out["max_rel_err"] == 0.0 and out["finite"]  # the CPU against itself
    assert cs.TRAIN_CARD_TOL["*"] <= TOL_GRAD  # the card's bound is no looser than the port-vs-JAX one
