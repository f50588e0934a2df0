"""The port's serving path (`repro_torch.launch.serve`, `steps`) on the CPU.

The greedy loop on the reference's weights (carried by
`params_from_reference`) against the JAX package's `serve` for the dense
archs; the prefill/decode self-consistency of `tests/test_archs.py` on the
port's own weights; and the entry point's device rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as ref_get_config
from repro.launch import serve as ref_serve
from repro.launch import steps as ref_steps
from repro.models import transformer as RT
from repro_torch.configs.registry import get_config
from repro_torch.launch import serve as serve_lib
from repro_torch.launch import steps
from repro_torch.models import transformer as PT
from repro_torch.models.convert import params_from_reference

DENSE = ["qwen3-4b", "qwen3-8b", "command-r-35b", "deepseek-coder-33b"]
BATCH, PROMPT, GEN = 2, 16, 4
# The largest |port - reference| logit over these archs' prefill and decode
# steps, against the reference's jitted steps, measured 0.039; a step whose
# reference top-2 margin is below twice that is teacher-forced, not compared.
MARGIN = 0.078


def _margin(logits) -> float:
    s = np.sort(np.asarray(logits, np.float32), axis=-1)
    return float((s[:, -1] - s[:, -2]).min())


@pytest.mark.parametrize("arch", DENSE)
def test_greedy_tokens_match_reference_serve(arch):
    ref = ref_serve.serve(arch, batch=BATCH, prompt_len=PROMPT, gen=GEN)
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))  # serve's weights for seed 0
    inputs = serve_lib.make_inputs(cfg, BATCH, PROMPT, seed=0)
    model = PT.Transformer(cfg, params_from_reference(jax.tree.map(np.asarray, params), device="cpu"))

    # the reference's loop, step by step through its own jitted steps
    prefill = jax.jit(ref_steps.make_prefill_step(ref_cfg, PROMPT + GEN))
    decode = jax.jit(ref_steps.make_decode_step(ref_cfg))
    lj, cj = prefill(params, {k: jnp.asarray(v) for k, v in inputs.items()})
    ref_logits = [lj]
    for i in range(GEN - 1):
        lj, cj = decode(params, jnp.asarray(ref["generated"][:, i]), cj, jnp.int32(PROMPT + i))
        ref_logits.append(lj)
    assert np.array_equal(np.stack([np.argmax(np.asarray(l, np.float32), -1) for l in ref_logits], 1),
                          ref["generated"])

    # the port, teacher-forced by the reference's tokens
    with torch.inference_mode():
        lt, ct = model.prefill(serve_lib.to_device(inputs, "cpu"), PROMPT + GEN)
        port_logits = [lt]
        for i in range(GEN - 1):
            lt, ct = model.decode_step(torch.from_numpy(ref["generated"][:, i]), ct, PROMPT + i)
            port_logits.append(lt)
    compared = 0
    for i, (a, b) in enumerate(zip(ref_logits, port_logits)):
        a, b = np.asarray(a, np.float32), b.float().numpy()
        assert np.abs(a - b).max() <= MARGIN, i
        if _margin(a) >= MARGIN:
            assert np.array_equal(np.argmax(b, -1), ref["generated"][:, i]), i
            compared += 1
    assert compared >= GEN - 1
    if all(_margin(a) >= MARGIN for a in ref_logits):  # then the free-running loop agrees too
        out = serve_lib.generate(model, serve_lib.to_device(inputs, "cpu"), PROMPT, GEN)
        assert np.array_equal(out["generated"], ref["generated"])


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-780m", "jamba-1.5-large-398b", "whisper-small"])
def test_prefill_decode_consistency(arch):
    """Serving path == scoring path on the port's own weights (high MoE
    capacity to avoid drops), with `tests/test_archs.py`'s bounds."""
    cfg = get_config(arch).reduced(capacity_factor=8.0)
    model = PT.Transformer.init(cfg, 0, "cpu")
    b, s = 2, 16
    batch = serve_lib.to_device(serve_lib.make_inputs(cfg, b, s, seed=0), "cpu")
    with torch.inference_mode():
        full_logits, _ = model(batch)
        pre = dict(batch, tokens=batch["tokens"][:, : s - 2])
        logits_pre, caches = model.prefill(pre, cache_len=s)
        np.testing.assert_allclose(logits_pre.float().numpy(), full_logits[:, s - 3].float().numpy(),
                                   rtol=0.2, atol=0.2)
        lg, caches = model.decode_step(batch["tokens"][:, s - 2], caches, s - 2)
        np.testing.assert_allclose(lg.float().numpy(), full_logits[:, s - 2].float().numpy(),
                                   rtol=0.2, atol=0.2)


def test_steps_are_the_model_entry_points():
    cfg = get_config("qwen3-4b").reduced()
    model = PT.Transformer.init(cfg, 1, "cpu")
    batch = serve_lib.to_device(serve_lib.make_inputs(cfg, 2, 8, seed=1), "cpu")
    with torch.inference_mode():
        la, ca = steps.make_prefill_step(cfg, 12)(model.params, batch)
        lb, cb = model.prefill(batch, 12)
        assert torch.equal(la, lb)
        tok = torch.argmax(la, -1)
        da, _ = steps.make_decode_step(cfg)(model.params, tok, ca, 8)
        db, _ = model.decode_step(tok, cb, 8)
        assert torch.equal(da, db)


def test_make_inputs_are_the_reference_draws():
    """The prompt, image embeddings and frames of the reference's `serve`."""
    for arch in ("llama-3.2-vision-11b", "whisper-small"):
        cfg = get_config(arch).reduced()
        got = serve_lib.make_inputs(cfg, 2, 8, seed=3)
        rng = np.random.default_rng(3)
        want = {"tokens": np.asarray(jnp.asarray(rng.integers(1, cfg.vocab_size - 1, (2, 8)), jnp.int32))}
        if cfg.num_image_tokens:
            want["image_embeds"] = np.asarray(jnp.asarray(
                rng.standard_normal((2, cfg.num_image_tokens, cfg.d_model)), jnp.float32))
        if cfg.encoder_layers:
            want["frames"] = np.asarray(jnp.asarray(
                rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)), jnp.float32))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def test_serve_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_lib.serve("qwen3-4b", batch=1, prompt_len=4, gen=2)


def test_model_entry_points_default_to_the_card(monkeypatch):
    from repro_torch.models.convert import tensor_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-4b").reduced()
    for call in (lambda: params_from_reference({"w": np.zeros(2, np.float32)}),
                 lambda: tensor_from_numpy(np.zeros(2, np.float32)),
                 lambda: PT.init_cache(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_entry_points_sum_bf16_products_in_f32(monkeypatch):
    """Inside forward / prefill / decode_step, cuBLAS may not reduce bf16
    partial sums in bf16; the global flag is restored after each call."""
    from repro_torch.models import layers as PL

    flag = torch.backends.cuda.matmul
    seen, rmsnorm = [], PL.rmsnorm

    def spy(*args, **kwargs):
        seen.append(flag.allow_bf16_reduced_precision_reduction)
        return rmsnorm(*args, **kwargs)

    monkeypatch.setattr(PL, "rmsnorm", spy)
    monkeypatch.setattr(flag, "allow_bf16_reduced_precision_reduction", True)
    cfg = get_config("qwen3-4b").reduced()
    model = PT.Transformer.init(cfg, 0, "cpu")
    tokens = torch.ones((1, 4), dtype=torch.int32)
    with torch.inference_mode():
        model({"tokens": tokens})
        _, caches = model.prefill({"tokens": tokens}, cache_len=6)
        model.decode_step(tokens[:, 0], caches, 4)
    assert seen and not any(seen)
    assert flag.allow_bf16_reduced_precision_reduction


def test_serve_on_the_cpu_when_asked():
    res = serve_lib.serve("mamba2-780m", batch=2, prompt_len=8, gen=3, device="cpu")
    assert res["device"] == "cpu" and res["generated"].shape == (2, 3)
    assert res["step_ms"] is None and res["tok_per_s"] > 0
    again = serve_lib.generate(res["model"], res["inputs"], 8, 3)
    assert np.array_equal(again["generated"], res["generated"])


# ---------------------------------------------------------------------------
# chip_smoke.py's lm phase, rehearsed on the CPU at a small size
# ---------------------------------------------------------------------------


def _load_chip_smoke():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_lm_phase_on_cpu():
    cs = _load_chip_smoke()
    rec = cs.drive_lm_serve("qwen3-4b", 2, 8, 3, "cpu", reduced=True)
    assert rec["launches"] == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0, "chain_fold": 0, "silu_fwd": 0,
                               "silu_bwd": 0}  # CPU: the plain versions
    assert rec["consistency"]["seq"] == 10 and rec["consistency"]["finite"]
    assert rec["consistency"]["decode_vs_forward"]["ok"] and "profile" not in rec
    for arch in ("whisper-small", "jamba-1.5-large-398b"):
        out = cs.card_vs_cpu(get_config(arch).reduced(capacity_factor=8.0), "cpu")
        assert out["max_rel_err"] == 0.0 and out["finite"]  # the CPU against itself
    tm = __import__("test_torch_models")  # the card's bounds are no looser than the port-vs-JAX ones
    assert all(tol <= tm.TOL_MODEL_ARCH.get(a, tm.TOL_MODEL) for a, tol in cs.LM_CARD_TOL.items())
    check = cs.check_fold(np.random.default_rng(0), "cpu")
    assert check["max_abs_err"] == 0.0 and len(check["checks"]) == len(cs.FOLD_SHAPES) + 1
    fp = cs.drive_fastpath("cpu")
    assert fp["launches"] == {"chain_fold": 0}  # CPU: the plain version
    assert fp["chains"]["count"] == 467 and fp["chains"]["adds"] == 68434 and "round_trip" not in fp
    assert [tuple(c) for c in __import__("test_torch_pimsys").FASTPATH_GRID] == list(cs.FASTPATH_GRID)
    assert len(fp["cases"]) == len(cs.FASTPATH_GRID) and all(c["bit_identical"] for c in fp["cases"])


@pytest.mark.parametrize("layers", [4, 16, 32, 48])
def test_ssd_decode_drift_tracks_reference(layers):
    """mamba2-780m at full width (d_model 1536, 48 SSD heads, state 128),
    depth cut (48: the full model): the recurrent decode step drifts from
    the chunked forward in bf16 as layers are added, in the reference as in
    the port, on the same weights and tokens (159 tokens, the served length
    of chip_smoke.py's lm phase).  The port's drift stays within 1.5x the
    reference's (measured 0.0549 / 0.1211 / 0.1484 / 0.2598 against 0.0469
    / 0.1016 / 0.1328 / 0.2539 at 4 / 16 / 32 / 48 layers; run with -s to
    see them); chip_smoke.py's bound for 48 layers is twice the reference's
    drift at 32."""
    import dataclasses

    s = 159
    ref_cfg = dataclasses.replace(ref_get_config("mamba2-780m"), num_layers=layers)
    cfg = dataclasses.replace(get_config("mamba2-780m"), num_layers=layers)
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(0))
    model = PT.Transformer(cfg, params_from_reference(jax.tree.map(np.asarray, params), device="cpu"))
    tok = np.random.default_rng(0).integers(1, cfg.vocab_size - 1, (2, s)).astype(np.int32)

    full = np.asarray(RT.forward(params, ref_cfg, {"tokens": jnp.asarray(tok)})[0][:, s - 2], np.float32)
    _, caches = RT.prefill(params, ref_cfg, {"tokens": jnp.asarray(tok[:, : s - 2])}, cache_len=s)
    dec = np.asarray(RT.decode_step(params, ref_cfg, jnp.asarray(tok[:, s - 2]), caches, jnp.int32(s - 2))[0],
                     np.float32)
    ref_drift = float(np.abs(dec - full).max())
    ref_tol = float((np.abs(dec - full) / (1 + np.abs(full))).max())
    with torch.inference_mode():
        t = torch.from_numpy(tok)
        full_t = model({"tokens": t})[0][:, s - 2].float().numpy()
        _, caches_t = model.prefill({"tokens": t[:, : s - 2]}, cache_len=s)
        dec_t = model.decode_step(t[:, s - 2], caches_t, s - 2)[0].float().numpy()
    port_drift = float(np.abs(dec_t - full_t).max())
    port_tol = float((np.abs(dec_t - full_t) / (1 + np.abs(full_t))).max())
    print(f"mamba2-780m x {layers} layers: decode-vs-forward drift reference {ref_drift:.4f} port {port_drift:.4f}; "
          f"least rtol = atol passing: reference {ref_tol:.4f} port {port_tol:.4f}")
    assert 0 < port_drift <= 1.5 * ref_drift
