"""The port's data pipeline, checkpoints and gradient codec
(`repro_torch.{data.pipeline,ckpt.checkpoint,distributed.compression}`) on
the CPU: against the JAX package where both compute the same thing
(batches, EF codes: equal; checkpoints: each package restores the other's,
bit for bit), and twins of `tests/test_substrate.py`'s data, checkpoint
and compression tests.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import SyntheticStream as RefStream
from repro.distributed import compression as RC
from repro.launch import steps as ref_steps
from repro.models import transformer as RT
from repro.optim import OptConfig as RefOptConfig
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticStream
from repro_torch.distributed.compression import ef_compress, ef_decompress
from repro_torch.launch import steps
from repro_torch.models.convert import params_from_reference
from repro_torch.optim import OptConfig
from repro_torch.tree import leaves, leaves_with_path

# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batches_equal_the_reference(arch):
    """Tokens, image embeddings and frames: the reference's, for each step
    and host shard."""
    for host in (0, 1):
        ref = RefStream(ref_get_config(arch).reduced(), 4, 32, seed=5, host_id=host, num_hosts=2)
        port = SyntheticStream(get_config(arch).reduced(), 4, 32, seed=5, host_id=host, num_hosts=2)
        for step in (0, 3, 1000):
            want, got = ref.batch_at(step), port.batch_at(step)
            assert want.keys() == got.keys()
            for k in want:
                assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), (k, step)


def test_data_deterministic_and_host_sharded():
    cfg = get_config("qwen3-4b").reduced()
    a = SyntheticStream(cfg, 8, 64, seed=3).batch_at(17)
    b = SyntheticStream(cfg, 8, 64, seed=3).batch_at(17)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticStream(cfg, 8, 64, seed=4).batch_at(17)
    assert not np.array_equal(a["tokens"], c["tokens"])
    # host sharding: different hosts, disjoint-but-deterministic slices
    h0 = SyntheticStream(cfg, 8, 64, seed=3, host_id=0, num_hosts=2).batch_at(5)
    h1 = SyntheticStream(cfg, 8, 64, seed=3, host_id=1, num_hosts=2).batch_at(5)
    assert h0["tokens"].shape == (4, 64)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_data_prefetch_iterator():
    cfg = get_config("qwen3-4b").reduced()
    stream = SyntheticStream(cfg, 4, 32, seed=0)
    it = stream.iterate(start_step=7)
    s, batch = next(it)
    assert s == 7
    np.testing.assert_array_equal(batch["tokens"], stream.batch_at(7)["tokens"])
    s2, _ = next(it)
    assert s2 == 8
    it.close()


def test_tokens_in_vocab_range():
    cfg = get_config("command-r-35b").reduced()
    b = SyntheticStream(cfg, 4, 128, seed=0).batch_at(0)
    assert b["tokens"].min() >= 1 and b["tokens"].max() < cfg.vocab_size


# ---------------------------------------------------------------------------
# checkpointing
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = {"a": torch.arange(12).reshape(3, 4).float(),
             "b": [torch.ones(5), {"c": torch.tensor([[1.5, -2.0], [3.0, 1e-3]], dtype=torch.bfloat16)}]}
    mgr.save(3, state)
    assert mgr.latest_step() == 3
    restored, manifest = mgr.restore(3, state, device="cpu")
    assert manifest["step"] == 3
    for (pa, x), (pb, y) in zip(leaves_with_path(state), leaves_with_path(restored)):
        assert pa == pb and x.dtype == y.dtype and torch.equal(x, y)


def test_checkpoint_gc_and_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    state = {"w": torch.ones(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state, blocking=False)
        state["w"].add_(1.0)  # in place after the call: the snapshot was taken
    mgr.wait()
    assert mgr.all_steps() == [3, 4]
    assert torch.equal(mgr.restore(4, state, device="cpu")[0]["w"], torch.full((4,), 4.0))


def test_checkpoint_atomic_no_partial(tmp_path):
    """A .tmp dir is never listed as a restorable step."""
    mgr = CheckpointManager(str(tmp_path))
    os.makedirs(tmp_path / "step_9.tmp")
    assert mgr.all_steps() == []


def test_restore_defaults_to_the_card(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": torch.ones(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mgr.restore(1, {"w": torch.ones(2)})


def _train_state(arch):
    """kimi's reduced config keeps bf16 params (`param_dtype`); its AdamW
    state in bf16 moments: the reference's (params, opt_state) and the
    port's carried copy."""
    ref_cfg = ref_get_config(arch).reduced()
    opt = RefOptConfig(moment_dtype="bfloat16")
    params = RT.init_params(ref_cfg, jax.random.PRNGKey(1))
    state = (params, ref_steps.make_opt_init(ref_cfg, opt)(params))
    carried = params_from_reference(jax.tree.map(np.asarray, state), device="cpu")
    return ref_cfg, opt, state, tuple(carried)


def test_checkpoint_interop_reference_to_port(tmp_path):
    arch = "kimi-k2-1t-a32b"
    _, opt, state, carried = _train_state(arch)
    RefCheckpointManager(str(tmp_path)).save(2, state)
    cfg = get_config(arch).reduced()
    example = (steps.param_specs(cfg), steps.opt_specs(cfg, OptConfig(moment_dtype="bfloat16")))
    assert all(t.device.type == "meta" for t in leaves(example))
    restored, manifest = CheckpointManager(str(tmp_path)).restore(2, example, device="cpu")
    assert "bfloat16" in {leaf["dtype"] for leaf in manifest["leaves"]}
    assert len(leaves(restored)) == len(leaves(carried)) == len(manifest["leaves"])
    for (p, want), got in zip(leaves_with_path(carried), leaves(restored)):
        assert got.dtype == want.dtype and torch.equal(got, want), p


def test_checkpoint_interop_port_to_reference(tmp_path):
    arch = "kimi-k2-1t-a32b"
    ref_cfg, opt, state, carried = _train_state(arch)
    CheckpointManager(str(tmp_path / "port")).save(2, carried)
    RefCheckpointManager(str(tmp_path / "ref")).save(2, state)
    manifests = [json.load(open(tmp_path / d / "step_2" / "manifest.json")) for d in ("port", "ref")]
    assert manifests[0]["leaves"] == manifests[1]["leaves"]  # keys, shapes, dtypes
    example = (ref_steps.param_specs(ref_cfg), ref_steps.opt_specs(ref_cfg, opt))
    restored, _ = RefCheckpointManager(str(tmp_path / "port")).restore(2, example)
    for want, got in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        assert want.dtype == got.dtype and np.array_equal(np.asarray(want).view(np.uint8),
                                                          np.asarray(got).view(np.uint8))


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [0.01, 3.0, 0.0])
def test_ef_compress_equals_reference(scale):
    rng = np.random.default_rng(1)
    g = (rng.standard_normal(4096) * scale).astype(np.float32)
    res = (rng.standard_normal(4096) * scale * 0.01).astype(np.float32)
    code_j, scale_j, res_j = RC.ef_compress(jnp.asarray(g), jnp.asarray(res))
    code_t, scale_t, res_t = ef_compress(torch.from_numpy(g), torch.from_numpy(res))
    assert code_t.dtype == torch.int8 and np.array_equal(np.asarray(code_j), code_t.numpy())
    assert np.asarray(scale_j).tobytes() == scale_t.numpy().tobytes()
    assert np.asarray(res_j).tobytes() == res_t.numpy().tobytes()
    assert (np.asarray(RC.ef_decompress(code_j, scale_j)).tobytes()
            == ef_decompress(code_t, scale_t).numpy().tobytes())


def test_ef_compression_error_feedback():
    rng = np.random.default_rng(0)
    g = torch.from_numpy((rng.standard_normal(1000) * 0.01).astype(np.float32))
    residual = torch.zeros(1000)
    code, scale, residual = ef_compress(g, residual)
    assert code.dtype == torch.int8
    decoded = ef_decompress(code, scale)
    # single-shot error bounded by scale/2
    assert float(torch.max(torch.abs(decoded - g))) <= float(scale) / 2 + 1e-7
    # error feedback: accumulated residual captures the quantization error
    np.testing.assert_allclose((decoded + residual).numpy(), g.numpy(), atol=1e-6)
