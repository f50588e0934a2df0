"""The sharded serving steps of `repro_torch`
(`launch.steps.make_sharded_prefill_step` / `make_sharded_decode_step`):
prefill and decode on local shards, with the caches placed by the
reference's `cache_shardings` (the batch over dp, a KV or cross cache's
length over `model` with the partial-softmax reduction, the SSD state's
heads and the conv history's channels over `model`).

Every multi-rank case runs in a child interpreter (`torch_dist.run_child`,
gloo ranks); the cases of one world size share a child.  The weights are
the port's own seed-0 draw, and each sharded run is held against one
device's `T.prefill` / `T.decode_step` on the global batch, its decode
steps teacher-forced on that run's greedy tokens; the JAX reference's
weights and logits come in for case (f).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.models import transformer as RT
from test_torch_models import PROMPT, SEQ, TOL_MODEL, arch_setup, rel_err
from torch_dist import run_child

#: The reduced dense, MoE, SSD, hybrid, encoder-decoder and cross-attention archs.
ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b", "mamba2-780m", "jamba-1.5-large-398b", "whisper-small",
         "llama-3.2-vision-11b")
#: The archs held against the JAX reference, case (f): attention with MoE,
#: the SSD, and the whisper encoder with `attn_cross` (the others are held
#: to the single-device port, which test_torch_models.py holds to the
#: reference).
REF_ARCHS = ("qwen3-moe-30b-a3b", "mamba2-780m", "whisper-small")

# The sharded steps against one device's on the global batch (8 rows): the
# largest |sharded - single| over the largest |single| of the logits and of
# every gathered cache leaf, at most twice the worst reading (0.0091:
# whisper's logits at 1 x 2 and 2 x 2, where a decode step's partial softmax
# rounds a probability otherwise than one device's; its caches 0.0063).
# Every other arch and mesh reads 0 (bit-equal: a split matmul computes each
# output element whole on one rank).  A planted per-rank softmax reads ~0.6.
TOL_SERVE = 0.02

COMMON = '''
import contextlib

import numpy as np
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import make_inputs
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

BATCH, PROMPT, CACHE, STEPS = 8, 16, 24, 4


def rel(ref, got):
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def setup(arch, **over):
    cfg = get_config(arch).reduced(**over)
    p0 = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    inputs = {k: torch.from_numpy(v) for k, v in make_inputs(cfg, BATCH, PROMPT, 0).items()}
    return cfg, p0, inputs


_SINGLE = {}


def single(cfg, p0, inputs):
    """One device's prefill and STEPS greedy decode steps on the global
    batch: (logits, tokens, caches, the first decode step's matmul flops),
    once per config in a child."""
    from torch.utils.flop_counter import FlopCounterMode

    if cfg in _SINGLE:
        return _SINGLE[cfg]
    with torch.inference_mode():
        logits, caches = T.prefill(p0, cfg, inputs, CACHE)
        out, tokens = [logits], []
        for i in range(STEPS):
            tokens.append(torch.argmax(out[-1], -1).to(torch.int32))
            with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
                logits, caches = T.decode_step(p0, cfg, tokens[-1], caches, PROMPT + i)
            counted = fc.get_total_flops() if i == 0 else counted
            out.append(logits)
    _SINGLE[cfg] = out, tokens, caches, counted
    return _SINGLE[cfg]


def sharded(cfg, p0, inputs, mesh, tokens, prompt=PROMPT, cache=CACHE):
    """The sharded steps on this rank's rows, teacher-forced by `tokens`:
    (logits DTensors, cache DTensors, the first decode step's matmul flops)."""
    from torch.utils.flop_counter import FlopCounterMode

    params = shd.distribute_tree(p0, shd.param_shardings(mesh, p0))
    host, hosts = S.data_parallel_rank(mesh)
    b = next(iter(inputs.values())).shape[0] // hosts
    rows = slice(host * b, (host + 1) * b)
    with torch.inference_mode():
        logits, caches = S.make_sharded_prefill_step(cfg, cache, mesh)(params, {k: v[rows] for k, v in inputs.items()})
        decode = S.make_sharded_decode_step(cfg, mesh)
        out = [logits]
        for i, tok in enumerate(tokens):
            with FlopCounterMode(display=False) if i == 0 else contextlib.nullcontext() as fc:
                logits, caches = decode(params, tok[rows], caches, prompt + i)
            counted = fc.get_total_flops() if i == 0 else counted
            out.append(logits)
    return out, caches, counted


def compare(cfg, p0, inputs, mesh):
    """The sharded run against the single-device one: the logits' and the
    gathered caches' errors, whether all are bit-equal, the cache leaves
    whose local shape is not `local_shape` of their spec, their
    placements, and the first decode step's flops over one device's."""
    ref, tokens, ref_caches, ref_flops = single(cfg, p0, inputs)
    got, caches, flops = sharded(cfg, p0, inputs, mesh, tokens)
    whole = [t.full_tensor() for t in got]
    specs = shd.cache_shardings(mesh, T.init_cache(cfg, BATCH, CACHE, next(
        (v.shape[1] for k, v in inputs.items() if k != "tokens"), 0), device="meta"))
    bad_shapes, places, cache_errs, exact = [], set(), [], all(torch.equal(a, b) for a, b in zip(ref, whole))
    for i, (c, r, sp) in enumerate(zip(caches, ref_caches, specs)):
        for k, d in c.items():
            full = d.full_tensor()
            cache_errs.append(rel(r[k], full))
            exact = exact and torch.equal(r[k], full)
            if tuple(d.to_local().shape) != shd.local_shape(mesh, sp[k].spec, r[k].shape):
                bad_shapes.append(f"{i}.{k}")
            places.add(f"{k}:" + ",".join(f"S{p.dim}" if p.is_shard() else "R" for p in d.placements))
    return {"logits": max(rel(a, b) for a, b in zip(ref, whole)), "caches": max(cache_errs), "exact": exact,
            "bad_shapes": bad_shapes, "places": sorted(places), "flops": flops / ref_flops,
            "logit_places": ",".join(f"S{p.dim}" if p.is_shard() else "R" for p in got[0].placements)}


def per_rank_softmax(scores):
    """The wrong reduction: each rank's probs normalised over its own slice."""
    return torch.softmax(scores, dim=-1).to(L.COMPUTE_DTYPE)
'''

ONE_RANK = COMMON + '''
def body(rank, world, tmp):
    mesh = make_host_mesh(data=1, model=1, device="cpu")
    return {arch: compare(*setup(arch), mesh) for arch in ARCHS}
'''


def test_one_rank_mesh_is_bit_exact(tmp_path):
    """(a) On a 1 x 1 mesh the sharded prefill and 4 decode steps run the
    single-device code: the logits and every cache leaf equal the
    unsharded steps' bit for bit, for the six reduced archs."""
    out = run_child(tmp_path, f"ARCHS = {ARCHS!r}\n" + ONE_RANK, world=1)[0]
    assert set(out) == set(ARCHS)
    for arch, r in out.items():
        assert r["exact"] and r["logits"] == 0.0 and r["caches"] == 0.0, (arch, r)
        assert not r["bad_shapes"], (arch, r)


def check_case(case, where, replicated=()):
    """A sharded run within `TOL_SERVE` of one device's, every cache leaf at
    `local_shape` of its spec and placed as the reference's rules place it
    on a (data, model) mesh whose sizes divide every dim: the batch over
    `data`, and over `model` a KV or cross cache's length, the SSD state's
    heads (dim 2 of the stacked leaves) and the conv history's channels
    (dim 3); the leaves in `replicated` keep their length whole."""
    assert case["logits"] <= TOL_SERVE and case["caches"] <= TOL_SERVE, (where, case)
    assert not case["bad_shapes"], (where, case)
    for place in case["places"]:
        leaf = place.split(":")[0]
        model = "R" if leaf in replicated else f"S{3 if leaf == 'conv' else 2}"
        assert place == f"{leaf}:S1,{model}", (where, case["places"])


TWO_RANKS = COMMON + '''
def reference_run(tmp, mesh):
    """(f) The sharded steps on the reference's weights and inputs,
    teacher-forced by the inputs (prompt SEQ - 4, then 4 steps)."""
    from repro_torch.ckpt.checkpoint import CheckpointManager

    out = {}
    for arch in REF_ARCHS:
        cfg = get_config(arch).reduced(capacity_factor=8.0)
        p0 = CheckpointManager(os.path.join(tmp, "ref", arch)).restore(0, S.param_specs(cfg), "cpu")[0]
        inputs = {k: torch.from_numpy(v) for k, v in make_inputs(cfg, 2, SEQ, seed=0).items()}
        pre = dict(inputs, tokens=inputs["tokens"][:, :SEQ - 4])
        tokens = [inputs["tokens"][:, SEQ - 4 + i] for i in range(4)]
        got = sharded(cfg, p0, pre, mesh, tokens, prompt=SEQ - 4, cache=SEQ)[0]
        logits = torch.stack([t.full_tensor().float() for t in got])
        if dist.get_rank() == 0:
            np.save(os.path.join(tmp, f"port_{arch}.npy"), logits.numpy())
        out[arch] = list(logits.shape)
    return out


def body(rank, world, tmp):
    out = {}
    for data, model in ((1, 2), (2, 1)):
        mesh = make_host_mesh(data=data, model=model, device="cpu")
        out[f"{data}x{model}"] = {arch: compare(*setup(arch), mesh) for arch in ARCHS}
    mesh = make_host_mesh(data=1, model=2, device="cpu")
    out["encoder_seq_25"] = compare(*setup("whisper-small", encoder_seq=25), mesh)
    right = L.split_softmax
    L.split_softmax = per_rank_softmax
    try:
        out["planted"] = {arch: compare(*setup(arch), mesh) for arch in ("qwen3-8b", "llama-3.2-vision-11b")}
    finally:
        L.split_softmax = right
    out["reference"] = reference_run(tmp, mesh)
    return out
'''


@pytest.fixture(scope="module")
def reference_serving(tmp_path_factory):
    """The JAX reference's reduced weights for `REF_ARCHS` (seed 0,
    `capacity_factor=8.0`: no MoE drops) in the shared checkpoint format,
    and its prefill of SEQ - 4 tokens and 4 decode steps teacher-forced by
    the inputs (batch 2), as `test_torch_models.py` runs them."""
    d = tmp_path_factory.mktemp("reference_serving")
    logits = {}
    for arch in REF_ARCHS:
        _, ref_cfg, pj, _, inputs = arch_setup(arch)
        RefCheckpointManager(str(d / arch)).save(0, pj)
        jb = {k: jnp.asarray(v) for k, v in inputs.items()}
        lp, caches = RT.prefill(pj, ref_cfg, dict(jb, tokens=jb["tokens"][:, :PROMPT]), cache_len=SEQ)
        out = [lp]
        for step in range(4):
            lg, caches = RT.decode_step(pj, ref_cfg, jb["tokens"][:, PROMPT + step], caches, jnp.int32(PROMPT + step))
            out.append(lg)
        logits[arch] = out
    return str(d), logits


def test_two_rank_meshes(tmp_path, reference_serving):
    """(b) On 1 x 2 and 2 x 1 meshes the six reduced archs' sharded prefill
    and 4 teacher-forced decode steps: the logits and the gathered caches
    within `TOL_SERVE` of one device's on the global batch, each cache
    leaf's local shape `local_shape` of its spec, the KV length split over
    `model` (1 x 2) and the batch over `data` (2 x 1), and at 1 x 2 each
    rank's decode step at most 0.6 of one device's matmul flops.  (d) A
    cross cache of 25 encoder frames does not divide over 2 and stays
    replicated over `model`.  (e) The planted per-rank softmax misses the
    bound.  (f) At 1 x 2 the sharded logits of `REF_ARCHS` are within
    `TOL_MODEL` of the JAX reference's on its own weights."""
    ref_dir, ref_logits = reference_serving
    os.symlink(ref_dir, tmp_path / "ref")
    code = f"ARCHS = {ARCHS!r}\nREF_ARCHS = {REF_ARCHS!r}\nSEQ = {SEQ}\n" + TWO_RANKS
    out = run_child(tmp_path, code, world=2)
    for r in out:
        for mesh in ("1x2", "2x1"):
            for arch, case in r[mesh].items():
                check_case(case, (mesh, arch))
                if mesh == "1x2":
                    assert case["flops"] <= 0.6, (arch, case["flops"])
        enc = r["encoder_seq_25"]
        check_case(enc, "encoder_seq_25", replicated=("ck", "cv"))
        for arch, case in r["planted"].items():
            assert case["logits"] > TOL_SERVE and case["caches"] > TOL_SERVE, (arch, case)
    for arch in REF_ARCHS:
        got = np.load(tmp_path / f"port_{arch}.npy")
        for step, ref in enumerate(ref_logits[arch]):
            assert rel_err(ref, got[step]) <= TOL_MODEL, (arch, step)


FOUR_RANKS = COMMON + '''
def body(rank, world, tmp):
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    out = {"2x2": {arch: compare(*setup(arch), mesh) for arch in ARCHS}}
    mesh = make_host_mesh(data=1, model=4, device="cpu")
    out["cut_heads"] = compare(*setup("qwen3-8b"), mesh)
    return out
'''


def test_four_rank_meshes(tmp_path):
    """(b) On a 2 x 2 mesh the six reduced archs within `TOL_SERVE`, the KV
    caches' length over `model` and their batch over `data`.  (c) Reduced
    qwen3-8b on 1 x 4: its kv projections' 2 x 32 columns split 16 a rank
    (cut heads, gathered whole), a 24-long cache 6 positions a rank."""
    out = run_child(tmp_path, f"ARCHS = {ARCHS!r}\n" + FOUR_RANKS, world=4)
    for r in out:
        for arch, case in r["2x2"].items():
            check_case(case, arch)
            assert case["logit_places"] == "S0,S1", (arch, case)
        check_case(r["cut_heads"], "cut_heads")
