"""The sharded train step, the sharded train loop and the elastic restore
of `repro_torch` against its single-device step and against `repro`.

Every multi-rank case runs in a child interpreter (`torch_dist.run_child`):
gloo ranks spawned there, met through a `file://` store.  The pytest
process only prepares inputs (the reference's weights, checkpoints) and
compares.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.configs.registry import get_config as ref_get_config
from repro.data.pipeline import SyntheticStream as RefStream
from repro.launch import steps as ref_steps
from repro.models import transformer as RT
from repro.optim import OptConfig as RefOptConfig
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.tree import leaves
from test_torch_grads import TOL_LOSS
from torch_dist import SRC, run_child

#: Sharded against single-device step, max |param difference|: the
#: reference's bound for its 2 x 4 pjit step (tests/test_distributed.py:136).
TOL_SHARDED = 5e-3

#: Sharded against single-device step, the update itself: per leaf, the
#: 2-norm of the difference of the two steps' changes (params from their
#: start, optimizer state from zero) over the 2-norm of the single-device
#: change.  A step-1 update is about lr, far below `TOL_SHARDED`, so that
#: bound alone would pass an update that is missing or wrong.  The norm is
#: taken over the leaf, not per element: AdamW's first step is about
#: lr * sign(g), and grads within bf16 noise of 0 flip sign between batch
#: splits.  Correct steps measure at most 0.026 (AdamW params), the
#: planted wrong updates at least 0.19.
TOL_UPDATE = 0.05


def ref_state(arch, moments="float32"):
    """The reference's reduced params and AdamW state, seed 0."""
    cfg = ref_get_config(arch).reduced()
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    opt = RefOptConfig(total_steps=10, warmup_steps=1, moment_dtype=moments)
    return cfg, opt, params, ref_steps.make_opt_init(cfg, opt)(params)


def global_batch(cfg, hosts, batch=4, seq=32, step=1):
    """The batch the dp ranks read together: host 0's rows, then host 1's..."""
    parts = [RefStream(cfg, batch, seq, host_id=h, num_hosts=hosts).batch_at(step) for h in range(hosts)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


STEP_CHILD = '''
def body(rank, world, tmp):
    from torch.distributed.tensor import DTensor
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptConfig
    from repro_torch.tree import leaves, tree_map

    cfg = get_config("{arch}").reduced()
    opt = OptConfig(total_steps=10, warmup_steps=1, optimizer="{optimizer}")
    mesh = make_host_mesh(data={data}, model={model}, device="cpu")
    p0 = CheckpointManager(os.path.join(tmp, "weights")).restore(0, S.param_specs(cfg), "cpu")[0]
    s0 = S.make_opt_init(cfg, opt)(p0)
    host, hosts = S.data_parallel_rank(mesh)
    stream = lambda h, n: SyntheticStream(cfg, 4, 32, host_id=h, num_hosts=n).batch_at(1)
    local = {{k: torch.from_numpy(v) for k, v in stream(host, hosts).items()}}
    parts = [stream(h, hosts) for h in range(hosts)]
    whole = {{k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in parts[0]}}
    sh = (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0))
    fresh = lambda: tree_map(torch.clone, (p0, s0))

    def sharded_step():
        dp, ds = shd.distribute_tree(fresh(), sh)
        return S.make_sharded_train_step(cfg, opt, mesh)(dp, ds, local, 1)

    full = lambda x: (x.full_tensor() if isinstance(x, DTensor) else x).float()

    def diff(a, b):
        return max(float((full(x) - y.float()).abs().max()) for x, y in zip(leaves(a), leaves(b)))

    def update_err(a, b, start):
        """Per leaf, |(a - a0) - (b - a0)| over |b - a0| in the 2-norm: the worst leaf."""
        worst = 0.0
        for x, y, z in zip(leaves(a), leaves(b), leaves(start)):
            du, dv = full(x) - z.float(), y.float() - z.float()
            err, size = float(torch.linalg.vector_norm(du - dv)), float(torch.linalg.vector_norm(dv))
            worst = max(worst, err / size if size else (0.0 if err == 0 else float("inf")))
        return worst

    dp, ds, m = sharded_step()
    p1, s1, m1 = S.make_train_step(cfg, opt)(*fresh(), whole, 1)
    errs = lambda p, s: {{"param": update_err(p, p1, p0), "state": update_err(s, s1, s0)}}
    # controls, each a wrong update the bounds must refuse: no update at all;
    # this rank's batch shard alone, its grads not reduced over the dp ranks;
    # and for Adafactor the factored means of the local shard alone, and the
    # state's redistributed leaves never written back
    controls = {{"noop": errs(p0, s0), "unreduced": errs(*S.make_train_step(cfg, opt)(*fresh(), local, 1)[:2])}}
    if {model} > 1:  # the row-parallel sum over model dropped: each rank's own partial product
        from repro_torch.distributed import parallel as P
        row = P.row_parallel
        P.row_parallel = lambda h, w: h @ w
        controls["no_model_sum"] = errs(*sharded_step()[:2])
        P.row_parallel = row
    if opt.optimizer == "adafactor":
        mean, aligned = S._sharded_mean, S._aligned_state
        S._sharded_mean = lambda mesh, place: torch.mean
        controls["local_mean"] = errs(*sharded_step()[:2])
        S._sharded_mean, S._aligned_state = mean, lambda *a: (aligned(*a)[0], [])
        controls["no_write_back"] = errs(*sharded_step()[:2])
        S._aligned_state = aligned
    return {{"param_diff": diff(dp, p1), "state_diff": diff(ds, s1), "update_err": errs(dp, ds),
            "controls": controls, "loss": float(m["loss"]),
            "single_loss": float(m1["loss"]), "grad_norm": float(m["grad_norm"]),
            "single_grad_norm": float(m1["grad_norm"]), "lr": float(m["lr"]),
            "sharded": sum(any(p.is_shard() for p in x.placements) for x in leaves(dp)),
            "leaves": len(leaves(dp))}}

import numpy as np
'''


@pytest.fixture(scope="module")
def qwen3_8b_weights(tmp_path_factory):
    """The reference's reduced qwen3-8b weights, saved in the shared
    checkpoint format, and its single-device loss on the 2-host batch."""
    cfg, opt, params, state = ref_state("qwen3-8b")
    d = tmp_path_factory.mktemp("weights")
    RefCheckpointManager(str(d)).save(0, params)
    batch = {k: jnp.asarray(v) for k, v in global_batch(cfg, hosts=2).items()}
    _, _, m = ref_steps.make_train_step(cfg, opt)(params, state, batch, jnp.int32(1))
    return str(d), float(m["loss"])


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_sharded_step_matches_single_device(tmp_path, qwen3_8b_weights, optimizer):
    """One step of reduced qwen3-8b on a 2 x 2 (data, model) gloo mesh:
    params and optimizer state within 5e-3 of the single-device step on the
    whole batch, the update itself within `TOL_UPDATE` of its update, and
    its loss (the mean over the dp ranks) within the port-vs-reference loss
    bound of the reference's single-device loss.  Planted wrong updates (none,
    the grads not reduced over the dp ranks, the row-parallel sum over model
    dropped, and for Adafactor the local shard's means and no state
    write-backs) must fail `TOL_UPDATE`."""
    weights, ref_loss = qwen3_8b_weights
    os.symlink(weights, tmp_path / "weights")
    out = run_child(tmp_path, STEP_CHILD.format(arch="qwen3-8b", optimizer=optimizer, data=2, model=2),
                    world=4)
    for r in out:
        assert r["param_diff"] <= TOL_SHARDED and r["state_diff"] <= TOL_SHARDED, r
        assert max(r["update_err"].values()) <= TOL_UPDATE, r
        expected = {"noop", "unreduced", "no_model_sum"} | ({"local_mean", "no_write_back"} if optimizer == "adafactor"
                                                             else set())
        assert set(r["controls"]) == expected, r
        for name, err in r["controls"].items():
            assert max(err.values()) > TOL_UPDATE, (name, r)
        assert abs(r["loss"] - r["single_loss"]) <= 1e-5 * r["single_loss"], r
        assert abs(r["grad_norm"] - r["single_grad_norm"]) <= 1e-4 * r["single_grad_norm"], r
        assert abs(r["loss"] - ref_loss) <= TOL_LOSS * ref_loss, (r, ref_loss)
        assert r["lr"] > 0 and r["sharded"] >= 0.4 * r["leaves"], r
    assert len({r["loss"] for r in out}) == 1  # every rank reports the same mean


def test_sharded_step_on_one_rank_is_the_single_device_step(tmp_path, qwen3_8b_weights):
    """At world size 1 every collective is an identity: the sharded step's
    params, state and loss equal the single-device step's bit for bit (the
    card case of `chip_smoke.py`'s dist phase, on the CPU)."""
    weights, _ = qwen3_8b_weights
    os.symlink(weights, tmp_path / "weights")
    code = STEP_CHILD.format(arch="qwen3-8b", optimizer="adamw", data=1, model=1)
    [r] = run_child(tmp_path, code, world=1)
    assert r["param_diff"] == 0 and r["state_diff"] == 0, r
    assert r["update_err"] == {"param": 0.0, "state": 0.0}, r
    assert r["loss"] == r["single_loss"] and r["grad_norm"] == r["single_grad_norm"], r


TRAIN_CHILD = '''
def body(rank, world, tmp):
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import FaultInjector, train
    from repro_torch.tree import leaves

    kw = dict(batch=4, seq=16, ckpt_dir=os.path.join(tmp, "ckpt"), ckpt_every=3, log_every=100, device="cpu")
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    _, _, h1 = train("qwen3-4b", 6, injector=FaultInjector([4]), mesh=mesh, **kw)
    mesh = make_host_mesh(data=4, model=1, device="cpu")  # a restart on another mesh
    params, _, h2 = train("qwen3-4b", 8, mesh=mesh, **kw)
    return {"steps": [[h["step"] for h in h] for h in (h1, h2)], "losses": [h["loss"] for h in h1 + h2],
            "meshes": sorted({tuple(p.device_mesh.shape) for p in leaves(params)})}
'''


def test_sharded_train_loop_rolls_back_and_resumes_on_another_mesh(tmp_path):
    """`train(mesh=)` on 4 gloo ranks: a fault at step 4 rolls back to the
    checkpoint of step 3 and retries with the same data; a restart on a
    4 x 1 mesh resumes from step 6, re-sharding the 2 x 2 run's checkpoint."""
    out = run_child(tmp_path, TRAIN_CHILD, world=4)
    assert out[0]["steps"] == [[0, 1, 2, 3, 3, 4, 5], [6, 7]]
    losses = out[0]["losses"]
    assert all(np.isfinite(losses)) and losses[3] == losses[4]  # step 3 again, same data and state
    assert all(r["losses"] == losses for r in out)  # the loss is the dp mean on every rank
    assert out[0]["meshes"] == [[4, 1]]


#: A state with a plain and a stacked leaf, f32 and bf16 (values exact in bf16).
STATE = '''
def make_state(lib, bf16):
    embed = (lib.arange(64) * 0.5).reshape(8, 8)
    wq = ((lib.arange(128) - 64) * 0.375).reshape(2, 8, 8)
    if lib.__name__ == "torch":
        embed, wq = embed.float(), wq.to(bf16)
    else:
        embed, wq = embed.astype("float32"), wq.astype(bf16)
    return {"embed": embed, "blocks": [{"mixer": {"wq": wq}}]}
'''

RESTORE_CHILD = STATE + '''
def body(rank, world, tmp):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves, tree_map

    example = tree_map(lambda t: t.to("meta"), make_state(torch, torch.bfloat16))
    mesh = make_host_mesh(data=world, model=1, device="cpu")
    state, _ = CheckpointManager(os.path.join(tmp, "ckpt")).restore(1, example, "cpu", mesh,
                                                                    shd.param_shardings(mesh, example))
    bits = lambda t: t.view(torch.int16).tolist() if t.dtype == torch.bfloat16 else t.tolist()
    return {"local": [bits(x.to_local()) for x in leaves(state)],
            "full": [bits(x.full_tensor()) for x in leaves(state)],
            "placements": [str(x.placements) for x in leaves(state)]}
'''

SAVE_CHILD = STATE + '''
def body(rank, world, tmp):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves

    mesh = make_host_mesh(data=world, model=1, device="cpu")
    state = make_state(torch, torch.bfloat16)
    state = shd.distribute_tree(state, shd.param_shardings(mesh, state))
    CheckpointManager(os.path.join(tmp, "ckpt")).save(1, state)
    return [str(x.placements) for x in leaves(state)]
'''

#: In leaf order: the stacked wq (d over data, heads over model), embed (vocab
#: over data, d over model).
PLACEMENTS = ["(Shard(dim=1), Shard(dim=2))", "(Shard(dim=0), Shard(dim=1))"]


def check_restored(out, world):
    """Each of `world` ranks (model = 1) holds its chunk of every leaf's dp
    dim (the stacked wq: dim 1; embed: dim 0), bit for bit, and the whole
    leaves gather back exactly."""
    ns = {"np": np, "torch": torch}
    exec(STATE, ns)
    exp = [t.view(torch.int16) if t.dtype == torch.bfloat16 else t
           for t in leaves(ns["make_state"](torch, torch.bfloat16))]
    for r, rec in enumerate(out):
        assert rec["placements"] == PLACEMENTS
        assert rec["full"] == [e.tolist() for e in exp]
        assert rec["local"] == [torch.chunk(exp[0], world, 1)[r].tolist(), torch.chunk(exp[1], world, 0)[r].tolist()]


REF_SAVE = '''
import jax, numpy as np, ml_dtypes
from repro.ckpt.checkpoint import CheckpointManager
from repro.distributed import sharding as shd
from repro.launch.mesh import make_host_mesh
state = make_state(np, ml_dtypes.bfloat16)
mesh = make_host_mesh(data=4, model=1)
sh = shd.param_shardings(mesh, jax.eval_shape(lambda: state))
state = jax.tree.map(jax.device_put, state, sh)
assert len(state["embed"].sharding.device_set) == 4
CheckpointManager(CKPT).save(1, state)
print("SAVED")
'''


def test_elastic_restore_of_a_reference_checkpoint(tmp_path):
    """A checkpoint the reference saves under a 4-device mesh (forced host
    devices, its own subprocess) restores in the port under 2 gloo ranks,
    each rank's shard and the whole arrays equal bit for bit (bf16 too)."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu")
    code = f"CKPT = {str(tmp_path / 'ckpt')!r}\nimport numpy as np\n" + STATE + REF_SAVE
    ref = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=240)
    assert ref.returncode == 0 and "SAVED" in ref.stdout, ref.stderr[-3000:]
    check_restored(run_child(tmp_path, RESTORE_CHILD, world=2), world=2)


def test_elastic_restore_of_a_port_checkpoint_both_ways(tmp_path):
    """The port saves a state sharded over 4 gloo ranks (rank 0 writes the
    gathered arrays); it restores under 2 ranks bit for bit, and the
    reference restores it too."""
    assert run_child(tmp_path, SAVE_CHILD, world=4)[0] == PLACEMENTS
    check_restored(run_child(tmp_path, RESTORE_CHILD, world=2), world=2)
    import ml_dtypes

    ns = {"np": np}
    exec(STATE, ns)
    exp = ns["make_state"](np, ml_dtypes.bfloat16)
    ckpt = str(tmp_path / "ckpt")
    got, _ = RefCheckpointManager(ckpt).restore(1, jax.eval_shape(lambda: exp))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(exp)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8), b.view(np.uint8))
    assert CheckpointManager(ckpt).latest_step() == 1


DIST_PHASE = '''
import json, tempfile
import importlib.util
spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(SRC, "..", "chip_smoke.py"))
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
with cs.one_rank_world("cpu"):
    rec = cs.drive_dist_step("cpu", batch=2, seq=32, steps=3, reduced=True)
    arch, layers, moments = cs.DIST_MOE
    moe = cs.drive_dist_step("cpu", arch, moments, batch=2, seq=32, steps=3, reduced=True, compression=False)
    mixers = [cs.drive_dist_step("cpu", arch, moments, batch=2, seq=32, steps=2, reduced=True, layers=layers,
                                 compression=False) for arch, layers, moments, _ in cs.DIST_MIXERS]
    serves = [cs.drive_dist_serve("cpu", arch, 2, 16, 4, reduced=True) for arch, *_ in cs.DIST_SERVE]
with tempfile.TemporaryDirectory() as d:
    sweep = cs.run_dryrun_sweep(d, ("--arch", "qwen3-8b", "--shape", "long_500k"))
print(json.dumps({"step": rec, "moe": moe, "mixers": mixers, "serves": serves, "sweep": sweep}))
'''


def test_chip_smoke_dist_phase_on_cpu(tmp_path):
    """`chip_smoke.py`'s dist phase rehearsed at reduced qwen3-4b and reduced
    qwen3-moe in a one-rank gloo world (a child interpreter): the
    collectives equal the codec, the sharded step 1 equals the unsharded
    one bit for bit (the MoE's aux loss too; and for the other mixers'
    runs, reduced mamba2, whisper and llama-vision), no kernel of the port
    launches; the serving part at reduced qwen3-4b and mamba2 (prefill of
    16 tokens, 3 decode steps): both sharded runs' greedy tokens, logits
    and every cache leaf equal to the unsharded steps'; the sweep's
    plumbing on a skipped cell."""
    out = json.loads(run_child(tmp_path, DIST_PHASE).strip().splitlines()[-1])
    assert [r["arch"] for r in out["serves"]] == ["qwen3-4b", "mamba2-780m"]
    for r in out["serves"]:
        eq = r["equal_to_unsharded"]
        assert eq["tokens"] and eq["unequal_logits"] == [] and eq["unequal_cache_leaves"] == [], r
        assert eq["logits"] == 4 and eq["cache_leaves"] == 2 and eq["sharded_runs"] == 2, r
        assert r["launches"] == out["step"]["launches"] and r["sharded_decode_ms_per_step"] > 0, r
    rec, moe, sweep = out["step"], out["moe"], out["sweep"]
    assert [r["arch"] for r in out["mixers"]] == ["mamba2-780m", "whisper-small", "llama-3.2-vision-11b"]
    for r in out["mixers"]:
        assert r["equal_to_unsharded"]["unequal_leaves"] == [], r
        assert all(r["equal_to_unsharded"][k] for k in ("loss", "aux", "grad_norm", "lr")), r
        assert r["launches"] == rec["launches"] and len(r["steps"]) == 2, r
    assert out["mixers"][2]["layers"] == 5
    assert moe["equal_to_unsharded"]["unequal_leaves"] == [] and moe["compression"] is None
    assert all(moe["equal_to_unsharded"][k] for k in ("loss", "aux", "grad_norm", "lr")), moe
    assert moe["experts"] == 4 and moe["steps"][0]["aux"] > 0 and moe["launches"] == rec["launches"]
    assert rec["equal_to_unsharded"]["unequal_leaves"] == [] and rec["equal_to_unsharded"]["loss"]
    assert rec["compression"]["mismatches"] == [] and rec["compression"]["leaves"] == 14
    assert [r["step"] for r in rec["steps"]] == [1, 2, 3] and rec["backend"] == "gloo"
    assert len(rec["unsharded_step_ms_all"]) == 3 and rec["unsharded_step_ms"] > 0
    assert rec["launches"] == {"ntt_tile": 0, "ntt_pair": 0, "modmul": 0, "chain_fold": 0, "silu_fwd": 0,
                               "silu_bwd": 0}  # CPU: the plain versions
    assert rec["mesh"] == {"data": 1, "model": 1} and "peak_mib" not in rec
    assert sweep["status"] == {"skip": 1} and sweep["exit_code"] == 0
