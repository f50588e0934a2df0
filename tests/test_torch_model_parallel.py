"""The model axis of `repro_torch`'s sharded train step: MoE routing over the
global batch, tensor parallelism for attention, the MLP and the head,
expert parallelism for MoE, and the per-rep FSDP gather.

Every multi-rank case runs in a child interpreter (`torch_dist.run_child`,
gloo ranks met through a `file://` store); the cases of one mesh share a
child.  The weights are the reference's reduced ones (seed 0), saved in the
shared checkpoint format; the single-device step they are held against is
`make_train_step` on the global batch (every dp rank's rows, host order).
"""
import os

import jax.numpy as jnp
import pytest
import torch

from repro.ckpt.checkpoint import CheckpointManager as RefCheckpointManager
from repro.launch import steps as ref_steps
from test_torch_grads import TOL_LOSS
from test_torch_sharded_train import TOL_SHARDED, TOL_UPDATE, global_batch, ref_state
from torch_dist import run_child

#: The child's shared part: the weights, the batches, one sharded step and
#: its distance from the single-device step (as `STEP_CHILD` in
#: test_torch_sharded_train.py measures it), and the planted wrong steps.
COMMON = '''
import contextlib
import numpy as np


def setup(arch, optimizer, data, model, tmp, seq=32, batch=4, weights="weights", **over):
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.launch import steps as S
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig

    cfg = get_config(arch).reduced(**over)
    opt = OptConfig(total_steps=10, warmup_steps=1, optimizer=optimizer)
    mesh = make_host_mesh(data=data, model=model, device="cpu")
    weights = os.path.join(tmp, weights)
    if os.path.exists(weights):
        p0 = CheckpointManager(weights).restore(0, S.param_specs(cfg), "cpu")[0]
    else:
        p0 = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    s0 = S.make_opt_init(cfg, opt)(p0)
    host, hosts = S.data_parallel_rank(mesh)
    stream = lambda h: SyntheticStream(cfg, batch, seq, host_id=h, num_hosts=hosts).batch_at(1)
    local = {k: torch.from_numpy(v) for k, v in stream(host).items()}
    parts = [stream(h) for h in range(hosts)]
    whole = {k: torch.from_numpy(np.concatenate([p[k] for p in parts])) for k in parts[0]}
    return cfg, opt, mesh, p0, s0, local, whole


def run(cfg, opt, mesh, p0, s0, local, whole, controls=()):
    """The sharded step's distance from the single-device step, and each
    planted wrong step's (a context manager that plants it)."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import leaves, tree_map

    fresh = lambda: tree_map(torch.clone, (p0, s0))
    sh = (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0))
    full = lambda x: (x.full_tensor() if isinstance(x, DTensor) else x).float()

    def sharded_step():
        dp, ds = shd.distribute_tree(fresh(), sh)
        return S.make_sharded_train_step(cfg, opt, mesh)(dp, ds, local, 1)

    p1, s1, m1 = S.make_train_step(cfg, opt)(*fresh(), whole, 1)

    def errs(p, s):
        out = {}
        for name, a, b, start in (("param", p, p1, p0), ("state", s, s1, s0)):
            worst = 0.0
            for x, y, z in zip(leaves(a), leaves(b), leaves(start)):
                du, dv = full(x) - z.float(), y.float() - z.float()
                err, size = float(torch.linalg.vector_norm(du - dv)), float(torch.linalg.vector_norm(dv))
                worst = max(worst, err / size if size else (0.0 if err == 0 else float("inf")))
            out[name] = worst
        return out

    dp, ds, m = sharded_step()
    diff = max(float((full(x) - y.float()).abs().max()) for x, y in zip(leaves((dp, ds)), leaves((p1, s1))))
    rec = {"diff": diff, "update_err": errs(dp, ds), "metrics": {k: float(v) for k, v in m.items()},
           "single": {k: float(v) for k, v in m1.items()}, "controls": {}}
    for name, plant in controls:
        with plant():
            rec["controls"][name] = errs(*sharded_step()[:2])
    return rec


def sharded_grads(cfg, mesh, p0, local):
    """(loss, grads, params as DTensors) of the sharded forward and backward
    on this rank's rows: the loss this rank's own, each grad this rank's
    shard (summed over the dp ranks where the FSDP gather shards its leaf
    over dp, this rank's own term elsewhere: the step sums those after)."""
    from repro_torch.distributed import parallel as P, sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import leaves, tree_map, unflatten

    dp = shd.distribute_tree(tree_map(torch.clone, p0), shd.param_shardings(mesh, p0))
    with P.sharded(mesh, unflatten(dp, [tuple(x.placements) for x in leaves(dp)])):
        loss, _, grads = S.loss_and_grads(cfg, unflatten(dp, [x.to_local() for x in leaves(dp)]), local)
    return loss, leaves(grads), leaves(dp)


def unequal_grads(cfg, opt, mesh, p0, s0, local, whole):
    """The leaves whose grad shard from the sharded forward and backward
    differs from one device's (and "loss" where the losses differ): one
    device's loss and grads on each dp rank's rows (`whole` is theirs in dp
    rank order), its grads summed over the dp ranks where the leaf is
    sharded over dp (two terms sum alike in either order) and this rank's
    own term elsewhere, as `sharded_grads` has them; this rank's chunk.
    Takes `setup`'s tuple."""
    import functools
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

    host, hosts = S.data_parallel_rank(mesh)
    rows = [{k: v.chunk(hosts)[h] for k, v in whole.items()} for h in range(hosts)]
    one = [S.loss_and_grads(cfg, tree_map(torch.clone, p0), r) for r in rows]
    loss, split, dp = sharded_grads(cfg, mesh, p0, local)
    dp_dims = [i for i, a in enumerate(mesh.mesh_dim_names) if a in shd.dp_axes(mesh)]
    out = [] if torch.equal(loss, one[host][0]) else ["loss"]
    for i, ((path, _), h, d) in enumerate(zip(leaves_with_path(one[0][2]), split, dp)):
        terms = [leaves(o[2])[i] for o in one]
        fsdp = any(d.placements[j].is_shard() for j in dp_dims)
        g = functools.reduce(torch.add, terms) if fsdp else terms[host]
        if not torch.equal(shd.local_chunk(g, mesh, d.placements), h):
            out.append(keystr(path))
    return out


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def local_capacity(dp):
    """The per-rank capacity brought back: each MoE routes its rank's share."""
    from repro_torch.models import layers as L
    cap = L.capacity
    return lambda: patched(L, "capacity", lambda t, cfg: cap(t // dp, cfg))


def no_model_sum():
    """The row-parallel sum over model dropped: each rank's own partial product."""
    from repro_torch.distributed import parallel as P
    return lambda: patched(P, "row_parallel", lambda h, w: h @ w)
'''

# ---------------------------------------------------------------------------
# (a) MoE on a dp mesh routes the global batch
# ---------------------------------------------------------------------------

DP_MOE = COMMON + '''
def body(rank, world, tmp):
    from repro_torch.models import layers as L
    from repro_torch.launch import steps as S

    cfg, opt, mesh, p0, s0, local, whole = setup("qwen3-moe-30b-a3b", "adamw", 2, 1, tmp)
    drops, route = [], L._route

    def counted(logits, e, k, *args, **kw):
        out = route(logits, e, k, *args, **kw)
        cap = int(np.ceil(out[1].numel() * cfg.capacity_factor / e))  # t * k / e * capacity_factor
        counts = torch.bincount(out[1].reshape(-1), minlength=e)
        drops.append(int(torch.clamp(counts - cap, min=0).sum()))
        return out

    with patched(L, "_route", counted):
        S.loss_and_grads(cfg, p0, whole)
    rec = run(cfg, opt, mesh, p0, s0, local, whole)
    rec["single_step_drops"] = drops
    return rec
'''


@pytest.fixture(scope="module")
def moe_weights(tmp_path_factory):
    """The reference's reduced qwen3-moe-30b-a3b weights (4 experts, top 2)
    in the shared checkpoint format, and its single-device loss and aux on
    the 2-host global batch."""
    cfg, opt, params, state = ref_state("qwen3-moe-30b-a3b")
    d = tmp_path_factory.mktemp("moe_weights")
    RefCheckpointManager(str(d)).save(0, params)
    batch = {k: jnp.asarray(v) for k, v in global_batch(cfg, hosts=2).items()}
    _, _, m = ref_steps.make_train_step(cfg, opt)(params, state, batch, jnp.int32(1))
    return str(d), float(m["loss"]), float(m["aux"])


def check_step(r, ref_loss=None, grad_norm=True):
    """The sharded step against the single-device step on the global batch:
    params and state within `TOL_SHARDED`, the update within `TOL_UPDATE`,
    the loss (the dp mean) and the aux loss within 1e-5 of it, the grad norm
    within 1e-4; every planted wrong step fails `TOL_UPDATE`."""
    m, s = r["metrics"], r["single"]
    assert r["diff"] <= TOL_SHARDED, r
    assert max(r["update_err"].values()) <= TOL_UPDATE, r
    assert abs(m["loss"] - s["loss"]) <= 1e-5 * s["loss"], r
    assert abs(m["aux"] - s["aux"]) <= 1e-5 * max(s["aux"], 1.0), r
    if grad_norm:
        assert abs(m["grad_norm"] - s["grad_norm"]) <= 1e-4 * s["grad_norm"], r
    for name, err in r["controls"].items():
        assert max(err.values()) > TOL_UPDATE, (name, r)
    if ref_loss is not None:
        assert abs(m["loss"] - ref_loss) <= TOL_LOSS * ref_loss, (r, ref_loss)


def test_moe_dp_step_routes_the_global_batch(tmp_path, moe_weights):
    """Reduced qwen3-moe on a 2 x 1 (data, model) mesh: the step's loss, aux
    loss and update equal the single-device step's on the global batch
    (capacity, sort order and aux means of all 256 tokens), on a batch where
    that step drops assignments (so a per-rank capacity would drop others)."""
    weights, ref_loss, ref_aux = moe_weights
    os.symlink(weights, tmp_path / "weights")
    out = run_child(tmp_path, DP_MOE, world=2)
    for r in out:
        assert sum(r["single_step_drops"]) > 0, r["single_step_drops"]
        check_step(r, ref_loss)
        assert abs(r["metrics"]["aux"] - ref_aux) <= TOL_LOSS * ref_aux, (r, ref_aux)
    assert out[0]["metrics"] == out[1]["metrics"]


# ---------------------------------------------------------------------------
# (b), (d) 2 x 2 steps, planted wrong steps, gather sizes
# ---------------------------------------------------------------------------

MESH_2X2 = COMMON + '''
def body(rank, world, tmp):
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun, steps as S
    from repro_torch.tree import keystr, leaves_with_path, tree_map

    out = {}
    cfg, opt, mesh, p0, s0, local, whole = setup("qwen3-moe-30b-a3b", OPTIMIZER, 2, 2, tmp)
    out["moe"] = run(cfg, opt, mesh, p0, s0, local, whole,
                     [("local_capacity", local_capacity(2)), ("no_model_sum", no_model_sum())])
    if OPTIMIZER == "adamw":
        for dispatch in ("gather", "local"):
            case = setup("qwen3-moe-30b-a3b", "adamw", 2, 2, tmp, moe_dispatch=dispatch)
            out["moe_" + dispatch] = run(*case)
        state = shd.distribute_tree(tree_map(torch.clone, (p0, s0)),
                                    (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0)))
        step = S.make_sharded_train_step(cfg, opt, mesh)
        with dryrun.CollectiveTally() as tally:
            step(*state, local, 1)
        stacked = [(keystr(p), t) for p, t in leaves_with_path(p0) if "blocks" in keystr(p)]
        out["gathers"] = sorted(b for op, b, g in tally.ops if op == "all-gather")
        out["max_rep_slice"] = max(t.numel() * t.element_size() // cfg.reps for _, t in stacked)
        out["max_stacked_leaf"] = max(t.numel() * t.element_size() for _, t in stacked)
        out["embed_gathered"] = p0["embed"].numel() * 4 // 2  # vocab gathered, d over model
        out["head_gathered"] = p0["lm_head"].numel() * 4 // 2  # d gathered, vocab over model
    return out
'''


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_moe_step_on_2x2_matches_single_device(tmp_path, moe_weights, optimizer):
    """Reduced qwen3-moe on a 2 x 2 (data, model) mesh (experts, heads and
    vocab split over model, FSDP over data): held as
    `test_sharded_step_matches_single_device` holds qwen3-8b, with planted
    wrong steps (the per-rank capacity brought back; the row-parallel sum
    over model dropped) failing `TOL_UPDATE`.  With AdamW, the other two
    dispatches ("gather", "local") too, and the step's all-gathers (the
    dry-run's `CollectiveTally`): none larger than one rep's slice of a
    stacked leaf but the embedding's and the head's, where gathering a whole
    stacked leaf would be."""
    weights, ref_loss, _ = moe_weights
    os.symlink(weights, tmp_path / "weights")
    out = run_child(tmp_path, f"OPTIMIZER = {optimizer!r}\n" + MESH_2X2, world=4)
    for r in out:
        check_step(r["moe"], ref_loss)
        assert set(r["moe"]["controls"]) == {"local_capacity", "no_model_sum"}
        if optimizer == "adamw":
            check_step(r["moe_gather"])
            check_step(r["moe_local"])
            allowed = {r["embed_gathered"], r["head_gathered"]}
            too_big = [b for b in r["gathers"] if b > r["max_rep_slice"] and b not in allowed]
            assert r["gathers"] and not too_big, (too_big, r["max_rep_slice"], allowed)
            assert r["max_stacked_leaf"] > max(r["max_rep_slice"], *allowed)
    assert len({r["moe"]["metrics"]["loss"] for r in out}) == 1


# ---------------------------------------------------------------------------
# (c) the model axis splits the compute
# ---------------------------------------------------------------------------

MESH_1X2 = COMMON + '''
def body(rank, world, tmp):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import tree_map

    out = {}
    for arch in ("qwen3-8b", "qwen3-moe-30b-a3b"):
        cfg, opt, mesh, p0, s0, local, whole = setup(arch, "adamw", 1, 2, tmp)
        with FlopCounterMode(display=False) as one:
            S.make_train_step(cfg, opt)(*tree_map(torch.clone, (p0, s0)), whole, 1)
        dp, ds = shd.distribute_tree(tree_map(torch.clone, (p0, s0)),
                                     (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0)))
        with FlopCounterMode(display=False) as split:
            S.make_sharded_train_step(cfg, opt, mesh)(dp, ds, local, 1)
        out[arch] = {"flops": split.get_total_flops(), "single_flops": one.get_total_flops()}
        out[arch + "/step"] = dict(run(cfg, opt, mesh, p0, s0, local, whole),
                                   unequal_grads=unequal_grads(cfg, opt, mesh, p0, s0, local, whole))
    # remat with the backward on another thread, as autograd runs it on a card's
    # own thread, where the caller's context is not seen
    import threading
    from repro_torch.distributed import parallel as P
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, unflatten
    cfg, opt, mesh, p0, s0, local, whole = setup("qwen3-moe-30b-a3b", "adamw", 1, 2, tmp, remat=True)
    dp = shd.distribute_tree(tree_map(torch.clone, p0), shd.param_shardings(mesh, p0))
    places = unflatten(dp, [tuple(x.placements) for x in leaves(dp)])
    grads = []
    for threaded in (False, True):
        trainable = [x.to_local().detach().requires_grad_() for x in leaves(dp)]
        with P.sharded(mesh, places):
            loss, _ = T.loss_fn(unflatten(dp, trainable), cfg, local)
        if threaded:
            box = []
            worker = threading.Thread(target=lambda: box.append(torch.autograd.grad(loss, trainable)))
            worker.start()
            worker.join()
            grads.append(box[0])
        else:
            with P.sharded(mesh, places):
                grads.append(torch.autograd.grad(loss, trainable))
    out["remat_threaded_equal"] = all(torch.equal(a, b) for a, b in zip(*grads))
    # heads the split cuts (1.5 q heads and half a kv head a rank), and a tied head
    case = setup("qwen3-8b", "adamw", 1, 2, tmp, num_heads=3, num_kv_heads=1)
    out["cut_heads"] = dict(run(*case), unequal_grads=unequal_grads(*case))
    out["tied"] = run(*setup("qwen3-8b", "adamw", 1, 2, tmp, tie_embeddings=True))
    return out
'''


def test_model_axis_splits_the_work(tmp_path):
    """On a 1 x 2 (data, model) mesh each rank's step does at most 0.6 of the
    single-device step's matmul flops (`FlopCounterMode`), for reduced
    qwen3-8b and qwen3-moe, and the step equals the single-device step, its
    loss bit for bit (every output element of a split matmul is computed
    whole on one rank): also where the head is the tied embedding
    (redistributed so that the vocab is over model) and where the split cuts
    heads (3 q heads of 32 and 1 kv head over 2 ranks).  There the heads
    are gathered whole and each batch row's kv group attended on one rank
    (`layers._attend_units`), so nothing is summed over model: that case
    is held with AdamW (whose first step, about lr x sign(g), magnifies any
    rounding of a grad near 0) and the grad-norm bound.  In every case
    every leaf's grad shard equals one device's bit for bit: also the q / k
    norms' where each rank norms its own heads (`layers.head_norm` gathers
    the per-head partials and sums them in one device's order)."""
    out = run_child(tmp_path, MESH_1X2, world=2)
    for r in out:
        for arch in ("qwen3-8b", "qwen3-moe-30b-a3b"):
            assert r[arch]["flops"] <= 0.6 * r[arch]["single_flops"], (arch, r[arch])
            check_step(r[arch + "/step"])
        assert r["remat_threaded_equal"]
        check_step(r["tied"])
        check_step(r["cut_heads"])
        for case in ("qwen3-8b/step", "qwen3-moe-30b-a3b/step", "cut_heads"):
            assert not r[case]["unequal_grads"], (case, r[case]["unequal_grads"])
        for case in (r["qwen3-8b/step"], r["qwen3-moe-30b-a3b/step"], r["tied"], r["cut_heads"]):
            assert case["metrics"]["loss"] == case["single"]["loss"], case
    assert out[0]["qwen3-8b"] == out[1]["qwen3-8b"]


# ---------------------------------------------------------------------------
# (e) heads and kv groups the split cuts: exact
# ---------------------------------------------------------------------------

#: (name, arch, overrides, batch) of each (data, model) mesh: a kv group
#: spread over two ranks with no cut column (4 q heads of 1 kv group, 2 a
#: rank); whisper's encoder, self- and cross-attention with 3 heads cut over
#: 2 ranks; on 1 x 4 reduced qwen3-8b (1 q head a rank, its kv group over 2
#: ranks) and 3 q heads of one kv group at batch 3 (3 units for 4 ranks:
#: rank 3 attends to none, the gathers pad); on 2 x 2 3 q heads of one kv
#: group, FSDP over data.
SPLIT_CASES = {
    (1, 2): (("kv_group", "qwen3-8b", {"num_heads": 4, "num_kv_heads": 1}, 4),
             ("whisper_cut", "whisper-small", {"num_heads": 3, "num_kv_heads": 3}, 4)),
    (1, 4): (("qwen3-8b", "qwen3-8b", {}, 4),
             ("idle_rank", "qwen3-8b", {"num_heads": 3, "num_kv_heads": 1}, 3)),
    (2, 2): (("cut_heads", "qwen3-8b", {"num_heads": 3, "num_kv_heads": 1}, 4),),
}

SPLIT_GROUPS = COMMON + '''
def body(rank, world, tmp):
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import parallel as P
    from repro_torch.models import layers as L

    out, units = {}, []
    attend = L._sdpa

    def counted(q, *args, **kw):  # the units each rank attends in the sharded step
        if P.current() is not None:
            units.append(q.shape[0])
        return attend(q, *args, **kw)

    for name, arch, over, batch in CASES:
        case = setup(arch, "adamw", DATA, MODEL, tmp, batch=batch, **over)
        units.clear()
        with patched(L, "_sdpa", counted):
            rec = run(*case)
        out[name] = dict(rec, units=list(units), unequal_grads=unequal_grads(*case))
    if REF:  # the reference's weights: the sharded grads assembled whole for the pytest process
        cfg, opt, mesh, p0, s0, local, whole = setup(*REF, "adamw", DATA, MODEL, tmp, batch=REF_BATCH,
                                                     weights="ref_weights", **REF_OVER)
        loss, grads, dp = sharded_grads(cfg, mesh, p0, local)
        full = [DTensor.from_local(g, mesh, d.placements, run_check=False).full_tensor() for g, d in zip(grads, dp)]
        if rank == 0:
            np.savez(os.path.join(tmp, "port_grads.npz"), *[g.float().numpy() for g in full])
        out["ref_loss"] = float(loss)
    return out
'''

#: The case held against the JAX reference (on the 1 x 4 mesh): 3 q heads
#: of one kv group at batch 3, one rank idle.
REF_CASE = ("qwen3-8b", {"num_heads": 3, "num_kv_heads": 1}, 3)


@pytest.fixture(scope="module")
def ref_split_weights(tmp_path_factory):
    """`REF_CASE`'s reference weights (seed 0) in the shared checkpoint
    format, and the reference's loss and grads (`jax.value_and_grad` of its
    `loss_fn`, one device) on its batch."""
    import jax
    from repro.configs.registry import get_config as ref_get_config
    from repro.data.pipeline import SyntheticStream as RefStream
    from repro.models import transformer as RT

    arch, over, batch = REF_CASE
    cfg = ref_get_config(arch).reduced(**over)
    params = RT.init_params(cfg, jax.random.PRNGKey(0))
    d = tmp_path_factory.mktemp("ref_split_weights")
    RefCheckpointManager(str(d)).save(0, params)
    inputs = {k: jnp.asarray(v) for k, v in RefStream(cfg, batch, 32).batch_at(1).items()}
    (loss, _), grads = jax.value_and_grad(RT.loss_fn, has_aux=True)(params, cfg, inputs)
    return str(d), float(loss), jax.tree_util.tree_flatten_with_path(grads)[0]


@pytest.mark.parametrize("data,model", list(SPLIT_CASES), ids=[f"{d}x{m}" for d, m in SPLIT_CASES])
def test_split_heads_and_kv_groups_are_exact(tmp_path, request, data, model):
    """Where the model split cuts a q head or spreads a kv group over ranks,
    the step equals the single-device step (`check_step`, AdamW, grad-norm
    bound included), its loss and grad norm bit for bit on 1 x m, and every leaf's grad
    shard bit for bit (`unequal_grads`: on 2 x 2 one device's grads on each
    dp rank's rows, summed over dp as the FSDP gather sums them, and each
    rank's loss one device's on its rows).  Each rank attends its run of
    the batch rows' kv groups, ceil(units / m), the last ranks fewer
    (`SPLIT_CASES`).  On 1 x 4 the case with an idle rank, on the
    reference's weights, has its loss within `TOL_LOSS` of the JAX
    reference's and each grad leaf within `TOL_GRAD`."""
    import jax
    import numpy as np
    from test_torch_grads import TOL_GRAD, grad_tol, rel_err

    cases = SPLIT_CASES[(data, model)]
    ref = (data, model) == (1, 4)
    code = (f"CASES = {cases!r}\nDATA, MODEL = {data}, {model}\n"
            f"REF, REF_OVER, REF_BATCH = {REF_CASE[:1] if ref else ()!r}, {REF_CASE[1]!r}, {REF_CASE[2]}\n")
    if ref:
        weights, ref_loss, ref_grads = request.getfixturevalue("ref_split_weights")
        os.symlink(weights, tmp_path / "ref_weights")
    out = run_child(tmp_path, code + SPLIT_GROUPS, world=data * model)
    for rank, r in enumerate(out):
        for name, arch, over, batch in cases:
            case = r[name]
            check_step(case)
            assert not case["unequal_grads"], (name, case["unequal_grads"])
            if data == 1:
                assert case["metrics"]["loss"] == case["single"]["loss"], (name, case)
                assert case["metrics"]["grad_norm"] == case["single"]["grad_norm"], (name, case)
            units = batch // data * over.get("num_kv_heads", 2)
            per = -(-units // model)
            mine = min(per, max(units - (rank % model) * per, 0))
            assert case["units"] and set(case["units"]) == {mine}, (name, rank, case["units"], mine)
    if ref:
        assert out[-1]["idle_rank"]["units"] == [0] * len(out[-1]["idle_rank"]["units"])
        assert abs(out[0]["ref_loss"] - ref_loss) <= TOL_LOSS * ref_loss, (out[0]["ref_loss"], ref_loss)
        got = np.load(tmp_path / "port_grads.npz")
        assert len(got.files) == len(ref_grads)
        for i, (path, g) in enumerate(ref_grads):
            key = jax.tree_util.keystr(path)
            assert rel_err(g, torch.from_numpy(got[f"arr_{i}"])) <= grad_tol(key, TOL_GRAD), key


# ---------------------------------------------------------------------------
# (f) Adafactor's factored means over a split dim: exact
# ---------------------------------------------------------------------------

ADAFACTOR_ARCHS = ("qwen3-8b", "qwen3-moe-30b-a3b")

ADAFACTOR_1XM = COMMON + '''
def body(rank, world, tmp):
    import math
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import keystr, leaves, leaves_with_path, tree_map

    def summed(mesh, place):
        """The factored mean as it was: each rank's `torch.sum` all-reduced
        over the ranks that split the dim, over the whole dim's size."""
        def mean(x, dim, keepdim=False):
            groups = [mesh.get_group(i) for i, p in enumerate(place) if p.is_shard(x.dim() + dim) and mesh.size(i) > 1]
            if not groups:
                return torch.mean(x, dim, keepdim=keepdim)
            total = S._all_reduce_sum(torch.sum(x, dim, keepdim=keepdim), groups)
            return total / torch.tensor(float(x.shape[dim] * math.prod(g.size() for g in groups)))
        return mean

    def differing(cfg, opt, mesh, p0, s0, local, whole):
        """The param leaves whose param or optimizer state after the sharded
        step differs from one device's, and the metrics of both."""
        fresh = lambda: tree_map(torch.clone, (p0, s0))
        dp, ds = shd.distribute_tree(fresh(), (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0)))
        dp, ds, m = S.make_sharded_train_step(cfg, opt, mesh)(dp, ds, local, 1)
        p1, s1, m1 = S.make_train_step(cfg, opt)(*fresh(), whole, 1)
        full = lambda x: x.full_tensor() if isinstance(x, DTensor) else x
        out = set()
        for tree, (a, b) in (("param", (dp, p1)), ("state", (ds["v"], s1["v"]))):
            for (path, x), y in zip(leaves_with_path(a), leaves(b)):
                if not torch.equal(full(x), y):
                    out.add(keystr(path[:-1] if tree == "state" and path[-1] in ("vr", "vc", "v") else path))
        return sorted(out), {k: [float(m[k]), float(m1[k])] for k in ("loss", "grad_norm")}

    out = {}
    for arch in ARCHS:
        case = setup(arch, "adafactor", 1, MODEL, tmp)
        leaves_off, metrics = differing(*case)
        with patched(S, "_sharded_mean", summed):
            control, _ = differing(*case)
        out[arch] = {"differ": leaves_off, "metrics": metrics, "control": control,
                     "unequal_grads": unequal_grads(*case)}
    return out
'''


@pytest.mark.parametrize("model", [2, 4], ids=["1x2", "1x4"])
def test_adafactor_on_1xm_equals_one_device(tmp_path, model):
    """One Adafactor step of reduced qwen3-8b and qwen3-moe on a 1 x m
    (data, model) mesh: loss and grad norm equal one device's, and every
    param and state leaf whose grad shards equal one device's
    (`unequal_grads`) equals its leaf bit for bit, and every grad shard
    equals one device's: on 1 x 2 too, where each rank norms its own q / k
    heads (`layers.head_norm` sums the norms' weight grads in one device's
    order), and on 1 x 4, where the heads are normed whole.  Each factored
    mean over a dim the model axis splits is its runs' sums
    (`optim.factored_mean`), each rank's
    runs gathered and summed in one device's order
    (`steps._sharded_mean`).  The control, the mean as it was (each rank's
    sum all-reduced), puts leaves off whose grads are equal (4.1-4.2e-7 of
    the update at 1 x 4 on four H100s)."""
    out = run_child(tmp_path, f"ARCHS = {ADAFACTOR_ARCHS!r}\nMODEL = {model}\n" + ADAFACTOR_1XM, world=model)
    for r in out:
        for arch in ADAFACTOR_ARCHS:
            case = r[arch]
            unequal = set(case["unequal_grads"])
            assert set(case["differ"]) <= unequal, (arch, case)
            assert not unequal, (arch, case)
            assert all(a == b for a, b in case["metrics"].values()), (arch, case)
            assert set(case["control"]) - unequal, (arch, case)
