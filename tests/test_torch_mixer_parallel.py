"""The model axis of `repro_torch`'s sharded train step for the SSD mixer,
cross-attention (the `cross` mixer and `attn_cross`'s `cross` subtree) and
the whisper encoder, and `moe_local` on a dp mesh whose size does not
divide its block count.

As in test_torch_model_parallel.py (whose child code, `COMMON`, these
reuse): every multi-rank case runs in a child interpreter
(`torch_dist.run_child`), the cases of one mesh share a child, and the
single-device step they are held against is `make_train_step` on the
global batch.  The weights are the port's own seed-0 draw.
"""
import itertools
import math

import pytest

from repro_torch.configs.registry import get_config
from repro_torch.models import ssm
from test_torch_model_parallel import COMMON, check_step
from torch_dist import run_child

#: The four archs whose mixers this covers, reduced: mamba2 (one group, so
#: every rank uses all of B / C), jamba (two groups, one a rank, beside
#: attention and MoE), whisper (encoder + `attn_cross`) and llama-vision
#: (the `cross` mixer).
ARCHS = ("mamba2-780m", "jamba-1.5-large-398b", "whisper-small", "llama-3.2-vision-11b")

PLANTS = COMMON + '''
def ssd_plain_slice():
    """The SSD's heads taken by a plain slice: the other ranks' heads' grads
    of the replicated part are dropped."""
    from repro_torch.distributed import parallel as P

    def plain(x, dim):
        plan = P.current()
        n = x.shape[dim] // plan.model_size
        return x.narrow(dim, plan.model_rank * n, n)

    return lambda: patched(P, "split_to_model", plain)


def ssd_summed_gather():
    """`gather_model_sum` in place of `gather_model` before the SSD: the
    replicated part's whole grads summed over the ranks, `model` times over."""
    from repro_torch.distributed import parallel as P
    from repro_torch.models import ssm
    return lambda: patched(ssm.P, "gather_model", P.gather_model_sum)
'''

MESH_1X2 = PLANTS + '''
def body(rank, world, tmp):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps as S
    from repro_torch.tree import tree_map

    out = {}
    for arch in ARCHS:
        cfg, opt, mesh, p0, s0, local, whole = setup(arch, "adamw", 1, 2, tmp)
        unequal = unequal_grads(cfg, opt, mesh, p0, s0, local, whole)
        with FlopCounterMode(display=False) as one:
            S.make_train_step(cfg, opt)(*tree_map(torch.clone, (p0, s0)), whole, 1)
        dp, ds = shd.distribute_tree(tree_map(torch.clone, (p0, s0)),
                                     (shd.param_shardings(mesh, p0), shd.opt_shardings(mesh, s0)))
        with FlopCounterMode(display=False) as split:
            S.make_sharded_train_step(cfg, opt, mesh)(dp, ds, local, 1)
        controls = [("plain_slice", ssd_plain_slice()), ("summed_gather", ssd_summed_gather())]
        out[arch] = run(cfg, opt, mesh, p0, s0, local, whole, controls if arch == "mamba2-780m" else ())
        out[arch].update(flops=split.get_total_flops(), single_flops=one.get_total_flops(), unequal_grads=unequal)
    # the grouped SSD: whole groups a rank (jamba's 2 over 2), or a clear error
    out["grouped"] = run(*setup("jamba-1.5-large-398b", "adamw", 1, 2, tmp, ssm_impl="grouped"))
    try:
        run(*setup("mamba2-780m", "adamw", 1, 2, tmp, ssm_impl="grouped"))
        out["grouped_cut"] = "ran"
    except ValueError as err:
        out["grouped_cut"] = str(err)
    return out
'''


def test_mixers_split_over_model(tmp_path):
    """On a 1 x 2 (data, model) mesh the SSD, cross-attention and the whisper
    encoder compute on their model shards: each rank does at most 0.6 of the
    single-device step's matmul flops, and the step equals the
    single-device step on the global batch (`check_step`, grad norm
    included), its loss bit for bit and every leaf's grad shard bit for
    bit.  No grad is summed over `model` (mamba2's one group of B / C
    included): the SSD's heads come out of replicated activations through
    `split_to_model`, whose backward all-gathers each head's grad from its
    rank.  (The update still differs by ~1e-6 in some cases: the grad
    norm sums the shards' squares over ranks.)  Two planted wrong SSD steps
    fail `TOL_UPDATE`: the heads taken by a plain slice, and the in_proj
    gather's backward summing the ranks' whole grads.  The grouped SSD runs
    where each rank holds whole groups and raises where a group would be
    cut."""
    out = run_child(tmp_path, f"ARCHS = {ARCHS!r}\n" + MESH_1X2, world=2)
    for r in out:
        for arch in ARCHS:
            case = r[arch]
            assert case["flops"] <= 0.6 * case["single_flops"], (arch, case)
            check_step(case)
            assert case["metrics"]["loss"] == case["single"]["loss"], (arch, case)
            assert not case["unequal_grads"], (arch, case["unequal_grads"])
        assert set(r["mamba2-780m"]["controls"]) == {"plain_slice", "summed_gather"}
        check_step(r["grouped"])
        assert r["grouped"]["metrics"]["loss"] == r["grouped"]["single"]["loss"], r["grouped"]
        assert "whole groups" in r["grouped_cut"], r["grouped_cut"]
    assert out[0]["mamba2-780m"]["metrics"] == out[1]["mamba2-780m"]["metrics"]


MESH_1X1 = COMMON + '''
def body(rank, world, tmp):
    return {arch: run(*setup(arch, "adamw", 1, 1, tmp)) for arch in ARCHS}
'''


def test_one_rank_mesh_is_bit_exact(tmp_path):
    """On a 1 x 1 mesh the sharded step runs the single-device code (no
    collective, nothing split) for the four archs: every leaf of the
    params and the AdamW state and every metric equal bit for bit."""
    out = run_child(tmp_path, f"ARCHS = {ARCHS!r}\n" + MESH_1X1, world=1)
    for arch, case in out[0].items():
        assert case["diff"] == 0.0, (arch, case)
        assert case["metrics"] == case["single"], (arch, case)


DP_LOCAL = COMMON + '''
def body(rank, world, tmp):
    import functools
    from repro_torch.models import layers as L

    cfg, opt, mesh, p0, s0, local, whole = setup("qwen3-moe-30b-a3b", "adamw", 2, 1, tmp, seq=24,
                                                  moe_dispatch="local")
    with patched(L, "moe_local", functools.partial(L.moe_local, n_blocks=3)):
        return run(cfg, opt, mesh, p0, s0, local, whole)
'''


def test_moe_local_runs_blocks_that_straddle_dp_ranks(tmp_path):
    """`moe_dispatch="local"` with 3 blocks of the 4 x 24 global batch on a
    2 x 1 (data, model) mesh: the middle block holds tokens of both ranks;
    each rank runs the blocks that hold its tokens from the tokens
    all-gathered over dp, and the step equals the single-device step."""
    for r in run_child(tmp_path, DP_LOCAL, world=2):
        check_step(r)


# ---------------------------------------------------------------------------
# the SSD's contraction order under a head split
# ---------------------------------------------------------------------------

#: The six three-operand SSD contractions: (subscript, operand letters'
#: roles), baseline form then grouped form (`ssm.ssd_chunked`,
#: `ssm.ssd_chunked_grouped`).
SSD_SUBS = ("bchls,bchls,bcshp->bclhp", "bclhn,bclh,bclhp->bchpn", "bclhn,bchpn,bclh->bclhp",
            "bcgls,bcghls,bcsghp->bclghp", "bclgn,bclgh,bclghp->bcghpn", "bclgn,bcghpn,bclgh->bclghp")


def _ssd_cases():
    """(arch, size, model ranks, subscript): mamba2 and jamba at full size
    (batch 4 x seq 512) and reduced (2 x 32), over 2 and 16 ranks where
    the heads split evenly; the grouped subscripts only where the ranks
    hold whole groups."""
    for arch, reduced, m, sub in itertools.product(("mamba2-780m", "jamba-1.5-large-398b"), (False, True),
                                                   (2, 16), SSD_SUBS):
        cfg = get_config(arch).reduced() if reduced else get_config(arch)
        if cfg.ssm_heads % m or "g" in sub.split("->")[0] and cfg.ssm_groups % m:
            continue
        yield pytest.param(arch, reduced, m, sub, id=f"{arch}-{'reduced' if reduced else 'full'}-{m}-{sub}")


def _shapes(sub: str, sizes: dict) -> list:
    return [tuple(sizes[c] for c in term) for term in sub.split("->")[0].split(",")]


@pytest.mark.parametrize("arch,reduced,m,sub", list(_ssd_cases()))
def test_ssd_contraction_order_survives_the_head_split(arch, reduced, m, sub):
    """`einsum3` picks its pair from the shapes it sees; with H / m heads
    (and G / m groups) a rank sees other shapes than one device.  Every pair
    of every SSD subscript holds `h` (and `g`), so the pair it picks is the
    same at the local and the global shapes."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    b, s = (2, 32) if reduced else (4, 512)
    l = cfg.ssm_chunk
    g = cfg.ssm_groups
    sizes = dict(b=b, c=s // l, l=l, s=l, p=cfg.ssm_head_dim, n=cfg.ssm_state)
    whole = dict(sizes, h=cfg.ssm_heads, g=g)
    if "g" in sub.split("->")[0]:  # grouped: h is the heads of one group
        whole["h"] = cfg.ssm_heads // g
        local = dict(whole, g=g // m)
    else:
        local = dict(whole, h=cfg.ssm_heads // m)
    assert math.prod(local.values()) < math.prod(whole.values())
    assert ssm.contraction_order(sub, _shapes(sub, local)) == ssm.contraction_order(sub, _shapes(sub, whole))
