"""`repro_torch.distributed.sharding`'s rule tables against `repro`'s, leaf for
leaf, and its placements.

The rule engine needs no devices: both packages' tables are computed over
abstract meshes (jax's `AbstractMesh`, the port's `launch.mesh.AbstractMesh`)
in this process; the shapes come from `jax.eval_shape` on the reference
side and from `meta` tensors on the port's.  Placements on real ranks are
checked in `test_torch_mesh.py` (a child interpreter).
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import ARCH_NAMES
from repro.configs.registry import effective_shape as ref_effective_shape
from repro.configs.registry import get_config as ref_get_config
from repro.distributed import sharding as ref_shd
from repro.launch import steps as ref_steps
from repro.optim import OptConfig as RefOptConfig
from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import effective_shape, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import steps
from repro_torch.launch.mesh import AbstractMesh, make_production_mesh
from repro_torch.optim import OptConfig
from repro_torch.tree import keystr, leaves_with_path

MESHES = {"16x16": (("data", "model"), (16, 16)), "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
OPTIMIZERS = {"adamw-f32": {}, "adamw-bf16": {"moment_dtype": "bfloat16"}, "adafactor": {"optimizer": "adafactor"}}


def meshes(name):
    names, sizes = MESHES[name]
    return AbstractMesh(names, sizes), JaxAbstractMesh(sizes, names)


def port_table(tree, shardings):
    """(path, shape, dtype, spec) per leaf of the port's tree and its shardings."""
    return [(keystr(p), tuple(t.shape), str(t.dtype).removeprefix("torch."), tuple(s.spec))
            for (p, t), (_, s) in zip(leaves_with_path(tree), leaves_with_path(shardings))]


def ref_table(tree, shardings):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(p), tuple(t.shape), str(t.dtype), tuple(s.spec))
            for (p, t), s in zip(flat, jax.tree.leaves(shardings))]


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    """Every leaf of the params and of the AdamW (f32 and bf16 moments) and
    Adafactor states at full size: the same path, shape, dtype and spec."""
    mesh, ref_mesh = meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    params, ref_params = steps.param_specs(cfg), ref_steps.param_specs(ref_cfg)
    got = port_table(params, shd.param_shardings(mesh, params))
    assert got == ref_table(ref_params, ref_shd.param_shardings(ref_mesh, ref_params))
    assert any(any(e is not None for e in row[3]) for row in got)
    for kw in OPTIMIZERS.values():
        opt, ref_opt = steps.opt_specs(cfg, OptConfig(**kw)), ref_steps.opt_specs(ref_cfg, RefOptConfig(**kw))
        assert port_table(opt, shd.opt_shardings(mesh, opt)) == ref_table(
            ref_opt, ref_shd.opt_shardings(ref_mesh, ref_opt)), kw


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_specs_equal_the_reference(arch, mesh_name):
    """Every input of every shape at full size (`input_specs`: batch, token,
    caches, step, pos) and the prefill's caches: the same path, shape and
    dtype, and for the batch and the caches the same spec."""
    mesh, ref_mesh = meshes(mesh_name)
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for name in SHAPES:
        eff, ref_eff = effective_shape(cfg, SHAPES[name]), ref_effective_shape(ref_cfg, REF_SHAPES[name])
        spec, ref_spec = steps.input_specs(cfg, eff), ref_steps.input_specs(ref_cfg, ref_eff)
        assert sorted(spec) == sorted(ref_spec)
        for key in ("token", "step", "pos"):
            if key in spec:
                t, r = spec[key], ref_spec[key]
                assert (tuple(t.shape), str(t.dtype)) == (tuple(r.shape), "torch." + str(r.dtype)), key
        if "batch" in spec:
            assert port_table(spec["batch"], shd.batch_shardings(mesh, spec["batch"])) == ref_table(
                ref_spec["batch"], ref_shd.batch_shardings(ref_mesh, ref_spec["batch"])), name
        caches = spec.get("caches") or steps.cache_specs(cfg, eff.global_batch, eff.seq_len)
        ref_caches = ref_spec.get("caches") or ref_steps.cache_specs(ref_cfg, ref_eff.global_batch, ref_eff.seq_len)
        assert port_table(caches, shd.cache_shardings(mesh, caches)) == ref_table(
            ref_caches, ref_shd.cache_shardings(ref_mesh, ref_caches)), name


# ---------------------------------------------------------------------------
# the reference's rule-engine tests (tests/test_distributed.py), on the port
# ---------------------------------------------------------------------------


class M:  # minimal mesh stub, as the reference's tests use
    axis_names = ("data", "model")
    shape = {"data": 16, "model": 16}


def test_param_spec_rules():
    spec = shd._param_spec("['blocks'][0]['mixer']['wq']", 3, M)
    assert spec == shd.P(None, ("data",), "model")
    spec = shd._param_spec("['embed']", 2, M)
    assert spec == shd.P(("data",), "model")
    spec = shd._param_spec("['blocks'][0]['ffn']['wi']", 4, M)  # MoE (reps,E,D,F)
    assert spec == shd.P(None, "model", ("data",), None)
    spec = shd._param_spec("['blocks'][0]['ln1']", 2, M)
    assert spec == shd.P(None, None)


def test_sanitize_drops_indivisible():
    s = shd._sanitize(M, shd.P("model", "data"), (48, 64))
    assert s == shd.P("model", "data")  # both divisible by 16: kept
    s = shd._sanitize(M, shd.P("model", "data"), (48, 30))
    assert s == shd.P("model", None)  # 30 % 16 != 0: dropped
    s = shd._sanitize(M, shd.P("model", "data"), (50, 30))
    assert s == shd.P(None, None)


def test_dp_axes_both_meshes():
    class M2:
        axis_names = ("data", "model")

    class M3:
        axis_names = ("pod", "data", "model")

    assert shd.dp_axes(M2) == ("data",)
    assert shd.dp_axes(M3) == ("pod", "data")
    assert shd.dp_axes(make_production_mesh(multi_pod=True)) == ("pod", "data")


@pytest.mark.parametrize("arch", ["qwen3-8b", "kimi-k2-1t-a32b", "mamba2-780m", "whisper-small"])
def test_shardings_cover_every_param(arch):
    flat = leaves_with_path(steps.param_specs(get_config(arch)))
    n_sharded = 0
    for path, leaf in flat:
        spec = shd._param_spec(keystr(path), leaf.ndim, M)
        spec = shd._sanitize(M, shd.P(*spec, *([None] * (leaf.ndim - len(spec)))), leaf.shape)
        assert len(spec) <= leaf.ndim
        if any(s is not None for s in spec):
            n_sharded += 1
    # the overwhelming majority of parameter BYTES must be sharded
    assert n_sharded >= len(flat) * 0.4, (arch, n_sharded, len(flat))


# ---------------------------------------------------------------------------
# specs as placements (a stub with DeviceMesh's names; no process group)
# ---------------------------------------------------------------------------


class DM:
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 4, 8)


def test_spec_keeps_a_one_tuple_as_its_name_like_jax():
    from jax.sharding import PartitionSpec

    for entries in [(None, ("data",), "model"), (("pod", "data"), None), (), ("model",)]:
        assert tuple(shd.P(*entries)) == tuple(PartitionSpec(*entries))
    assert shd.P(("data",)) == ("data",) and repr(shd.P("a", None)) == "P('a', None)"


def test_placements_shard_a_dim_over_its_axes_major_to_minor():
    assert shd.placements(DM, shd.P(("pod", "data"), "model")) == [Shard(0), Shard(0), Shard(1)]
    assert shd.placements(DM, shd.P(None, "data")) == [Replicate(), Shard(1), Replicate()]
    assert shd.placements(DM, shd.P()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh's order"):
        shd.placements(DM, shd.P(("data", "pod")))
    with pytest.raises(ValueError, match="shards two dims"):
        shd.placements(DM, shd.P("model", "model"))


def test_local_shape_divides_each_dim_by_its_axes():
    assert shd.local_shape(DM, shd.P(("pod", "data"), "model"), (64, 32, 5)) == (8, 4, 5)
    assert shd.local_shape(make_production_mesh(), shd.P(None, "data"), (3, 32)) == (3, 2)
    assert shd.axis_sizes(DM) == {"pod": 2, "data": 4, "model": 8}


def test_maybe_constrain_leaves_plain_tensors_and_meshless_runs_alone():
    x = torch.ones(4, 8)
    assert shd.maybe_constrain(x, "logits") is x
    with shd.use_mesh(DM):
        assert shd.maybe_constrain(x, "tokens_act") is x
    assert shd._MESH.get() is None
