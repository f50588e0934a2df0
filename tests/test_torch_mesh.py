"""`repro_torch.launch.mesh` and the sharding rules' placements on real ranks.

The abstract meshes need no process group and are checked here; every
`DeviceMesh` is built in a child interpreter (`torch_dist.run_child`), on
gloo ranks spawned there.
"""
import pytest
import torch.distributed as dist

from repro_torch.launch import mesh as mesh_lib
from torch_dist import run_child


def test_production_meshes_are_abstract():
    m = mesh_lib.make_production_mesh()
    assert (m.axis_names, m.axis_sizes, m.size, m.shape) == (("data", "model"), (16, 16), 256,
                                                              {"data": 16, "model": 16})
    m = mesh_lib.make_production_mesh(multi_pod=True)
    assert (m.axis_names, m.size, m.shape["pod"]) == (("pod", "data", "model"), 512, 2)


def test_host_mesh_needs_an_initialised_world():
    """Without a process group the mesh functions raise instead of starting one."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_lib.make_host_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_lib.make_mesh(("data",), (1,), "cpu")
    assert not dist.is_initialized()


ROUND_TRIP = '''
def body(rank, world, tmp):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_host_mesh, make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.tree import keystr, leaves_with_path

    assert tuple(make_host_mesh(device="cpu").shape) == (4, 1)
    mesh = make_host_mesh(data=2, model=2, device="cpu")
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    out = {"leaves": 0, "sharded": 0}
    for (path, t), (_, s) in zip(leaves_with_path(params), leaves_with_path(shd.param_shardings(mesh, params))):
        place = s.placements()
        d = distribute_tensor(t, mesh, place)
        mine = shd.distribute(t, mesh, place)
        assert torch.equal(d.full_tensor(), t), keystr(path)
        assert torch.equal(mine.to_local(), d.to_local()), keystr(path)
        assert tuple(d.to_local().shape) == shd.local_shape(mesh, s.spec, t.shape), keystr(path)
        out["leaves"] += 1
        out["sharded"] += any(p.is_shard() for p in place)
    x = shd.distribute(torch.arange(64.0).reshape(2, 4, 8), mesh, shd.placements(mesh, shd.P()))
    with shd.use_mesh(mesh):
        y = shd.maybe_constrain(x, "logits")  # (dp, None, model)
    out["constrained"] = str(y.placements)
    out["constrained_equal"] = torch.equal(y.full_tensor(), x.full_tensor())
    pods = make_mesh(("pod", "data"), (2, 2), "cpu")
    z = shd.distribute(torch.arange(32.0).reshape(8, 4), pods, shd.placements(pods, shd.P(("pod", "data"))))
    out["pod_major"] = z.to_local()[:, 0].tolist()
    return out
'''


def test_placements_round_trip_on_four_ranks(tmp_path):
    """Every param of a reduced MoE model, placed by the rules on a 2 x 2 gloo
    mesh: `distribute_tensor` / `full_tensor` give it back exactly, its local
    shard has `local_shape` and equals `sharding.distribute`'s; inside
    `use_mesh` a replicated activation is redistributed to its role's spec;
    a dim over ("pod", "data") is split pod-major."""
    out = run_child(tmp_path, ROUND_TRIP, world=4)
    for r, rec in enumerate(out):
        assert rec["leaves"] == 15 and rec["sharded"] >= 10, rec
        assert rec["constrained"] == "(Shard(dim=0), Shard(dim=2))" and rec["constrained_equal"]
        assert rec["pod_major"] == [4.0 * (2 * r + i) for i in range(2)]
