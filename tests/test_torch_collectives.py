"""`repro_torch.distributed.compression`'s collectives against `repro`'s and
against their definition.

The port's ranks run in a child interpreter (`torch_dist.run_child`, gloo);
the reference's `shard_map` runs in a subprocess of its own with forced host
devices, as `tests/test_distributed.py::test_compressed_psum_small_mesh`
runs it.  Inputs come from one numpy seed.
"""
import os
import subprocess
import sys

import numpy as np
import torch

from torch_dist import SRC, run_child

REF_PSUM = '''
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.distributed.compression import compressed_psum

kw = {}
at = getattr(jax.sharding, 'AxisType', None)
if at is not None:
    kw['axis_types'] = (at.Auto,) * 2
mesh = jax.make_mesh((2, 4), ('pod', 'data'), **kw)
x = jnp.asarray(np.load(sys.argv[1]), jnp.float32)
g = shard_map(lambda x: compressed_psum(x, 'pod'), mesh=mesh, in_specs=P('pod', None), out_specs=P('pod', None))
np.save(sys.argv[2], np.asarray(g(x)))
'''

PORT_PSUM = '''
def body(rank, world, tmp):
    import numpy as np
    from repro_torch.distributed.compression import compressed_psum

    x = torch.from_numpy(np.load(os.path.join(tmp, "x.npy")))
    got = compressed_psum(torch.chunk(x, world)[rank], dist.group.WORLD)
    return got.view(torch.int32).flatten().tolist()
'''


def test_compressed_psum_equals_the_reference(tmp_path):
    """compressed_psum of each rank's half of one seeded (8, 64) input over 2
    gloo ranks equals, bit for bit, the reference's over the 'pod' axis of a
    (2, 4) mesh (each pod holds the same half), on every rank."""
    x = np.random.default_rng(0).standard_normal((8, 64)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8", PYTHONPATH=SRC,
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-c", REF_PSUM, str(tmp_path / "x.npy"), str(tmp_path / "ref.npy")],
                         capture_output=True, text=True, env=env, timeout=240)
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = np.load(tmp_path / "ref.npy")
    assert np.array_equal(want[:4], want[4:])
    for got in run_child(tmp_path, PORT_PSUM, world=2):
        assert got == want[:4].view(np.int32).ravel().tolist()
    exact = x[:4] + x[4:]
    assert np.abs(want[:4] - exact).max() <= 2 * np.abs(x).max() / 127  # the reference test's bound


PORT_HIER = '''
def body(rank, world, tmp):
    import numpy as np
    from repro_torch.distributed.compression import hierarchical_grad_sync
    from repro_torch.launch.mesh import make_mesh

    mesh = make_mesh(("pod", "data"), (2, 2), "cpu")
    grads = {k: torch.from_numpy(v[rank]) for k, v in np.load(os.path.join(tmp, "g.npz")).items()}
    out = hierarchical_grad_sync({"a": grads["a"], "b": [grads["b"]]}, mesh)
    return [out["a"].view(torch.int32).flatten().tolist(), out["b"][0].view(torch.int32).flatten().tolist()]
'''


def definition(g):
    """pmean over 'data', then compressed psum over 'pod' / npods, on a
    (pod, data, ...) stack of every rank's leaf: one result per pod."""
    g = torch.from_numpy(g)
    mean = (g[:, 0] + g[:, 1]) / 2
    scale = torch.clamp(mean.abs().amax(dim=tuple(range(1, mean.dim()))) / 127.0, min=1e-12).max()
    code = torch.clamp(torch.round(mean / scale), -127, 127).to(torch.int32)
    return (code[0] + code[1]).to(torch.float32) * scale / 2


def test_hierarchical_grad_sync_equals_its_definition(tmp_path):
    """On a 2 x 2 (pod, data) gloo mesh, every rank's result is the
    definition's on the gathered inputs, bit for bit, for each leaf."""
    rng = np.random.default_rng(1)
    g = {"a": rng.standard_normal((4, 6, 5)).astype(np.float32),
         "b": (rng.standard_normal((4, 33)) * 1e-3).astype(np.float32)}
    np.savez(tmp_path / "g.npz", **g)
    want = [definition(v.reshape(2, 2, *v.shape[1:])) for v in g.values()]
    for rank, got in enumerate(run_child(tmp_path, PORT_HIER, world=4)):
        assert got == [w.view(torch.int32).flatten().tolist() for w in want], rank
