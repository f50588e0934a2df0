"""The SSD's head split on one device (`repro_torch.launch.parallel_check.
ssd_head_split`): a mixer's `ssm._ssd_heads` on all its heads, and on its
heads in the runs that 1, 2 and 4 ranks of the sharded step hold
(`parallel.split_to_model`), forward and backward; every output and grad of
the runs, concatenated, must equal the whole call's bit for bit.  On the
card (`chip_smoke.py`'s dist phase, part `ssd_head_split`) a reduction's
launch shape follows the number of rows it sums, so a rank's per-head
vectors sum their grads at their place among all the heads
(`ssm._Broadcast`, `parallel.model_run`); here the same check runs on the
CPU at the reduced sizes; and `parallel_check`'s block trace, which found
where reduced jamba's 1 x 4 step first differs on four cards.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import parallel as P
from repro_torch.launch import parallel_check as pc
from repro_torch.models import ssm

REDUCED = [s for s in pc.SSD_SPLITS if not s[2]]


@pytest.mark.parametrize("runs", [1, 2, 4])
@pytest.mark.parametrize("split", REDUCED, ids=[s[0] for s in REDUCED])
def test_ssd_head_split_is_exact(split, runs):
    name, arch, full, batch, seq = split
    out = pc.ssd_head_split(arch, runs, "cpu", full, batch, seq)
    assert out["heads"] == 4 and out["heads_per_run"] == -(-4 // runs)
    assert set(out["tensors"]) == {"y", "state", "z", "x", "B", "C", "dt", "a_log", "dt_bias", "skip_d"}
    assert out["exact"], {k: v for k, v in out["tensors"].items() if not v["equal"]}


def test_broadcast_sums_a_run_at_its_place():
    """A run's per-head grads summed among all the heads' rows (the others
    zero) equal the whole vector's sums of those heads, and its forward is
    the plain broadcast."""
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.standard_normal((3, 40, 12)).astype(np.float32))
    whole = torch.zeros(12, requires_grad=True)
    ssm._bcast(whole, g).backward(g)
    for lo, n in ((0, 3), (3, 3), (9, 3), (4, 8)):
        part = torch.zeros(n, requires_grad=True)
        y = ssm._bcast(part, g[..., lo:lo + n], (lo, 12))
        assert y.shape == (3, 40, n) and not y.is_contiguous()
        y.backward(g[..., lo:lo + n])
        assert torch.equal(part.grad, whole.grad[lo:lo + n])


def test_model_run_without_a_plan_is_everything():
    assert P.current() is None and P.model_run(48) == (0, 48)


def test_chip_smoke_ssd_head_split_part_on_cpu():
    """`chip_smoke.py`'s part `ssd_head_split` rehearsed at the reduced splits."""
    cs = __import__("test_torch_serve")._load_chip_smoke()
    out = cs.check_ssd_head_split("cpu", runs=(4, 2), splits=REDUCED)
    assert out["exact"] and [(c["case"], c["runs"]) for c in out["cases"]] == [
        ("mamba2 reduced", 4), ("mamba2 reduced", 2), ("jamba reduced", 4), ("jamba reduced", 2)]


def test_block_trace_finds_the_first_unequal_value():
    """`parallel_check`'s trace (`--trace`) of reduced jamba's forward: two
    runs on one device record every block, routing, mixer and MoE value and
    compare equal; a planted difference in the second mixer's
    in-projection is found there, with its size."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import make_inputs
    from repro_torch.models import transformer as T

    cfg = get_config("jamba-1.5-large-398b").reduced()
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in make_inputs(cfg, 2, 8, seed=0).items()}
    traces = []
    for _ in range(2):
        with pc.BlockTrace() as trace:
            T.forward(params, cfg, batch)
        traces.append(trace)
    assert ssm._causal_conv is traces[0]._saved["mixer in_proj"]  # unpatched on exit
    out = pc.compare_traces(*traces, rank=0, batch=2, hosts=1)
    assert out["block"]["calls"] == [16, 16] and out["routing"]["calls"] == [8, 8]
    assert out["mixer in_proj"]["calls"] == [14, 14]
    assert all(v["unequal_calls"] == [] for v in out.values()), out
    planted = traces[1].records["mixer in_proj"][1]
    planted.view(-1)[7] += 1.0
    out = pc.compare_traces(*traces, rank=0, batch=2, hosts=1)
    assert out["mixer in_proj"]["unequal_calls"] == [1] and out["mixer in_proj"]["first_unequal"]["max_abs_diff"] > 0
    assert out["block"]["unequal_calls"] == []
