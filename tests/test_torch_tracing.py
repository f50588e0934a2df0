"""The RNS product's spans and counters, on CPU tensors (the kernels' plain
versions): which `record_function` spans a product call opens under the
profiler and how they nest, that none is entered with the profiler off,
and what the always-on counters (`kernels.host_seconds`,
`he.rns.counters`) count."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import he, kernels
from repro_torch.he import rns

N, L, B = 64, 3, 4
WORDS = B * L * N


def draw(basis, rows, seed):
    q = torch.tensor(basis.moduli, dtype=torch.int64).view(1, -1, 1)
    x = torch.randint(0, 1 << 62, (rows, basis.towers, basis.n), generator=torch.Generator().manual_seed(seed))
    return x.remainder_(q).to(torch.int32).view(torch.uint32)


@pytest.fixture(scope="module")
def operands():
    basis = he.make_basis(N, L)
    return basis, draw(basis, B, 1), draw(basis, B, 2)


def program_spans(prof) -> list:
    """The `repro_torch.*` spans a profile recorded, by start."""
    events = [e for e in prof.events() if e.name.startswith("repro_torch.")]
    return sorted(events, key=lambda e: e.time_range.start)


def inside(child, parent) -> bool:
    return parent.time_range.start <= child.time_range.start and child.time_range.end <= parent.time_range.end


def test_a_product_call_opens_its_spans_nested(operands):
    basis, a, b = operands
    he.poly_mul_towers(basis, a, b)  # first call's one-time work outside the profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        he.poly_mul_towers(basis, a, b)
    found = program_spans(prof)
    assert len(found) == 3 * L + 4
    op = [e for e in found if e.name == "repro_torch.rns.poly_mul_towers"]
    assert len(op) == 1
    parts = [e for e in found if e.name in ("repro_torch.rns.split", "repro_torch.rns.towers",
                                            "repro_torch.rns.join")]
    assert [e.name for e in parts] == ["repro_torch.rns.split", "repro_torch.rns.towers", "repro_torch.rns.join"]
    assert all(inside(e, op[0]) for e in parts)
    towers = parts[1]
    wrappers = [e for e in found if e.name.startswith("repro_torch.kernels.")]
    assert [e.name for e in wrappers] == ["repro_torch.kernels.ntt_cuda", "repro_torch.kernels.modmul_cuda",
                                          "repro_torch.kernels.ntt_cuda"] * L
    assert all(inside(e, towers) for e in wrappers)


class Counting:
    """`record_function` as it is, counting the spans it is asked for."""

    entered = 0

    def __init__(self, name):
        Counting.entered += 1
        self._inner = REAL_RECORD_FUNCTION(name)

    def __enter__(self):
        return self._inner.__enter__()

    def __exit__(self, *exc):
        return self._inner.__exit__(*exc)


REAL_RECORD_FUNCTION = torch.profiler.record_function


@pytest.mark.parametrize("profiling,spans", [(False, 0), (True, 3 * L + 4)])
def test_spans_are_entered_only_under_the_profiler(operands, monkeypatch, profiling, spans):
    basis, a, b = operands
    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    Counting.entered = 0
    if profiling:
        with profile(activities=[ProfilerActivity.CPU]):
            he.poly_mul_towers(basis, a, b)
    else:
        he.poly_mul_towers(basis, a, b)
    assert Counting.entered == spans


def test_the_profiler_flag_the_spans_read_is_where_they_read_it():
    """`kernels._build.span` reads this private flag of torch's; an upgrade
    that moves it fails here."""
    assert torch.autograd.profiler._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert torch.autograd.profiler._is_profiler_enabled is False


def _product(basis, a, b):
    he.poly_mul_towers(basis, a, b)


def _broadcast_product(basis, a, b):
    he.poly_mul_towers(basis, a, b.view(torch.int32)[:1].view(torch.uint32))


def _transform_one(basis, a, b):
    he.ntt_towers(basis, a.view(torch.int32)[0].view(torch.uint32))


def _transform_batch(basis, a, b):
    he.ntt_towers(basis, a)


@pytest.mark.parametrize("call,split,join", [
    (_product, 16 * WORDS, 8 * WORDS),  # a and b written tower-major, c written back
    (_broadcast_product, 16 * WORDS, 8 * WORDS),  # the broadcast b's rows written out by the copy
    (_transform_one, 0, 8 * L * N),  # one contiguous [L, n]: the split makes no copy
    (_transform_batch, 8 * WORDS, 8 * WORDS),
])
def test_copy_bytes_count_what_the_split_and_join_copy(operands, call, split, join):
    basis, a, b = operands
    rns.reset_counters()
    call(basis, a, b)
    assert rns.counters()["copy_bytes"] == {"split": split, "join": join}


def test_host_seconds_advance_and_reset(operands):
    basis, a, b = operands
    kernels.reset_launch_counts()
    rns.reset_counters()
    he.poly_mul_towers(basis, a, b)
    wrappers = kernels.host_seconds()
    assert set(wrappers) == {"ntt_cuda", "modmul_cuda"} and all(s > 0 for s in wrappers.values())
    op = rns.counters()["host_s"]["poly_mul_towers"]
    assert op > sum(wrappers.values())  # the wrappers run inside the op
    kernels.reset_launch_counts()
    assert kernels.host_seconds() == {"ntt_cuda": 0.0, "modmul_cuda": 0.0}
    assert rns.counters()["host_s"]["poly_mul_towers"] == op  # the op's own counters reset apart
    rns.reset_counters()
    assert rns.counters() == {"host_s": {"poly_mul_towers": 0.0}, "copy_bytes": {"split": 0, "join": 0}}


def test_launch_counts_keep_their_three_kernels(operands):
    basis, a, b = operands
    he.poly_mul_towers(basis, a, b)
    assert set(kernels.launch_counts()) == {"ntt_tile", "ntt_pair", "modmul"}
