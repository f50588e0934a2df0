"""Split products and the clip's norm in the sharded train step, against
one device's on the CPU.

`distributed.parallel.block_of_product` gives a rank its block of one
device's product bit for bit, at the narrowest width at which the BLAS
sums that block as it sums the whole product (probed once per shape): the
five forms of the model axis, at jamba's in-projection split (145 of 580
columns) and mamba2's (137 of 548), on odd row counts.  The clip's norm
sums the squares over blocks that no shard boundary cuts
(`optim.optimizers.block_square_sums`), so a shard's block sums are the
whole leaf's.  The multi-rank steps are in test_torch_mixer_parallel.py
and test_torch_model_parallel.py; the card's case in test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from repro_torch.distributed import parallel as P
from repro_torch.optim import optimizers as PO

#: (rows, inner, whole width, ranks): jamba's and mamba2's in-projection
#: splits over 4 ranks at odd token counts, and a 2-way split.
SPLITS = [(37, 64, 580, 4), (21, 48, 548, 4), (9, 40, 96, 2)]


def draw(gen, *shape):
    return torch.randn(*shape, generator=gen).to(torch.bfloat16)


def forms(m, k, total, parts, index, gen):
    """The five split products of the model axis as (name, whole product's
    block, `block_of_product`'s), for rank `index` of `parts`: the column-
    parallel forward `x @ w`, its grad of x `g @ W.T` (W's rows exchanged
    to this rank) and its weight grad `x.T @ g`; the row-parallel backward's
    grad of h `g @ w.T` and its weight grad `h.T @ g` (the row-parallel
    forward is the first form on the exchanged weight)."""
    x, w = draw(gen, 3, m, k), draw(gen, k, total)
    g, h = draw(gen, 3 * m, total), draw(gen, 3 * m, k)
    n, kn = total // parts, k // parts
    cols, rows = slice(index * n, (index + 1) * n), slice(index * kn, (index + 1) * kn)
    x2 = x.reshape(-1, k)
    wt = draw(gen, k, total)  # a weight split by rows: W (K, N), this rank's K / parts rows
    return [
        ("x @ w", (x @ w)[..., cols], P.block_of_product(x, w[:, cols].contiguous(), total, index)),
        ("g @ W.T", (g @ wt.T)[:, rows], P.block_of_product(g, wt[rows].contiguous().T, k, index)),
        ("x.T @ g", (x2.T @ g)[:, cols], P.block_of_product(x2.T, g[:, cols].contiguous(), total, index)),
        ("g @ w.T", (g @ wt.T)[:, rows], P.block_of_product(g, wt[rows].contiguous().T, k, index)),
        ("h.T @ g", (h.T @ g)[rows], P.block_of_product(h[:, rows].contiguous().T, g, k, index, rows=True)),
    ]


@pytest.mark.parametrize("m,k,total,parts", SPLITS)
def test_block_of_product_is_the_whole_products_block(m, k, total, parts):
    gen = torch.Generator().manual_seed(total)
    for index in range(parts):
        for name, want, got in forms(m, k, total, parts, index, gen):
            assert got.is_contiguous() and torch.equal(got, want), (name, index)


def test_a_block_that_sums_otherwise_is_widened(monkeypatch):
    """Where the BLAS would sum a narrower block otherwise (planted: a
    block computed below 256 columns is off by an ulp), the block is taken
    at the narrowest width that holds the whole product's bits (the block
    padded to 256 columns here), and still equals it."""
    block_at = P._block_at

    def planted(a, b, total, index, rows, width):
        out = block_at(a, b, total, index, rows, width)
        return out * (1 + 2.0**-7) if width < 256 else out

    monkeypatch.setattr(P, "_block_at", planted)
    monkeypatch.setattr(P, "_EXACT_WIDTH", {})
    gen = torch.Generator().manual_seed(1)
    x, w = draw(gen, 5, 64), draw(gen, 64, 580)
    got = P.block_of_product(x, w[:, 145:290].contiguous(), 580, 1)
    assert torch.equal(got, (x @ w)[:, 145:290])
    assert list(P._EXACT_WIDTH.values()) == [256]
    assert P._widths(145, 580) == [145, 256, 580] and P._widths(137, 548) == [137, 256, 548]


def test_block_of_product_on_meta_takes_its_own_width():
    """The dry-run's meta tensors have no values to probe: the block is
    computed at its own width (the count of flops the narrow form costs)."""
    x, w = torch.empty(2, 7, 64, device="meta"), torch.empty(64, 145, device="meta")
    assert P.block_of_product(x, w, 580, 3).shape == (2, 7, 145)


@pytest.mark.parametrize("shape,split", [((36, 64, 96), {1: 4}), ((151, 96), {1: 4, 0: 1}), ((8, 96, 40), {0: 2, 2: 2}),
                                         ((64,), {0: 4})])
def test_a_shards_block_sums_are_the_whole_leafs(shape, split):
    """`block_square_sums` of a shard, at the leaf's runs divided by the
    split, equals the whole leaf's block sums at the shard's place, bit for
    bit, for every shard; and so the norm of the partials gathered back."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 3, shape)).astype(np.float32))
    runs = PO.norm_runs((), shape)
    whole = PO.block_square_sums(x, runs)
    grid = torch.zeros(runs)
    for coord in np.ndindex(*(split.get(d, 1) for d in range(len(shape)))):
        shard, own = x, []
        for d, i in enumerate(coord):
            n, r = shape[d] // split.get(d, 1), runs[d] // split.get(d, 1)
            shard = shard.narrow(d, i * n, n)
            own.append(slice(i * r, (i + 1) * r))
        local = PO.block_square_sums(shard, tuple(r // split.get(d, 1) for d, r in enumerate(runs)))
        assert torch.equal(local, whole[tuple(own)]), coord
        grid[tuple(own)] = local
    assert torch.equal(grid, whole)
    assert torch.equal(PO.norm_of_partials([grid]), PO.global_norm({"w": x}))


def test_norm_runs_and_slabs():
    """A block stack's leaves run a rep at a time; the others gcd(size, 32).
    A leaf over `SLICE_ELEMS` values, taken a run of dim 0 at a time, sums
    as it does whole."""
    assert PO.norm_runs(("blocks", "mixer", "wq"), (36, 64, 96)) == (36, 32, 32)
    assert PO.norm_runs(("embed",), (151, 96)) == (1, 32)
    x = torch.randn(64, 48, generator=torch.Generator().manual_seed(2))
    want = PO.block_square_sums(x, (32, 16))
    old = PO.SLICE_ELEMS
    try:
        PO.SLICE_ELEMS = 100
        assert torch.equal(PO.block_square_sums(x, (32, 16)), want)
    finally:
        PO.SLICE_ELEMS = old
    assert float(PO.pairwise_sum(torch.arange(5.0))) == 10.0


def test_chip_smoke_split_product_check_on_cpu():
    """`chip_smoke.py`'s split-product check rehearsed on the CPU at small
    splits: every block equal, the widths recorded."""
    cs = __import__("test_torch_serve")._load_chip_smoke()
    out = cs.check_split_products("cpu", splits=(("small", 12, 16, 40, 4),), expert_splits=(("e", 4, 8, 16, 24, 2),))
    assert out["cases"] == 16 and not out["unequal"]
    assert {w["width"] for w in out["widths"]} <= {10, 4, 128, 40, 16}
    assert out["expert_einsums"][0]["equal_by_rank"] == [True, True]
