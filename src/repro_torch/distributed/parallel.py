"""Explicit collectives for the sharded train step, with their gradients.

`make_sharded_train_step` runs the model on each rank's local shards
inside `sharded(mesh, placements)`, which also enters `sharding.use_mesh`.
There the model code reads the plan (`current()`) and computes its own
slice, shard_map style, calling the collectives below where the reference's
`maybe_constrain` sites put XLA's:

  * FSDP: each rep's block leaves are all-gathered over the dp axes as the
    rep starts (`gather`), inside the remat `checkpoint`, so the recompute
    gathers again; the backward reduce-scatters the grad into the shard;
  * TP: column-parallel projections (`column_parallel`) and row-parallel
    ones (`row_parallel`), each output element and each element of the
    input's grad computed whole on one rank, so that they round as one
    device's matmuls do (weights exchanged between row and column blocks
    by an all-to-all where a product needs the other split); a whole-head
    view of a split projection by `gather_model_sum`; the SSD's heads split
    out of replicated activations (`split_to_model`), and attention's
    units (a batch row's kv group) the same way where the split cuts a
    head or a kv group;
  * EP: the MoE buffer's capacity slots reduce-scattered over dp
    (`reduce_scatter_dp`), the experts' outputs gathered back
    (`gather_dp`), each token's contributions summed over `model`;
  * global-batch statistics (`all_reduce_dp`, `gather_dp_ints`).

Gradient conventions.  Over the dp axes each rank's loss is its own term
and the objective is their sum (the step divides by the dp size after):
an all-gather's backward is a reduce-scatter, an all-reduce's an
all-reduce.  Over `model` every rank holds the one loss, replicated
(Megatron's convention): a tensor that is replicated over `model` and
enters rank-specific compute goes through `copy_to_model` (identity, its
backward an all-reduce), a rank-specific partial that becomes replicated
through `reduce_from_model` (an all-reduce, its backward the identity), and
`gather_model` (the backward takes this rank's chunk) precedes replicated
compute only.  `split_to_model` is its mirror: this rank's chunk of a
replicated tensor for rank-specific compute, the backward an all-gather
of the ranks' grads of their chunks (each computed whole on its rank), so
the grad comes back whole and replicated, as one device computes it
(where the ranks' runs do not divide the dim, each is padded to one
length for the all-gather); and
`row_parallel(..., whole=True)` takes the replicated rows whole and gives
their grad back whole (an all-gather) in the same way.  Between a
`gather_model` and a `split_to_model` the compute is replicated, and
nothing is summed over `model` in the backward.  A weight that the heads
share (the q / k norms, `layers.head_norm`) is not copied to `model`: its
backward gathers the ranks' per-head partial grads and each rank sums
them all in one device's order.

The serving steps enter the same plan (with the caches' placements) and
run no backward; decode's partial softmax reduces its max and sum of exps
over `model` (`all_reduce_model`).

Every collective is a functional collective (`_c10d_functional` ops), so
the dry-run's `CollectiveTally` and `CommDebugMode` count them.  Axes of
size 1 are skipped: on a 1 x 1 mesh nothing here runs a collective.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import functools
import math

import torch
import torch.distributed._functional_collectives as funcol
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.distributed import sharding as shd

# torch 2.13 renames the tensor collectives (same ops underneath)
_all_gather = getattr(funcol, "all_gather_single", None) or funcol.all_gather_tensor
_reduce_scatter = getattr(funcol, "reduce_scatter_single", None) or funcol.reduce_scatter_tensor


def _ag(x, dim, group):
    return funcol.wait_tensor(_all_gather(x.contiguous(), dim % x.dim(), group))


def _rs(x, dim, group):
    return funcol.wait_tensor(_reduce_scatter(x.contiguous(), "sum", dim % x.dim(), group))


def _ar(x, group, op="sum"):
    return funcol.wait_tensor(funcol.all_reduce(x.contiguous(), op, group))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Plan:
    """The mesh in use and the placements of the params the step passes as
    local shards: `placements` is the params' tree with each leaf's
    placements (one per mesh dim) in its place.  The serving steps add the
    caches' placements (`caches`, the cache list's tree), and say whether
    the batch is split over the dp axes (`batch_split`; where the global
    batch does not divide over them it is replicated, and the activations
    with it).  Its mesh-derived properties are computed once, at first use:
    the layers read them at every block."""

    mesh: object
    placements: object
    caches: object = None
    batch_split: bool = True

    def _dims(self, names) -> tuple:
        return tuple(i for i, a in enumerate(self.mesh.mesh_dim_names)
                     if a in names and self.mesh.size(i) > 1)

    @functools.cached_property
    def dp_dims(self) -> tuple:
        """The dp axes' mesh dims of size > 1, major to minor: the params'
        FSDP axes."""
        return self._dims(shd.dp_axes(self.mesh))

    @functools.cached_property
    def batch_dims(self) -> tuple:
        """The mesh dims that split the batch: `dp_dims`, or none where the
        batch is replicated."""
        return self.dp_dims if self.batch_split else ()

    @functools.cached_property
    def model_dim(self):
        dims = self._dims(("model",))
        return dims[0] if dims else None

    @functools.cached_property
    def dp_size(self) -> int:
        """The count of batch shards (`batch_dims`)."""
        return math.prod(self.mesh.size(i) for i in self.batch_dims)

    @functools.cached_property
    def dp_rank(self) -> int:
        """This rank's index over `batch_dims`, major to minor: its batch
        shard's place in the global batch."""
        rank, coord = 0, self.mesh.get_coordinate()
        for i in self.batch_dims:
            rank = rank * self.mesh.size(i) + coord[i]
        return rank

    @functools.cached_property
    def model_size(self) -> int:
        return 1 if self.model_dim is None else self.mesh.size(self.model_dim)

    @functools.cached_property
    def model_rank(self) -> int:
        return 0 if self.model_dim is None else self.mesh.get_coordinate()[self.model_dim]

    def group(self, dim):
        return self.mesh.get_group(dim)


_PLAN: contextvars.ContextVar = contextvars.ContextVar("repro_torch_plan", default=None)


@contextlib.contextmanager
def use_plan(plan: Plan | None):
    """`plan` in use within the block.  Code that autograd may rerun on its
    own thread (a remat recompute runs in the backward, where the caller's
    context is not seen) enters the plan it was given."""
    token = _PLAN.set(plan)
    try:
        yield plan
    finally:
        _PLAN.reset(token)


@contextlib.contextmanager
def sharded(mesh, placements, caches=None, batch_split: bool = True):
    """Within the block the model computes on local shards placed by
    `placements` (see `Plan`), under `sharding.use_mesh(mesh)`."""
    with use_plan(Plan(mesh, placements, caches, batch_split)), shd.use_mesh(mesh):
        yield


def current() -> Plan | None:
    """The plan in use, or None (single-device code)."""
    return _PLAN.get()


def model_split(local: int, full: int) -> bool:
    """Whether a dim that is `full` long is split over `model` here, by its
    local length (the dp axes are gathered by then)."""
    plan = current()
    if plan is None or local == full:
        return False
    if local * plan.model_size != full:
        raise ValueError(f"a dim of {full} is {local} here, not split over model ({plan.model_size})")
    return True


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------


class _GatherSum(torch.autograd.Function):
    """All-gather along `dim`; backward: reduce-scatter (sum) of the grads."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _ag(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _rs(g, ctx.dim, ctx.group), None, None


def _run(total: int, per: int, index: int) -> tuple:
    """(start, length) of rank `index`'s run of `per` of `total` along a
    dim: shorter on the last ranks where `per` does not divide `total`,
    empty past them."""
    lo = min(index * per, total)
    return lo, min(per, total - lo)


def _pad(x, dim, n):
    """`x` padded with zeros along `dim` to `n`."""
    short = n - x.shape[dim]
    if not short:
        return x
    return torch.cat([x, x.new_zeros((*x.shape[:dim], short, *x.shape[dim + 1:]))], dim)


class _GatherSlice(torch.autograd.Function):
    """The ranks' runs along `dim` (`_run`), each padded to `per`,
    all-gathered, the padding dropped (`total` long); backward: this rank's
    run of the grad (the compute after it is replicated, so its grad is
    whole on every rank)."""

    @staticmethod
    def forward(ctx, x, dim, group, per, index, total):
        ctx.dim, ctx.run = dim, _run(total, per, index)
        return _ag(_pad(x, dim, per), dim, group).narrow(dim, 0, total)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, *ctx.run).contiguous(), None, None, None, None, None


class _SplitGather(torch.autograd.Function):
    """This rank's run of `per` along `dim` (`_run`); backward: the ranks'
    grads of their runs (each whole on its rank), each padded to `per`,
    all-gathered, the padding dropped."""

    @staticmethod
    def forward(ctx, x, dim, group, per, index):
        ctx.dim, ctx.group, ctx.per, ctx.total = dim, group, per, x.shape[dim]
        return x.narrow(dim, *_run(x.shape[dim], per, index)).contiguous()

    @staticmethod
    def backward(ctx, g):
        g = _ag(_pad(g, ctx.dim, ctx.per), ctx.dim, ctx.group).narrow(ctx.dim, 0, ctx.total)
        return g, None, None, None, None


class _ScatterSum(torch.autograd.Function):
    """Reduce-scatter (sum) along `dim`; backward: all-gather."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _rs(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _ag(g, ctx.dim, ctx.group), None, None


class _SumBoth(torch.autograd.Function):
    """All-reduce (sum); backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ar(x, group)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group), None


class _SumForward(torch.autograd.Function):
    """All-reduce (sum); backward: identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _ar(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Identity; backward: all-reduce (sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _ar(g, ctx.group), None


class _AllToAll(torch.autograd.Function):
    """All-to-all of equal chunks of dim 0; backward: the same exchange back."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return funcol.wait_tensor(funcol.all_to_all_single(x.contiguous(), None, None, group))

    @staticmethod
    def backward(ctx, g):
        return funcol.wait_tensor(funcol.all_to_all_single(g.contiguous(), None, None, ctx.group)), None


def _exchange(w: torch.Tensor, parts: int, group, rows: bool) -> torch.Tensor:
    """A weight split over `model` in one dim, exchanged (all-to-all) to a
    split in the other: (K, N / m) -> (K / m, N) with `rows`, else
    (K / m, N) -> (K, N / m)."""
    k, n = w.shape
    blocks = w.reshape(parts, k // parts, n) if rows else w.reshape(k, parts, n // parts).transpose(0, 1)
    got = _AllToAll.apply(blocks, group)  # block i: rank i's part of this rank's block
    return got.transpose(0, 1).reshape(k // parts, n * parts) if rows else got.reshape(k * parts, n // parts)


def _place(block: torch.Tensor, dim: int, size: int, start: int) -> torch.Tensor:
    """2-D `block` at `start` along `dim` in a zero operand `size` long
    there, laid out as `block` is: row-major, or (where its rows are the
    faster dim, as a transposed view's) the transpose of a row-major one."""
    shape = list(block.shape)
    shape[dim] = size
    if block.stride(0) < block.stride(1):
        out = block.new_zeros(shape[::-1]).t()
    else:
        out = block.new_zeros(shape)
    out.narrow(dim, start, block.shape[dim]).copy_(block)
    return out


def _widths(n: int, total: int) -> list:
    """The widths a block of `n` may be computed at, narrowest first: `n`,
    `n` rounded up to 128 and to 256 where below `total`, and `total`."""
    return sorted({w for w in (n, -(-n // 128) * 128, -(-n // 256) * 256) if w < total} | {total})


def _block_at(a: torch.Tensor, b: torch.Tensor, total: int, index: int, rows: bool, width: int) -> torch.Tensor:
    """The block of `a @ b` (see `block_of_product`) computed with the
    block's operand widened to `width`: at its own place where that is
    `total` (the whole product), else first."""
    dim = 0 if rows else -1
    n = (a if rows else b).shape[dim]
    start = index * n if width == total else 0
    if width != n:
        if rows:
            a = _place(a, 0, width, start)
        else:
            b = _place(b, -1, width, start)
    return (a @ b).narrow(dim, start, n)


#: {(device, the operands' dtype, shapes and strides, total, index, rows,
#: cuBLAS's bf16 reduction flag): the narrowest width at which cuBLAS (or
#: the CPU's BLAS) gives a block the whole product's bits}, found once per
#: process by `_exact_width`.
_EXACT_WIDTH: dict = {}


def _exact_width(a: torch.Tensor, b: torch.Tensor, total: int, index: int, rows: bool) -> int:
    """The narrowest of `_widths` at which the block equals the whole
    product's, probed once per key (`_probe_width`)."""
    key = (str(a.device), a.dtype, tuple(a.shape), a.stride(), tuple(b.shape), b.stride(), total, index, rows,
           torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction)
    width = _EXACT_WIDTH.get(key)
    if width is None:
        with torch.no_grad(), _disable_current_modes():  # a one-time probe, not the step's work: no counter sees it
            width = _probe_width(a, b, total, index, rows)
        _EXACT_WIDTH[key] = width
    return width


def _probe_width(a: torch.Tensor, b: torch.Tensor, total: int, index: int, rows: bool) -> int:
    """The narrowest width whose block equals the whole product's on two
    draws of operands of the same shapes and layouts: normal values, and
    values that cancel (the second half of the contracted dim the first
    half's products negated, at exponents from 2^-12 to 2^12), so that each
    output is the rounding residue of its f32 sum and any other order of
    summing shows in the bf16 result, as it need not on normal values."""
    gen = torch.Generator(device=a.device).manual_seed(0)
    k = a.shape[-1]
    draws = []
    for cancel in (False, True):
        pa, pb = (torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device=t.device).normal_(generator=gen)
                  for t in (a, b))
        if cancel and k > 1:
            scale = torch.exp2(torch.randint(-12, 13, pa.shape, generator=gen, device=a.device).to(pa.dtype))
            pa.mul_(scale)
            half = k // 2
            pa[..., half:2 * half] = pa[..., :half]
            pb[half:2 * half] = -pb[:half]
        draws.append((pa, pb))
    n = (a if rows else b).shape[0 if rows else -1]
    wholes = [_block_at(pa, pb, total, index, rows, total) for pa, pb in draws]
    return next(w for w in _widths(n, total)
                if all(torch.equal(_block_at(pa, pb, total, index, rows, w), whole)
                       for (pa, pb), whole in zip(draws, wholes)))


def block_of_product(a: torch.Tensor, b: torch.Tensor, total: int, index: int, rows: bool = False) -> torch.Tensor:
    """This rank's block of one device's `a @ b`, bit for bit: `b` (2-D)
    holds run `index` of the whole right operand's `total` columns, and the
    block is those columns of the product; with `rows`, `a` (2-D) holds run
    `index` of the whole left operand's `total` rows, and the block is those
    rows.  cuBLAS picks its kernel, and with it the order in which an
    element's products are summed, by the shapes (jamba's 145 of 580
    in-projection columns sum otherwise than the 580), so the block is
    computed at the narrowest width at which it holds the whole product's
    bits (`_exact_width`): its own where the kernels agree, else its operand
    widened with zeros (to the whole size at its place, the whole product's
    work, where nothing narrower agrees).  A meta tensor (the dry-run's
    shapes) takes its own width.  Contiguous."""
    width = (a if rows else b).shape[0 if rows else -1]
    if a.device.type != "meta":
        width = _exact_width(a, b, total, index, rows)
    return _block_at(a, b, total, index, rows, width).contiguous()


class _ColumnParallel(torch.autograd.Function):
    """`x @ w` for each of `ws` (this rank's column blocks, run `index`) on
    a replicated `x`: each block as one device's whole product holds it
    (`block_of_product`).  The backward computes each element of each
    projection's grad of `x` whole on one rank, as one device's matmul does
    (the output grads all-gathered, the weights exchanged to row blocks,
    this rank's columns of the grad, all-gathered), and adds the
    projections' grads in the order autograd adds them on one device (the
    last use first)."""

    @staticmethod
    def forward(ctx, x, group, parts, index, *ws):
        ctx.save_for_backward(x, *ws)
        ctx.group, ctx.parts, ctx.index = group, parts, index
        return tuple(block_of_product(x, w, w.shape[-1] * parts, index) for w in ws)

    @staticmethod
    def backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        k, index = x.shape[-1], ctx.index
        part = [block_of_product(_ag(g, -1, ctx.group), _exchange(w, ctx.parts, ctx.group, rows=True).T, k, index)
                for g, w in zip(gs, ws)]
        gx = part[-1]
        for p in reversed(part[:-1]):
            gx = gx + p
        x2 = x.reshape(-1, k)
        return (_ag(gx, -1, ctx.group), None, None, None,
                *(block_of_product(x2.T, g.reshape(-1, g.shape[-1]), g.shape[-1] * ctx.parts, index) for g in gs))


class _RowParallel(torch.autograd.Function):
    """`h @ w` for `h`'s columns and `w`'s rows split over `model` (this
    rank's are run `index`), each output element computed whole on one
    rank, as one device computes it: `h` all-gathered, `w` exchanged
    (all-to-all) from row blocks to column blocks, this rank's output
    columns (`block_of_product`), all-gathered.  (Partial products summed
    over `model` would round some elements of the output otherwise than
    one device's matmul does.)  The backward is one device's bf16 matmul
    backward, this rank's blocks of it (the output's grad is replicated).
    With `whole`, `h` is whole (replicated): no gather in the forward, and
    the grad of `h` comes back whole (its chunks all-gathered)."""

    @staticmethod
    def forward(ctx, h, w, group, parts, index, whole):
        full = h if whole else _ag(h, -1, group)
        k = full.shape[-1]
        if whole:
            h = h.narrow(-1, index * (k // parts), k // parts)
        ctx.save_for_backward(h, w)
        ctx.group, ctx.whole, ctx.index, ctx.k = group, whole, index, k
        return _ag(block_of_product(full, _exchange(w, parts, group, rows=False), w.shape[-1], index), -1, group)

    @staticmethod
    def backward(ctx, g):
        h, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gh = block_of_product(g2, w.T, ctx.k, ctx.index).reshape(h.shape)
        gw = block_of_product(h.reshape(-1, h.shape[-1]).T, g2, ctx.k, ctx.index, rows=True)
        return (_ag(gh, -1, ctx.group) if ctx.whole else gh), gw, None, None, None, None


# ---------------------------------------------------------------------------
# params: the per-rep FSDP gather
# ---------------------------------------------------------------------------


def gather(t: torch.Tensor, place, offset: int = 0) -> torch.Tensor:
    """The local shard `t` of a param placed by `place`, gathered over the dp
    axes (minor first); a split over `model` stays (the layers compute on
    it).  `offset` is the count of leading dims the caller sliced off (a
    rep slice of a stacked leaf: 1).  The grad comes back reduce-scattered
    over dp (each rank's own batch term, summed)."""
    plan = current()
    for i in reversed(plan.dp_dims):
        if place[i].is_shard():
            t = _GatherSum.apply(t, place[i].dim - offset, plan.group(i))
    return t


def gather_tree(tree: dict, places: dict | None, offset: int = 1) -> dict:
    """`gather` over a block's params (a rep's slices: `offset` 1).  `places`
    None (no plan), or no dp axis of size > 1, gives `tree` back."""
    if places is None or not current().dp_dims:
        return tree

    def walk(node, place):
        if isinstance(node, dict):
            return {k: walk(v, place[k]) for k, v in node.items()}
        return gather(node, place, offset)

    return {k: walk(v, places[k]) for k, v in tree.items()}


# ---------------------------------------------------------------------------
# activations: the model axis
# ---------------------------------------------------------------------------


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """`x`, replicated over `model`, entering rank-specific compute: the
    grads of the ranks' parts are summed in the backward."""
    plan = current()
    return x if plan.model_dim is None else _SumBackward.apply(x, plan.group(plan.model_dim))


def column_parallel(x: torch.Tensor, *ws: torch.Tensor) -> tuple:
    """`x @ w` for each of `ws`, whose columns are split over `model`, on
    `x` replicated there."""
    plan = current()
    if plan.model_dim is None:
        return tuple(x @ w for w in ws)
    return _ColumnParallel.apply(x, plan.group(plan.model_dim), plan.model_size, plan.model_rank, *ws)


def row_parallel(h: torch.Tensor, w: torch.Tensor, whole: bool = False) -> torch.Tensor:
    """`h @ w` (bf16, replicated over `model`), `w`'s rows split over it;
    `h` this rank's columns, or with `whole` all of them, replicated."""
    plan = current()
    return _RowParallel.apply(h, w, plan.group(plan.model_dim), plan.model_size, plan.model_rank, whole)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over `model` of the ranks' partial `x`, replicated."""
    plan = current()
    return x if plan.model_dim is None else _SumForward.apply(x, plan.group(plan.model_dim))


def gather_model(x: torch.Tensor, dim: int, total: int | None = None) -> torch.Tensor:
    """`x`, this rank's run along `dim`, and the other ranks' gathered over
    `model`, for replicated compute: `total` long (`x`'s length times
    `model` by default; `split_to_model`'s runs where they do not divide
    it).  The backward takes this rank's run of the whole grad."""
    plan = current()
    if plan.model_dim is None:
        return x
    dim %= x.dim()
    total = x.shape[dim] * plan.model_size if total is None else total
    return _GatherSlice.apply(x, dim, plan.group(plan.model_dim), -(-total // plan.model_size), plan.model_rank,
                              total)


def gather_model_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x`'s chunks along `dim` gathered over `model`, for rank-specific
    compute: the backward sums the ranks' grads."""
    plan = current()
    return x if plan.model_dim is None else _GatherSum.apply(x, dim % x.dim(), plan.group(plan.model_dim))


def split_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's run along `dim` of `x`, replicated over `model`, for
    rank-specific compute: the n entries dealt out in runs of
    ceil(n / model) in rank order, the last ranks' shorter or empty where
    that does not divide n.  The backward all-gathers the ranks' grads of
    their runs (padded to one length), so the grad comes back whole."""
    plan = current()
    if plan.model_dim is None:
        return x
    dim %= x.dim()
    return _SplitGather.apply(x, dim, plan.group(plan.model_dim), -(-x.shape[dim] // plan.model_size),
                              plan.model_rank)


def model_run(total: int) -> tuple[int, int]:
    """(start, length) of this rank's run of `total` entries as
    `split_to_model` deals them; all of them without a model axis."""
    plan = current()
    if plan is None or plan.model_dim is None:
        return 0, total
    return _run(total, -(-total // plan.model_size), plan.model_rank)


def all_reduce_model(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """`x` reduced (`op`: "sum" or "max") over `model`, replicated; no grad
    (serving's partial-softmax statistics)."""
    plan = current()
    return x if plan.model_dim is None else _ar(x, plan.group(plan.model_dim), op)


def vocab_to_model(table: torch.Tensor) -> torch.Tensor:
    """(V, d / model) -> (V / model, d): a table whose columns are split over
    `model` exchanged so that its rows are (one all-to-all)."""
    plan = current()
    return _exchange(table, plan.model_size, plan.group(plan.model_dim), rows=True)


class _Logsumexp(torch.autograd.Function):
    """`logsumexp` over the last dim (`torch.logsumexp`'s formula: the max,
    then the log of the sum of exps; its backward `exp(x - result)`), the
    sum taken in f64 so that its f32 result does not depend on how the row
    is split; with `group`, the row is split over it."""

    @staticmethod
    def forward(ctx, x, group):
        m = torch.amax(x, dim=-1)
        if group is not None:
            m = _ar(m, group, "max")
        m = m.masked_fill(m.abs() == float("inf"), 0)
        total = torch.sum(torch.exp(x - m[..., None]), dim=-1, dtype=torch.float64)
        if group is not None:
            total = _ar(total, group)
        out = torch.log(total).to(x.dtype) + m
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * torch.exp(x - out[..., None]), None


def logsumexp(x: torch.Tensor, split: bool = False) -> torch.Tensor:
    """`logsumexp(x, -1)` of whole rows; with `split`, `x` is this rank's
    split of them over `model`."""
    if not split:
        return _Logsumexp.apply(x, None)
    plan = current()
    return _Logsumexp.apply(x, plan.group(plan.model_dim))


# ---------------------------------------------------------------------------
# activations: the dp axes
# ---------------------------------------------------------------------------


def all_reduce_dp(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the dp ranks (each rank's grad term summed back)."""
    plan = current()
    for i in plan.batch_dims:
        x = _SumBoth.apply(x, plan.group(i))
    return x


def gather_dp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`x`'s chunks along `dim` gathered over the dp ranks, in dp rank order."""
    plan = current()
    for i in reversed(plan.batch_dims):
        x = _GatherSum.apply(x, dim % x.dim(), plan.group(i))
    return x


def reduce_scatter_dp(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of `x` over the dp ranks, this rank keeping its chunk along
    `dim` (chunk `dp_rank` of `dp_size`)."""
    plan = current()
    for i in plan.batch_dims:
        x = _ScatterSum.apply(x, dim % x.dim(), plan.group(i))
    return x


def gather_dp_ints(x: torch.Tensor) -> torch.Tensor:
    """Integer `x` (no grad) gathered over the dp ranks along dim 0."""
    plan = current()
    for i in reversed(plan.batch_dims):
        x = _ag(x, 0, plan.group(i))
    return x
