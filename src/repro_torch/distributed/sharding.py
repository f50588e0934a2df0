"""Sharding rules: the port of the JAX package's `repro/distributed/sharding.py`
(parameter / optimizer / cache / batch partition specs), plus their
translation into `torch.distributed.tensor` placements.

Parallelism map, as in the reference:
  data axes ("pod", "data")  : DP for activations + FSDP (ZeRO-3) for
                               params/optimizer state
  model axis ("model")       : TP for attention heads & MLP hidden, EP
                               for MoE experts, sequence-sharding for
                               long-context KV caches

Rules are name+shape based and *divisibility-checked*: an axis that does
not divide the dimension is dropped (replicated) rather than producing
an invalid sharding.  They match on substrings of the leaf's path string
(`tree.keystr`, JAX's), so they give the reference's specs leaf for leaf.

A mesh here is anything with axis names and sizes: a
`launch.mesh.AbstractMesh` (no devices, for the rule tables and the
dry-run's bookkeeping), a stub with `axis_names` and a `shape` dict, or a
torch `DeviceMesh` (`mesh_dim_names`, `shape` a tuple).  `placements`
needs a `DeviceMesh`-like mesh: a spec becomes `Shard(d)` on each mesh dim
that names tensor dim `d` and `Replicate()` elsewhere.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
import re

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.tree import keystr, leaves_with_path, unflatten

_NAME_RE = re.compile(r"\['([^']+)'\]")


class P(tuple):
    """A partition spec (jax's `PartitionSpec`): one entry per tensor dim,
    None (replicated), a mesh axis name, or a tuple of names (the dim split
    over several axes, major to minor).  A 1-tuple is kept as its name, as
    jax keeps it, so `tuple(spec)` equals the reference's."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in entries))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (jax's `NamedSharding`)."""

    mesh: object
    spec: P

    def placements(self) -> list:
        return placements(self.mesh, self.spec)


def axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    if getattr(mesh, "mesh_dim_names", None) is not None:  # DeviceMesh: shape is a tuple
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    return dict(mesh.shape)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _leaf_name(path: str) -> str:
    names = _NAME_RE.findall(path)
    return names[-1] if names else path


def dp_axes(mesh):
    """The combined data-parallel (FSDP) axes present in the mesh."""
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fits(mesh, axes, dim: int) -> bool:
    sizes = axis_sizes(mesh)
    return dim % math.prod(sizes[a] for a in _axes(axes)) == 0


def _sanitize(mesh, spec: P, shape) -> P:
    return P(*(axes if _fits(mesh, axes, dim) else None for axes, dim in zip(spec, shape)))


# ---------------------------------------------------------------------------
# parameter rules (applied to path strings from tree.leaves_with_path)
# ---------------------------------------------------------------------------


def _param_spec(path: str, ndim: int, mesh) -> P:
    dp = dp_axes(mesh)
    dp = dp if dp else None

    def stacked(*spec):
        """Block params carry a leading (reps,) stack dim."""
        return P(None, *spec) if "blocks" in path else P(*spec)

    leaf = _leaf_name(path)
    if "embed" in path and ndim == 2:
        # vocab over FSDP (big dim), d over model: keeps the gather output's
        # batch dim free to follow the tokens' data sharding.
        return P(dp, "model")
    if "lm_head" in path:
        return P(dp, "model")  # d FSDP-gathered at use, vocab over TP
    if leaf in ("wq", "wk", "wv"):
        return stacked(dp, "model")
    if leaf == "wo" and "mixer" in path or leaf == "wo" and "cross" in path:
        return stacked("model", dp)
    if leaf == "router":
        return stacked(dp, None)
    if leaf in ("wi", "wg"):
        if ndim - ("blocks" in path) == 3:  # MoE (E, D, F): experts over model
            return stacked("model", dp, None)
        return stacked(dp, "model")
    if leaf == "wo":  # ffn down-projection
        if ndim - ("blocks" in path) == 3:  # MoE (E, F, D)
            return stacked("model", None, dp)
        return stacked("model", dp)
    if leaf == "in_proj":
        return stacked(dp, "model")
    if leaf == "out_proj":
        return stacked("model", dp)
    if leaf == "conv_w":
        return stacked(None, "model")
    if leaf in ("a_log", "skip_d", "dt_bias"):
        return stacked("model")
    # norms, biases, scalars: replicate (beyond the stack dim)
    return stacked(*([None] * (ndim - ("blocks" in path))))


def _map_with_path(fn, tree):
    """`fn(path string, leaf)` over `tree`'s leaves, in its nesting."""
    return unflatten(tree, [fn(keystr(p), leaf) for p, leaf in leaves_with_path(tree)])


def param_shardings(mesh, params_shape):
    """`NamedSharding` tree for a params tree (tensors, meta or not)."""

    def one(pstr, leaf):
        spec = _param_spec(pstr, leaf.ndim, mesh)
        spec = _sanitize(mesh, P(*spec, *([None] * (leaf.ndim - len(spec)))), leaf.shape)
        return NamedSharding(mesh, spec)

    return _map_with_path(one, params_shape)


def opt_shardings(mesh, opt_shape, params_shape=None):
    """Optimizer moments follow their parameter's sharding (same shapes).

    Adafactor's factored vectors drop the factored-out dim from the
    parameter spec: vr = spec[:-1], vc = spec[:-2] + spec[-1:]."""

    def one(pstr, leaf):
        leaf_name = _leaf_name(pstr)
        if leaf_name == "vr":
            spec = _param_spec(pstr, leaf.ndim + 1, mesh)
            spec = P(*(tuple(spec) + (None,) * (leaf.ndim + 1 - len(spec)))[:-1])
        elif leaf_name == "vc":
            full = _param_spec(pstr, leaf.ndim + 1, mesh)
            full = tuple(full) + (None,) * (leaf.ndim + 1 - len(full))
            spec = P(*(full[:-2] + full[-1:]))
        else:
            spec = _param_spec(pstr, leaf.ndim, mesh)
            spec = P(*(tuple(spec) + (None,) * (leaf.ndim - len(spec)))[: leaf.ndim])
        return NamedSharding(mesh, _sanitize(mesh, spec, leaf.shape))

    return _map_with_path(one, opt_shape)


# ---------------------------------------------------------------------------
# batch / activation / cache rules
# ---------------------------------------------------------------------------


def batch_shardings(mesh, batch_shape):
    dp = dp_axes(mesh) or None

    def one(pstr, leaf):
        spec = P(dp, *([None] * (leaf.ndim - 1)))
        return NamedSharding(mesh, _sanitize(mesh, spec, leaf.shape))

    return _map_with_path(one, batch_shape)


def cache_shardings(mesh, cache_shape):
    """KV caches: batch over DP; cache LENGTH over model (sequence
    sharding).  SSM states: heads over model."""
    dp = dp_axes(mesh) or None

    def one(pstr, leaf):
        if "conv" in pstr:  # (reps, B, W-1, xbc)
            spec = P(None, dp, None, "model")
        else:  # (reps, B, H, P, N) states, (reps, B, L, KV, hd) attn / cross caches
            spec = P(None, dp, "model", None, None)
        spec = P(*spec[: leaf.ndim])
        return NamedSharding(mesh, _sanitize(mesh, spec, leaf.shape))

    return _map_with_path(one, cache_shape)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def named(mesh, spec: P, shape) -> NamedSharding:
    """Divisibility-sanitized NamedSharding for an explicit spec."""
    spec = P(*spec[: len(shape)], *([None] * max(0, len(shape) - len(spec))))
    return NamedSharding(mesh, _sanitize(mesh, spec, shape))


def logits_spec(mesh) -> P:
    dp = dp_axes(mesh) or None
    return P(dp, None, "model")


# ---------------------------------------------------------------------------
# specs as DTensor placements, local shapes
# ---------------------------------------------------------------------------


def placements(mesh, spec: P) -> list:
    """The spec as one placement per mesh dim: `Shard(d)` on each mesh dim
    that `spec` names for tensor dim `d`, `Replicate()` elsewhere.  A dim
    over several axes (`("pod", "data")`) is split over them major to
    minor, which is DTensor's order only when the axes come in the mesh's
    order."""
    names = axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: dim {d}'s axes are not in the mesh's order {names}")
        for i in idx:
            if out[i].is_shard():
                raise ValueError(f"{spec}: mesh axis {names[i]!r} shards two dims")
            out[i] = Shard(d)
    return out


def local_shape(mesh, spec: P, shape) -> tuple:
    """The shape of one device's shard of a `shape` tensor under a
    sanitized `spec` (every named axis divides its dim)."""
    sizes = axis_sizes(mesh)
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // math.prod(sizes[a] for a in _axes(entry)) for entry, dim in zip(spec, shape))


def local_chunk(t: torch.Tensor, mesh, place) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` under `place` (one
    placement per mesh dim of the `DeviceMesh` `mesh`): slices, no
    communication; a view where the slices are contiguous."""
    coord = mesh.get_coordinate()
    for i, p in enumerate(place):
        if p.is_shard():
            t = torch.chunk(t, mesh.size(i), dim=p.dim)[coord[i]]
    return t.contiguous()


def distribute(t: torch.Tensor, mesh, place) -> DTensor:
    """The whole tensor `t`, which every rank holds alike, as a `DTensor`
    on `mesh` with placements `place`: each rank keeps its own chunk."""
    return DTensor.from_local(local_chunk(t, mesh, place), mesh, place, run_check=False)


def distribute_tree(tree, shardings):
    """Every leaf of `tree` distributed by the `NamedSharding` at its place
    in `shardings`."""
    flat = [distribute(t, s.mesh, s.placements())
            for t, s in zip((leaf for _, leaf in leaves_with_path(tree)),
                            (s for _, s in leaves_with_path(shardings)))]
    return unflatten(tree, flat)


# ---------------------------------------------------------------------------
# activation constraints (no-ops when no mesh is in use: single-device runs)
# ---------------------------------------------------------------------------

_ROLES = {
    # role -> the role's spec, given the dp axes
    "tokens_act": lambda dp: P(dp, None, None),
    "logits": lambda dp: P(dp, None, "model"),
    "moe_buffer": lambda dp: P("model", dp, None),
    "moe_hidden": lambda dp: P("model", dp, None),
    # local-dispatch MoE: (blocks, E, cap, d) — blocks over DP, experts over
    # model; building this from block-local tokens is ONE all-to-all.
    "moe_buffer_local": lambda dp: P(dp, "model", None, None),
    "moe_hidden_local": lambda dp: P(dp, "model", None, None),
    "moe_tokens_local": lambda dp: P(dp, None, None),
}

#: The mesh `maybe_constrain` places activations on, set by `use_mesh` (the
#: reference reads jax's ambient mesh, set by `with mesh:`).
_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Within the block, `maybe_constrain` places `DTensor`s on `mesh`."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def maybe_constrain(x, role: str):
    """`x` redistributed to its role's spec (divisibility-sanitized) if it is
    a `DTensor` and a mesh is in use (`use_mesh`); otherwise `x` itself, so
    model code stays mesh-agnostic."""
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    dp = dp_axes(mesh) or None
    spec = _ROLES[role](dp)
    spec = P(*spec[: x.ndim], *([None] * max(0, x.ndim - len(spec))))
    return x.redistribute(mesh, placements(mesh, _sanitize(mesh, spec, x.shape)))
