"""Nested dicts, lists and tuples of tensors (the port's pytrees).

The order and the key strings are JAX's: dicts flatten in sorted key
order, lists and tuples by index, and a leaf's path prints as
`jax.tree_util.keystr` prints it (`[0]['blocks'][0]['mixer']['wq']`), so
that checkpoints of the two packages name their leaves alike.
"""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """`fn` over the leaves of `tree` (and the same leaves of `rest`), in the
    same nesting; lists and tuples both come back as lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def leaves_with_path(tree, path=()) -> list[tuple[tuple, object]]:
    """(path, leaf) pairs in JAX's flattening order; a path is the tuple of
    dict keys and sequence indices from the root."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in leaves_with_path(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree) for pl in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten(tree, values):
    """`tree`'s nesting (tuples kept) with its leaves replaced, in
    `leaves` order, by `values`."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(tree)


def keystr(path) -> str:
    """`jax.tree_util.keystr` of a path: `[k!r]` per step."""
    return "".join(f"[{k!r}]" for k in path)
