"""Nested dicts / lists / tuples of tensors: flatten, rebuild, map.

The port's stand-in for ``jax.tree_util`` over params, gradients and
optimizer state.  Leaves come out in the reference's order: dict keys
sorted, sequences in order.
"""
from __future__ import annotations

from typing import Any, Callable


def leaves(tree) -> list:
    """The leaves of `tree`, depth first, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def structure(tree) -> Any:
    """`tree` with every leaf replaced by None (compares by ==)."""
    if isinstance(tree, dict):
        return {k: structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(structure(v) for v in tree)
    return None


def unflatten(struct, flat: list):
    """Inverse of `leaves`: fill `struct` (from `structure`) with `flat`."""
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}      # keep the original order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(struct)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out


def map_tree(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    struct = structure(tree)
    flats = [leaves(tree)] + [leaves(t) for t in rest]
    if any(len(f) != len(flats[0]) for f in flats):
        raise ValueError("trees of different structure")
    return unflatten(struct, [fn(*xs) for xs in zip(*flats)])
