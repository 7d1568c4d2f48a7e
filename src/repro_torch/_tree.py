"""Parameter-tree walking in the reference's leaf order.

``jax.tree.flatten`` visits dict keys in sorted order, while
``torch.utils._pytree`` keeps insertion order. The flat gossip bus assigns
buffer offsets by leaf order, so everything in this package that walks a
tree goes through these helpers: dicts by sorted key, lists and tuples
(NamedTuples included) in order, ``None`` as an empty node, anything else a
leaf.
"""
from __future__ import annotations

import builtins
from typing import Any, Callable

__all__ = ["flatten", "unflatten", "map", "leaves", "flatten_with_path"]


def _node(tree: Any):
    """(kind, aux, children) of a container node, or None for a leaf."""
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return "dict", keys, [tree[k] for k in keys]
    if isinstance(tree, list):
        return "list", len(tree), list(tree)
    if isinstance(tree, tuple):
        return "tuple", type(tree), list(tree)
    if tree is None:
        return "none", None, []
    return None


def flatten(tree: Any) -> tuple[list, Any]:
    """(leaves, treedef); the treedef is hashable and feeds :func:`unflatten`."""
    out: list = []

    def walk(t):
        node = _node(t)
        if node is None:
            out.append(t)
            return "leaf"
        kind, aux, children = node
        return kind, aux, tuple(walk(c) for c in children)

    treedef = walk(tree)
    return out, treedef


def unflatten(treedef: Any, leaves: list) -> Any:
    it = iter(leaves)

    def build(d):
        if d == "leaf":
            return next(it)
        kind, aux, children = d
        vals = [build(c) for c in children]
        if kind == "dict":
            return dict(zip(aux, vals))
        if kind == "list":
            return vals
        if kind == "none":
            return None
        if hasattr(aux, "_fields"):          # NamedTuple
            return aux(*vals)
        return aux(vals)

    out = build(treedef)
    if next(it, _END) is not _END:
        raise ValueError("more leaves than the treedef holds")
    return out


_END = object()


def leaves(tree: Any) -> list:
    return flatten(tree)[0]


def map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (same shape)."""
    flat, treedef = flatten(tree)
    others = []
    for r in rest:
        rf, rd = flatten(r)
        if rd != treedef:
            raise ValueError("tree structures differ")
        others.append(rf)
    return unflatten(treedef, [fn(*xs) for xs in zip(flat, *others)])


def flatten_with_path(tree: Any) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in leaf order; a path holds dict keys and list indices."""
    out: list = []

    def walk(t, path):
        node = _node(t)
        if node is None:
            out.append((path, t))
            return
        kind, aux, children = node
        names = aux if kind == "dict" else builtins.range(len(children))
        for name, c in zip(names, children):
            walk(c, path + (name,))

    walk(tree, ())
    return out
