"""The port's tree helpers free their leaves by reference counting alone.

A walk that recursed through a nested function naming itself kept a
reference cycle between the function and its closure, and the cycle held
the output list with every leaf in it until the cyclic collector ran. With
the collector off, a weakref to a leaf must die as soon as the caller drops
its references. The leaf order and the treedefs stay those of the original
helpers: the bus layout and the checkpoints' key paths depend on them.
"""
import builtins
import gc
import weakref
from typing import NamedTuple

import pytest
import torch

from repro_torch import _tree


class _Pair(NamedTuple):
    a: object
    b: object


def _tree_with(leaf):
    return {"z": [leaf, None, (torch.zeros(2), _Pair(torch.ones(1), 3.0))],
            "a": {"y": torch.arange(3.0), "x": None}, "m": (torch.ones(4),)}


CALLS = {
    "flatten": lambda t: _tree.flatten(t),
    "leaves": lambda t: _tree.leaves(t),
    "map": lambda t: _tree.map(lambda x: x, t),
    "flatten_up_to": lambda t: _tree.flatten_up_to(_tree.flatten(t)[1], t),
    "flatten_with_path": lambda t: _tree.flatten_with_path(t),
    "unflatten": lambda t: _tree.unflatten(*reversed(_tree.flatten(t))),
}


@pytest.fixture
def collector_off():
    gc.collect()
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@pytest.mark.parametrize("name", list(CALLS))
def test_leaf_dies_without_the_cyclic_collector(collector_off, name):
    leaf = torch.ones(5)
    ref = weakref.ref(leaf)
    tree = _tree_with(leaf)
    out = CALLS[name](tree)
    del out, tree, leaf
    assert ref() is None, f"{name} kept a leaf alive in a reference cycle"


def _old_flatten(tree):
    """The original nested-closure walk, kept here as the oracle."""
    out = []

    def walk(t):
        node = _tree._node(t)
        if node is None:
            out.append(t)
            return "leaf"
        kind, aux, children = node
        return kind, aux, tuple(walk(c) for c in children)

    return out, walk(tree)


def _old_flatten_with_path(tree):
    out = []

    def walk(t, path):
        node = _tree._node(t)
        if node is None:
            out.append((path, t))
            return
        kind, aux, children = node
        names = aux if kind == "dict" else builtins.range(len(children))
        for name, c in zip(names, children):
            walk(c, path + (name,))

    walk(tree, ())
    return out


def test_leaf_order_and_treedef_unchanged():
    tree = _tree_with(torch.full((2,), 7.0))
    leaves, treedef = _tree.flatten(tree)
    old_leaves, old_treedef = _old_flatten(tree)
    assert treedef == old_treedef
    assert [id(x) for x in leaves] == [id(x) for x in old_leaves]
    got = _tree.flatten_with_path(tree)
    want = _old_flatten_with_path(tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    assert [id(x) for _, x in got] == [id(x) for _, x in want]
    prefix = {"z": [0, None, 0], "a": 0, "m": 0}
    prefix_def = _old_flatten(prefix)[1]
    assert [id(x) for x in _tree.flatten_up_to(prefix_def, tree)] == \
        [id(tree["a"]), id(tree["m"]), id(tree["z"][0]), id(tree["z"][2])]
    back = _tree.unflatten(treedef, leaves)
    assert isinstance(back["z"][2][1], _Pair) and back["z"][1] is None
    assert _tree.flatten(back)[1] == treedef
