"""Parameter definitions, initialization and logical-axis sharding rules.

The port of the reference's ``repro/models/params.py``. Every module
declares its parameters as a tree of :class:`ParamDef` with logical axis
names; :func:`init_tree` draws them from an explicit ``torch.Generator``
with the reference's std rule. Its numbers differ from ``jax.random``'s, so
parity tests start both packages from the reference's weights
(:func:`repro_torch.convert.params_from_jax`).

Logical axes resolve to mesh axes through a rules table
(:data:`DEFAULT_RULES`), falling back to replication where a dimension does
not divide the mesh axis (:func:`resolve_spec`, :func:`tree_specs`). A spec
is a :class:`PartitionSpec`: one entry per dim, a mesh axis name, a tuple of
names or ``None``, as the reference's ``jax.sharding.PartitionSpec``.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device

PyTree = Any

__all__ = ["ParamDef", "PartitionSpec", "DEFAULT_RULES", "init_tree", "count_params",
           "resolve_spec", "tree_specs", "abstract_tree"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]              # logical axis name per dim
    init: str = "normal"                       # normal | zeros | ones
    scale: float | None = None                 # stddev override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


class PartitionSpec:
    """Per-dim mesh axes of an array: each entry an axis name, a tuple of
    names (the dim splits over their product, first name major) or ``None``
    (replicated). A leaf of a tree, not a tuple node, so spec trees walk
    like param trees; it iterates, indexes and compares as the tuple of its
    entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        object.__setattr__(self, "entries", tuple(entries))

    def __setattr__(self, name, value):
        raise AttributeError("PartitionSpec is immutable")

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


# default logical → mesh rules of the production mesh ("data", "model")
DEFAULT_RULES: dict[str | None, str | tuple[str, ...] | None] = {
    "vocab": "model",
    "q_heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "expert_ff": "model",
    "experts": "model",
    "ssm_inner": "model",
    "ssm_heads": "model",
    "lru": "model",
    "kv_lora": None,
    "embed": None,
    "embed_table": None,
    "layers": None,
    None: None,
}


def resolve_spec(d: ParamDef, rules: dict, mesh_axis_sizes: dict[str, int],
                 prefix_axes: tuple = ()) -> PartitionSpec:
    """Logical axes → :class:`PartitionSpec`, after ``prefix_axes`` (e.g. the
    worker axes of a leading worker dim). A dim stays replicated where its
    rule names no axis, an axis already used, an axis of size 1, or axes
    whose size does not divide the dim."""
    used: set[str] = set()
    for a in prefix_axes:
        used.update(n for n in (a if isinstance(a, tuple) else (a,)) if n)
    parts = []
    for size, axis in zip(d.shape, d.axes):
        mesh_axis = rules.get(axis, None)
        if mesh_axis is None:
            parts.append(None)
            continue
        names = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
        total = int(np.prod([mesh_axis_sizes.get(n, 1) for n in names]))
        if any(n in used for n in names) or size % max(total, 1) != 0 or total <= 1:
            parts.append(None)
        else:
            parts.append(mesh_axis)
            used.update(names)
    return PartitionSpec(*prefix_axes, *parts)


def tree_specs(defs: PyTree, rules: dict | None = None, mesh=None,
               prefix_axes: tuple = ()) -> PyTree:
    """A :class:`PartitionSpec` tree mirroring a ParamDef tree. ``rules``
    update :data:`DEFAULT_RULES`; ``mesh`` is anything with ``axis_names``
    and a ``shape`` mapping names to sizes (a ``launch.mesh.WorkerMesh``, an
    ``AbstractMesh``); without one nothing is sharded."""
    merged = dict(DEFAULT_RULES)
    merged.update(rules or {})
    sizes = {n: int(mesh.shape[n]) for n in mesh.axis_names} if mesh is not None else {}
    return _tree.map(lambda d: resolve_spec(d, merged, sizes, prefix_axes), defs)


def abstract_tree(defs: PyTree, dtype: torch.dtype = torch.float32) -> PyTree:
    """Shapes and dtypes without storage: tensors on the ``meta`` device, the
    port's counterpart of the reference's ``ShapeDtypeStruct`` tree."""
    return _tree.map(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def init_tree(generator: torch.Generator, defs: PyTree,
              dtype: torch.dtype = torch.float32,
              device: str | torch.device = "cuda") -> PyTree:
    """Initialize a param tree from defs, one draw per leaf in leaf order.

    Normal leaves have std ``scale`` or ``1/sqrt(fan_in)`` (fan_in = the
    second-to-last dim, or the only one). Values are drawn in float32 on the
    generator's device, then moved and cast.
    """
    dev = resolve_device(device)

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale if d.scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * std
        return x.to(device=dev, dtype=dtype)

    return _tree.map(make, defs)


def count_params(defs: PyTree) -> int:
    return int(sum(np.prod(d.shape) for d in _tree.leaves(defs)))
