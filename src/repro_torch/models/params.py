"""Parameter definitions and initialization.

The port of the reference's ``repro/models/params.py`` without the mesh
sharding rules (a later, distributed slice). Every module declares its
parameters as a tree of :class:`ParamDef` with logical axis names;
:func:`init_tree` draws them from an explicit ``torch.Generator`` with the
reference's std rule. Its numbers differ from ``jax.random``'s, so parity
tests start both packages from the reference's weights
(:func:`repro_torch.convert.params_from_jax`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device

PyTree = Any

__all__ = ["ParamDef", "init_tree", "count_params"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]              # logical axis name per dim
    init: str = "normal"                       # normal | zeros | ones
    scale: float | None = None                 # stddev override

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


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
