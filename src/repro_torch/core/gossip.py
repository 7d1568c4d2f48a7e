"""Gossip / consensus mixing (paper eq. 3, first term).

The port of the reference's ``repro/core/gossip.py``. Every parameter leaf
carries a leading worker dimension of size M, so mixing leaf ``x`` of shape
(M, ...) is ``x ← einsum('im,i...->m...', A, x)``.

Backends (selected via :class:`GossipSpec`):

* ``einsum`` — dense contraction with A; correct for any A (the oracle).
* ``fused``  — the flat-buffer gossip bus (:mod:`repro_torch.core.bus`):
  the tree packs into one buffer per dtype and the mix (+ optimizer update,
  in the train step) is one pass of the fused ``gossip_mix`` kernel.

The reference's ``ppermute`` and ``allreduce`` backends need a mesh of
devices; they come with the distributed slice (ROADMAP queue 1, item 17).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core.topology import Topology

__all__ = ["GossipSpec", "mix_pytree", "mix_reference", "mix_pytree_reference"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """Static description of how the consensus step executes.

    topology: the Topology (consensus matrix A, M workers).
    backend: 'einsum' | 'fused' | 'auto' ('auto' resolves as in the
      reference, to the mesh backends this port does not have yet).
    period: gossip every `period` optimizer steps (1 = the paper's DSM).
    """

    topology: Topology
    backend: str = "auto"
    period: int = 1

    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        t = self.topology
        if t.circulant_offsets is not None and len(t.circulant_offsets) == t.M:
            return "allreduce"  # clique
        return "ppermute"

    @functools.cached_property
    def permutations(self) -> list[tuple[float, np.ndarray]]:
        return self.topology.permutations()


def mix_reference(x: torch.Tensor, A) -> torch.Tensor:
    """Dense W·A for one leaf with leading worker dim: x[m] ← Σ_i A[i,m] x[i].

    A is cast to ``x``'s dtype first, as in the reference, so a bf16 tree
    mixes with a bf16 A.
    """
    A = torch.as_tensor(np.asarray(A), dtype=x.dtype, device=x.device)
    return torch.einsum("im,i...->m...", A, x)


def mix_pytree_reference(params: PyTree, A) -> PyTree:
    return _tree.map(lambda x: mix_reference(x, A), params)


def mix_pytree(params: PyTree, spec: GossipSpec) -> PyTree:
    """Consensus step over the parameter tree (leaves have leading M dim)."""
    backend = spec.resolved_backend()
    if backend == "einsum":
        return mix_pytree_reference(params, spec.topology.A)
    if backend == "fused":
        return bus.mix_bus(params, spec)
    if backend in ("ppermute", "allreduce"):
        raise NotImplementedError(
            f"gossip backend {backend!r} needs a device mesh; the port has "
            "the meshless 'einsum' and 'fused' backends only so far "
            "(ROADMAP queue 1, item 17)")
    raise ValueError(f"unknown gossip backend {backend!r}")
