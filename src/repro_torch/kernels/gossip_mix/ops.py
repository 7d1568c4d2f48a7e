"""Fused gossip-mix + update over a leaf of any shape or a whole parameter tree.

The port of the reference's ``repro/kernels/gossip_mix/ops.py``:

* :func:`gossip_mix_leaf` — one leaf of any shape, padded to whole
  ``LANE``-wide rows and run through :func:`gossip_mix_2d`.
* :func:`gossip_mix_pytree` — the whole tree packs once into the flat bus
  layout (:func:`repro_torch.core.bus.plan_layout`, one worker, no leading
  dim) and runs one kernel launch per dtype group, not one per leaf.

The reference's ``block_r``/``block_c``/``interpret`` tile its Pallas grid;
the CUDA kernel is not tiled by rows, so the port has no such arguments.
Weights and η are host values, as :func:`gossip_mix_2d` takes them.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.kernels.gossip_mix.kernel import gossip_mix_2d

PyTree = Any

__all__ = ["gossip_mix_leaf", "gossip_mix_pytree"]


def _host_weights(weights) -> np.ndarray:
    if isinstance(weights, torch.Tensor):
        weights = weights.detach().cpu().numpy()
    return np.asarray(weights, np.float32)


def _pad_to_2d(x: torch.Tensor, cols: int) -> torch.Tensor:
    n = x.numel()
    rows = max(-(-n // cols), 1)
    flat = x.new_zeros(rows * cols)
    flat[:n] = x.reshape(-1)
    return flat.view(rows, cols)


def gossip_mix_leaf(w: torch.Tensor, neighbors: torch.Tensor, weights: Sequence[float],
                    update: torch.Tensor, eta: float) -> torch.Tensor:
    """Fused mix + update for one leaf of any shape; ``neighbors`` is
    ``(k, *w.shape)``."""
    from repro_torch.core.bus import LANE

    k = neighbors.shape[0]
    w2 = _pad_to_2d(w, LANE)
    nb2 = torch.stack([_pad_to_2d(neighbors[d], LANE) for d in range(k)])
    up2 = _pad_to_2d(update, LANE)
    out = gossip_mix_2d(w2, nb2, _host_weights(weights), up2, float(eta))
    return out.reshape(-1)[:w.numel()].view(w.shape)


def gossip_mix_pytree(params: PyTree, neighbor_params: list[PyTree],
                      weights: Sequence[float], updates: PyTree, eta: float) -> PyTree:
    """Fused kernel over a tree via the flat bus layout: one pack, one
    launch per dtype group."""
    from repro_torch.core import bus

    layout = bus.plan_layout(params, lead_ndim=0)
    self_bufs = bus.pack(params, layout, lead_ndim=0)
    nbr_bufs = [bus.pack(nb, layout, lead_ndim=0) for nb in neighbor_params]
    upd_bufs = bus.pack(updates, layout, lead_ndim=0)
    wts = _host_weights(weights)
    outs = [gossip_mix_2d(self_bufs[gi], torch.stack([nb[gi] for nb in nbr_bufs]),
                          wts, upd_bufs[gi], float(eta))
            for gi in range(len(layout.groups))]
    return bus.unpack(outs, layout, lead_ndim=0)
