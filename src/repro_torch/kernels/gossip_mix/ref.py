"""Plain PyTorch version of the fused gossip-mix + update kernel.

The consensus step at worker j (paper eq. 3, with the optimizer update):

    w_j ← a_self·w_j + Σ_d a_d·nbr_d − η·u_j

The same loop as the reference's ``repro/kernels/gossip_mix/ref.py``: float32
accumulation in the order self, neighbours in d order, then −η·u, one cast
to ``w``'s dtype at the end. The weights and η are rounded to float32 first,
as the reference passes them to its kernel. The CPU path of
:func:`repro_torch.kernels.gossip_mix.gossip_mix_2d` and the kernel checks
on the card use it.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def gossip_mix_reference(
    w: torch.Tensor,                  # any shape
    neighbors: torch.Tensor,          # (k, *w.shape), w's dtype
    weights: Sequence[float],         # k + 1 values: [a_self, a_1, ..., a_k]
    update: torch.Tensor | None = None,   # w.shape, float32 or bf16
    eta: float | None = None,         # required with update
) -> torch.Tensor:
    a = [float(x) for x in np.asarray(weights, np.float32)]
    acc = w.float() * a[0]
    for d in range(neighbors.shape[0]):
        acc = acc + neighbors[d].float() * a[d + 1]
    if update is not None:
        acc = acc - float(np.float32(eta)) * update.float()
    return acc.to(w.dtype)
