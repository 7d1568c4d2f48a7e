"""Plain PyTorch version of the consensus-statistics kernel.

Over a gradient tree's and a new-param tree's leaves, each with a leading
worker dim (all M workers, or a rank's own on a worker mesh):

    E      = Σ_j ||g_j||²         E_sp = Σ_j ||g_j − ḡ||²
    ||ḡ||²                        spread = Σ_j ||w_j − w̄||²

each as a (sharded, whole) pair of float32 scalars: over the leaves a model
axis shards (this rank's part of a sum over the model group) and over the
others. x̄ is the float32 sum over all M workers ÷ M, rounded to each
leaf's dtype as the reference's mean is; the squares sum in float32, leaf
by leaf. On a worker mesh the caller passes the column sums, all-reduced
over the ranks (:func:`column_sums` makes them). The CPU path of
:func:`repro_torch.kernels.consensus_stats.consensus_stats` and the kernel
checks on the card use it.
"""
from __future__ import annotations

from typing import Sequence

import torch


def _flags(leaves, sharded) -> Sequence[bool]:
    return sharded if sharded is not None else (False,) * len(leaves)


def sq_norms(leaves, sharded=None, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ ||x||² over the ``sharded`` leaves, Σ over the others), float32."""
    z = torch.zeros((), dtype=torch.float32, device=leaves[0].device if leaves else device)
    parts = [z, z]
    for x, s in zip(leaves, _flags(leaves, sharded)):
        i = 0 if s else 1
        parts[i] = parts[i] + torch.sum(torch.square(x.float()))
    return parts[0], parts[1]


def column_sums(leaves) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """Each leaf's float32 sum over its worker dim: one flat buffer (4 bytes
    per element of a replica, and of any gaps between a worker's elements,
    for one all-reduce over a mesh's ranks) and its view per leaf, with the
    strides of a worker's copy (a transposed gradient's, a shard's with
    gaps), so that the kernel finds a column's sum where it finds the
    column. The gaps are never read."""
    sizes = [extent(x[0].shape, x[0].stride()) for x in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=leaves[0].device)
    sums = [v.as_strided(x[0].shape, x[0].stride()) for x, v in zip(leaves, flat.split(sizes))]
    for x, v in zip(leaves, sums):
        torch.sum(x, 0, dtype=torch.float32, out=v)
    return flat, sums


def extent(shape, stride) -> int:
    """Elements of memory from a tensor's first element to its last."""
    if any(n == 0 for n in shape):
        return 0
    return 1 + sum((n - 1) * st for n, st in zip(shape, stride))


def spread(leaves, M: int, sums=None, sharded=None, device=None):
    """(Σ_j ||x_j − x̄||², ||x̄||²) over the leaves, each a :func:`sq_norms`
    pair; ``sums`` are the leaves' float32 column sums over all M workers
    (this process's own workers' when None)."""
    z = torch.zeros((), dtype=torch.float32, device=leaves[0].device if leaves else device)
    out, mean_sq = [z, z], [z, z]
    if not leaves:
        return tuple(out), tuple(mean_sq)
    if sums is None:
        _, sums = column_sums(leaves)
    for x, v, s in zip(leaves, sums, _flags(leaves, sharded)):
        mean, i = (v / M).to(x.dtype), 0 if s else 1
        out[i] = out[i] + torch.sum(torch.square((x - mean).float()))
        mean_sq[i] = mean_sq[i] + torch.sum(torch.square(mean.float()))
    return tuple(out), tuple(mean_sq)


def consensus_stats_reference(grads, params, M: int, *, grad_sharded=None,
                              param_sharded=None, grad_sums=None, param_sums=None,
                              device=None) -> torch.Tensor:
    """(4, 2) float32: rows E, E_sp, ||ḡ||² (of ``grads``) and the spread
    (of ``params``), columns (sharded, whole)."""
    device = (list(grads) + list(params))[0].device if (grads or params) else device
    E = sq_norms(grads, grad_sharded, device)
    E_sp, mean_sq = spread(grads, M, grad_sums, grad_sharded, device)
    rows = [E, E_sp, mean_sq, spread(params, M, param_sums, param_sharded, device)[0]]
    return torch.stack([torch.stack(r) for r in rows])
