"""Tensor parallelism over a worker mesh's model axis: the collectives as
differentiable functions.

Inside :func:`repro_torch.launch.mesh.model_parallel` (the train step on a
mesh of model factor k > 1) every rank of a worker's model group holds its
1/k shard of each leaf that ``launch.shardings.param_pspecs`` shards and
sees the worker's whole batch. The layers compute on their shards with
explicit collectives over the model group, as Megatron-LM does and as
GSPMD computes from the reference's specs:

* :func:`copy_to_model` (Megatron's *f*): identity forward, its gradient
  all-reduced (summed) over the model group. A replicated value enters a
  computation on sharded weights through it: each rank's gradient of that
  value is a partial sum.
* :func:`reduce_from_model` (*g*): all-reduce sum forward, identity
  backward. A partial sum over this rank's heads, ``ff`` columns or vocab
  rows leaves through it.
* :func:`max_over_model`: an all-reduce max, no gradient (a vocab-parallel
  softmax's shift).

Each is a ``torch.autograd.Function`` with ``setup_context`` and a
hand-written vmap rule: the train step runs ``vmap(grad_and_value)`` over
the rank's workers, so a collective meets the workers stacked. An
all-reduce of the stacked tensor is the stack of the workers' all-reduces,
so the rule moves the batch dim to the front and calls the collective
once. *f*'s backward is itself a call of *g*'s Function, never a bare
``torch.distributed`` call: ``torch.func`` runs the backward inside the
vmap, where a ``c10d`` op has no batching rule. The process group travels
with the call (``setup_context`` keeps it for the backward), since the
backward may run on another thread than the forward.

Every rank of a model group runs the same layers in the same order, the
recomputation of ``cfg.remat`` included, so the collectives pair up.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import _tree
from repro_torch.launch.mesh import model_shard

__all__ = ["copy_to_model", "reduce_from_model", "max_over_model", "ModelCut",
           "model_cut", "whole_shape", "whole_leaves"]


def _all_reduce(x: torch.Tensor, group, op) -> torch.Tensor:
    import torch.distributed as dist

    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _front(x: torch.Tensor, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


class _Reduce(torch.autograd.Function):
    """All-reduce (``op``) forward, identity backward."""

    @staticmethod
    def forward(x, group, op):
        return _all_reduce(x, group, op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        return _all_reduce(_front(x, in_dims[0]), group, op), (None if in_dims[0] is None else 0)


class _Copy(torch.autograd.Function):
    """Identity forward, all-reduce sum backward (through :class:`_Reduce`)."""

    @staticmethod
    def forward(x, group):
        return x.view_as(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.group = inputs[1]

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        return _Reduce.apply(grad, ctx.group, dist.ReduceOp.SUM), None

    @staticmethod
    def vmap(info, in_dims, x, group):
        return x.view_as(x), in_dims[0]


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """*f*: ``x`` unchanged; its gradient summed over the model group. The
    identity outside :func:`~repro_torch.launch.mesh.model_parallel`."""
    shard = model_shard()
    return x if shard is None else _Copy.apply(x, shard.group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """*g*: ``x`` summed over the model group; the gradient passes
    unchanged. The identity outside ``model_parallel``."""
    import torch.distributed as dist

    shard = model_shard()
    return x if shard is None else _Reduce.apply(x, shard.group, dist.ReduceOp.SUM)


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model group, with no gradient
    (``x`` is detached). The identity outside ``model_parallel``."""
    import torch.distributed as dist

    shard = model_shard()
    x = x.detach()
    return x if shard is None else _Reduce.apply(x, shard.group, dist.ReduceOp.MAX)


class ModelCut(NamedTuple):
    """How a tree's leaves are cut over the model axis: its process group,
    k, this rank's index along it, and per leaf (in leaf order) the dims
    sharded over it, counted from the end (-1 the last)."""

    group: Any
    k: int
    index: int
    dims: tuple[tuple[int, ...], ...]

    @property
    def sharded(self) -> tuple[bool, ...]:
        return tuple(bool(d) for d in self.dims)


def model_cut(param_specs, treedef, wm) -> ModelCut | None:
    """The :class:`ModelCut` of a tree with ``treedef`` whose leaves are
    cut by ``param_specs`` over the live WorkerMesh ``wm`` (None at model
    factor 1)."""
    if wm is None or wm.model_factor <= 1:
        return None
    axis = wm.model_axis
    dims = []
    for spec in _tree.flatten_up_to(treedef, param_specs):
        n = len(spec)
        dims.append(tuple(d - n for d, e in enumerate(spec)
                          if e is not None and axis in (e if isinstance(e, tuple) else (e,))))
    return ModelCut(wm.model_group, wm.model_factor, wm.model_index, tuple(dims))


def whole_shape(shape, dims: tuple[int, ...], k: int) -> tuple[int, ...]:
    """The whole leaf's shape of a local ``shape`` cut k ways along ``dims``."""
    return tuple(n * k if d - len(shape) in dims else n for d, n in enumerate(shape))


def whole_leaves(leaves, cut: ModelCut | None):
    """Each of the rank's ``leaves`` whole, one at a time: a leaf sharded
    over the model axis all-gathered over the model group (every model
    rank calls this, in the same leaf order), a replicated one as it is."""
    import torch.distributed as dist

    for x, dims in zip(leaves, cut.dims if cut is not None else ((),) * len(leaves)):
        if not dims:
            yield x
            continue
        parts = [torch.empty_like(x) for _ in range(cut.k)]
        dist.all_gather(parts, x.contiguous(), group=cut.group)
        yield torch.cat(parts, dims[0])
