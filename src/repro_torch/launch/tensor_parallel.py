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
* :func:`gather_from_model`: an all-gather of the rank's columns along a
  dim; its gradient is this rank's slice of the cotangent, with no sum.
  That is right only where every cotangent reaching the gathered tensor is
  whole and equal on every model rank, which the layers hold by
  construction (an MoE's router logits: everything downstream of them is
  computed redundantly, and the routing weights enter the combine through
  *f*).
* :func:`reduce_scatter_model`: a partial sum over the model group, cut to
  this rank's columns along a dim (an all-reduce, then the rank's slice);
  its gradient is the cotangents of every rank's columns, all-gathered.
  RG-LRU's gate products ``conv @ wa`` with ``wa``'s rows cut: each rank's
  product is a partial sum over the whole width, of which it keeps its
  columns.
* :func:`all_gather_model`: its dual, an all-gather of the rank's columns
  whose gradient is the cotangent summed over the model group, cut to the
  rank's columns. Mamba-2's ``in_proj`` and conv weights, whose columns are
  cut straight across the z / x / B / C / dt boundaries: each rank gathers
  the whole and uses its heads' columns and the whole B and C, so each
  rank's cotangent of the whole is a partial one.

A globally routed MoE whose batch rows are cut over the worker groups
(allreduce mode on a mesh) routes over the whole batch with two
collectives over the worker groups, not the model group:
:func:`gather_over_rows` (each rank's per-expert counts, exact integers,
no gradient) and :func:`sum_over_rows` (the router's per-expert
probability sums; its gradient is the cotangent times the number of
ranks, since the step averages the ranks' gradients where the global
loss sums their tokens' contributions).

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
from repro_torch.launch import cost
from repro_torch.launch.mesh import model_shard

__all__ = ["copy_to_model", "reduce_from_model", "max_over_model", "gather_from_model",
           "reduce_scatter_model", "all_gather_model", "gather_over_rows", "sum_over_rows", "ModelCut", "model_cut", "whole_shape",
           "whole_leaves"]


def _all_reduce(x: torch.Tensor, groups, op) -> torch.Tensor:
    """``x`` all-reduced (``op``) over each group in turn, out of place."""
    import torch.distributed as dist

    out = x.contiguous().clone()
    for group in groups:
        dist.all_reduce(out, op=op, group=group)
        cost.record_collective("all-reduce", out.numel() * out.element_size(), group)
    return out


def _all_gather(x: torch.Tensor, groups, dim: int) -> torch.Tensor:
    """``x`` all-gathered along ``dim`` over each group in turn, the last
    first, so that the first group's index ends up major."""
    import torch.distributed as dist

    for group in reversed(groups):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, dim)
        cost.record_collective("all-gather", x.numel() * x.element_size(), group)
    return x


def _front(x: torch.Tensor, bdim):
    return x if bdim is None else x.movedim(bdim, 0)


class _Reduce(torch.autograd.Function):
    """All-reduce (``op``) forward, identity backward."""

    @staticmethod
    def forward(x, group, op):
        return _all_reduce(x, (group,), op)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None

    @staticmethod
    def vmap(info, in_dims, x, group, op):
        out = _all_reduce(_front(x, in_dims[0]), (group,), op)
        return out, (None if in_dims[0] is None else 0)


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


def _shifted(dim: int, bdim) -> int:
    """``dim`` of a logical tensor in its batched form, the batch dim at 0."""
    return dim if dim < 0 or bdim is None else dim + 1


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``groups`` forward; backward: this
    rank's slice (``index``, first group major) of the cotangent."""

    @staticmethod
    def forward(x, groups, index, dim):
        return _all_gather(x, groups, dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, _, index, dim = inputs
        ctx.index, ctx.dim, ctx.n = index, dim, x.shape[dim]

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.n, ctx.n), None, None, None

    @staticmethod
    def vmap(info, in_dims, x, groups, index, dim):
        bdim = in_dims[0]
        out = _all_gather(_front(x, bdim), groups, _shifted(dim, bdim))
        return out, (None if bdim is None else 0)


class _ReduceScatter(torch.autograd.Function):
    """All-reduce sum over ``group``, then this rank's slice (``index``) of
    k along ``dim``; backward: the cotangent all-gathered along ``dim``
    (through :class:`_AllGather`)."""

    @staticmethod
    def forward(x, group, k, index, dim):
        import torch.distributed as dist

        n = x.shape[dim] // k
        return _all_reduce(x, (group,), dist.ReduceOp.SUM).narrow(dim, index * n, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return (_AllGather.apply(grad, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, group, k, index, dim):
        import torch.distributed as dist

        bdim = in_dims[0]
        d = _shifted(dim, bdim)
        x = _all_reduce(_front(x, bdim), (group,), dist.ReduceOp.SUM)
        n = x.shape[d] // k
        return x.narrow(d, index * n, n), (None if bdim is None else 0)


class _AllGather(torch.autograd.Function):
    """All-gather along ``dim`` over ``group``; backward: the cotangent
    summed over ``group``, then this rank's slice (through
    :class:`_ReduceScatter`)."""

    @staticmethod
    def forward(x, group, k, index, dim):
        return _all_gather(x, (group,), dim)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.args = inputs[1:]

    @staticmethod
    def backward(ctx, grad):
        return (_ReduceScatter.apply(grad, *ctx.args),) + (None,) * 4

    @staticmethod
    def vmap(info, in_dims, x, group, k, index, dim):
        bdim = in_dims[0]
        out = _all_gather(_front(x, bdim), (group,), _shifted(dim, bdim))
        return out, (None if bdim is None else 0)


class _SumRows(torch.autograd.Function):
    """All-reduce sum over ``groups`` forward; backward: the cotangent
    times ``n``."""

    @staticmethod
    def forward(x, groups, n):
        import torch.distributed as dist

        return _all_reduce(x, groups, dist.ReduceOp.SUM)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.n = inputs[2]

    @staticmethod
    def backward(ctx, grad):
        return grad * ctx.n, None, None

    @staticmethod
    def vmap(info, in_dims, x, groups, n):
        import torch.distributed as dist

        return (_all_reduce(_front(x, in_dims[0]), groups, dist.ReduceOp.SUM),
                None if in_dims[0] is None else 0)


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


def gather_from_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, this rank's columns along ``dim``, all-gathered over the
    model group in rank order; the gradient is this rank's slice of the
    cotangent (no sum: every model rank must see the whole, equal
    cotangent). The identity outside ``model_parallel``."""
    shard = model_shard()
    return x if shard is None else _Gather.apply(x, (shard.group,), shard.index, dim)


def reduce_scatter_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, a partial sum over the model group, summed and cut to this
    rank's 1/k along ``dim`` (rank order); the gradient is every rank's
    cotangent all-gathered along ``dim``. The identity outside
    ``model_parallel``."""
    shard = model_shard()
    return x if shard is None else _ReduceScatter.apply(x, shard.group, shard.k,
                                                        shard.index, dim)


def all_gather_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x``, this rank's columns along ``dim``, all-gathered over the model
    group in rank order; the gradient is the cotangent summed over the
    model group, cut to the rank's columns (each rank's cotangent of the
    whole is a partial one). The identity outside ``model_parallel``."""
    shard = model_shard()
    return x if shard is None else _AllGather.apply(x, shard.group, shard.k, shard.index, dim)


def gather_over_rows(x: torch.Tensor, wm) -> torch.Tensor:
    """Every worker group's ``x`` stacked on a new leading dim in worker
    order (``wm``'s worker axes, the first major), with no gradient:
    ``x`` is detached."""
    return _Gather.apply(x.detach()[None], tuple(wm.worker_groups), wm.worker_index, 0)


def sum_over_rows(x: torch.Tensor, wm) -> torch.Tensor:
    """``x`` summed over ``wm``'s worker groups; its gradient is the
    cotangent times ``wm.n_workers`` (module docstring)."""
    return _SumRows.apply(x, tuple(wm.worker_groups), wm.n_workers)


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
    for x, dims in zip(leaves, cut.dims if cut is not None else ((),) * len(leaves)):
        yield _all_gather(x, (cut.group,), dims[0]) if dims else x
