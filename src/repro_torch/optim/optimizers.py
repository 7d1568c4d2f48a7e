"""Minimal tree optimizers (optax-style pure functions).

The port of ``repro/optim/optimizers.py``: plain (sub)gradient descent
(DSM) and classical momentum, the paper's two optimizers, plus Adam and a
factorized second-moment optimizer. Updates are
elementwise over leaves, so they apply unchanged to gossip-mode params that
carry a leading worker dimension, and they already include −lr: the fused
gossip step adds them with ``eta = -1``.

bf16 rounding follows the reference's type promotion, written out:

* ``-eta * g`` there multiplies by a float32 array, so a bf16 ``g`` is
  computed in float32 and rounded once (:func:`_scale_f32`). A torch float32
  0-d tensor times a bf16 tensor would instead stay bf16.
* ``mu * u`` there has a weakly typed Python ``mu``, which is rounded to
  ``u``'s dtype first; the product and the ``+ g`` that follows each round
  to that dtype (:func:`_weak`).
* Adam's bias corrections and Adafactor's ``b2`` are float32 on the device
  there, from ``t = float32(step) + 1``; here they are computed on the host
  in ``np.float32``, one operation at a time, so only ``np.power`` against
  XLA's ``pow`` may differ, by one float32 ulp. The bias corrections divide
  through :func:`_div_f32`.

Adam and Adafactor walk the leaves one at a time, so only one leaf's float32
temporaries are alive at once; the state is never updated in place.

Every ``update`` takes ``cuts``: on a worker mesh, the process groups the
leading worker dim is cut over (``WorkerMesh.worker_groups``, first axis
major), None when this process holds every worker; and ``model``: with a
model axis, how the leaves are cut over it (a
``launch.tensor_parallel.ModelCut``), else None. Only Adafactor's
statistics that run across workers or along a sharded dim read them; the
elementwise optimizers ignore both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.launch import cost

PyTree = Any
Schedule = Callable[[int], float]

__all__ = ["Optimizer", "sgd", "momentum_sgd", "adam", "adafactor_like"]

f32 = np.float32


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: float(np.float32(lr))


def _scale_f32(x: torch.Tensor, s: float) -> torch.Tensor:
    """``(s * x)`` computed in float32 with ``s`` rounded to float32, cast
    back to ``x.dtype``."""
    return (x.float() * float(np.float32(s))).to(x.dtype)


def _weak(c: float, dtype: torch.dtype) -> float:
    """A Python constant as a weakly typed JAX scalar sees it: rounded to
    ``dtype``."""
    return torch.tensor(c, dtype=dtype).item()


def _div_f32(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as a true float32 division. A Python scalar divisor on CUDA
    becomes a multiply by its reciprocal; a 0-d device tensor (a fill kernel,
    no copy, no sync) keeps the division."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state;
    update(grads, state, params, step, cuts=None, model=None) -> (updates, state).

    ``updates`` are deltas to add to the params (they already include -lr).
    """

    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]
    name: str = "optimizer"


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step, cuts=None, model=None):
        eta = sched(step)
        return _tree.map(lambda g: _scale_f32(g, -eta), grads), state

    return Optimizer(init, update, "sgd")


def momentum_sgd(lr, mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Classical momentum (paper §4 experiment 3: mu = 0.9)."""
    sched = _as_schedule(lr)

    def init(params):
        return _tree.map(torch.zeros_like, params)

    def update(grads, state, params, step, cuts=None, model=None):
        eta = sched(step)
        new_u = _tree.map(lambda u, g: (u * _weak(mu, u.dtype) + g).to(u.dtype),
                          state, grads)
        if nesterov:
            upd = _tree.map(
                lambda u, g: _scale_f32(u * _weak(mu, u.dtype) + g, -eta).to(g.dtype),
                new_u, grads)
        else:
            upd = _tree.map(lambda u: _scale_f32(u, -eta), new_u)
        return upd, new_u

    return Optimizer(init, update, f"momentum{mu}")


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return {"m": _tree.map(zeros, params), "v": _tree.map(zeros, params)}

    def update(grads, state, params, step, cuts=None, model=None):
        eta = sched(step)
        t = f32(step) + f32(1.0)
        c1 = float(f32(1.0) - f32(b1) ** t)
        c2 = float(f32(1.0) - f32(b2) ** t)
        flat_g, treedef = _tree.flatten(grads)
        flat_m, flat_v, flat_p = (_tree.leaves(state["m"]), _tree.leaves(state["v"]),
                                  _tree.leaves(params))
        upds, ms, vs = [], [], []
        for g, m_, v_, p in zip(flat_g, flat_m, flat_v, flat_p):
            g32 = g.float()
            m = m_ * b1 + g32 * (1 - b1)
            v = v_ * b2 + g32.square() * (1 - b2)
            mh = _div_f32(m, c1)
            den = _div_f32(v, c2).sqrt_().add_(eps)
            u = mh.div_(den)
            del den
            if weight_decay:
                u = u.add_(p.float() * weight_decay)
            upds.append(u.mul_(-eta).to(p.dtype))
            ms.append(m)
            vs.append(v)
        return (_tree.unflatten(treedef, upds),
                {"m": _tree.unflatten(treedef, ms), "v": _tree.unflatten(treedef, vs)})

    return Optimizer(init, update, "adam")


def _all_workers(x: torch.Tensor, cuts) -> torch.Tensor:
    """The rows of every worker, in worker order: ``x`` (leading dim this
    rank's workers) all-gathered over each worker axis, the last first, so
    the first axis ends up major. Without cuts, ``x`` itself."""
    import torch.distributed as dist

    for group in reversed(cuts or ()):
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        x = torch.cat(parts, 0)
        cost.record_collective("all-gather", x.numel() * x.element_size(), group)
    return x


def _mean(x: torch.Tensor, dim: int, sharded: tuple[int, ...], model) -> torch.Tensor:
    """``x.mean(dim)``; where ``dim`` is among the ``sharded`` dims (counted
    from the end) the mean over the whole dim: this rank's sum all-reduced
    over ``model``'s group, divided by the global size."""
    if dim not in sharded:
        return x.mean(dim)
    import torch.distributed as dist

    total = x.sum(dim)
    dist.all_reduce(total, group=model.group)
    cost.record_collective("all-reduce", total.numel() * total.element_size(), model.group)
    return total.div_(x.shape[dim] * model.k)


def adafactor_like(lr, eps: float = 1e-30, decay: float = 0.8) -> Optimizer:
    """Memory-lean second-moment optimizer (row/col factorized for 2-D leaves).

    Leaves are factorized by their own rank, so a gossip-mode leaf with its
    leading worker dimension is factorized too: a 1-D parameter arrives 2-D
    and its row/column statistics run across workers, as in the reference.
    On a worker mesh (``cuts``) those two means, the column statistic and
    the row statistic's mean, are taken over every worker's rows, gathered
    (a 1-D parameter's size per worker), in the meshless order, so the
    update equals the meshless one bit for bit; the column statistic is
    then the same on every rank. With a model axis (``model``) a mean
    along a dim sharded over it is this rank's sum, all-reduced over the
    model group and divided by the global size (another summation order
    than meshless).
    """
    sched = _as_schedule(lr)

    def init(params):
        def leaf(p):
            z = lambda shape: torch.zeros(shape, dtype=torch.float32, device=p.device)
            if p.ndim >= 2:
                return {"row": z(p.shape[:-1]), "col": z(p.shape[:-2] + p.shape[-1:])}
            return {"v": z(p.shape)}
        return _tree.map(leaf, params)

    def update(grads, state, params, step, cuts=None, model=None):
        eta = sched(step)
        b2 = f32(1.0) - (f32(step) + f32(1.0)) ** f32(-decay)
        keep = float(b2)
        fresh = float(f32(1.0) - b2)

        def leaf(g, s, p, dims):
            g32 = g.float()
            g2 = g32.square().add_(eps)
            if g.ndim >= 2:
                # a 2-D leaf's dim -2 is the worker dim: on a mesh it spans ranks
                across = cuts if g.ndim == 2 else None
                row = s["row"] * keep + _mean(g2, -1, dims, model) * fresh
                col = s["col"] * keep + _mean(_all_workers(g2, across), -2, dims,
                                              model) * fresh
                del g2
                denom = row[..., :, None] * col[..., None, :]
                # the row statistic's last dim is the leaf's dim -2
                row_mean = _mean(_all_workers(row, across), -1,
                                 (-1,) if -2 in dims else (), model)
                denom = denom.div_(row_mean[..., None, None] + eps)
                u = g32 / denom.sqrt_().add_(eps)
                return u.mul_(-eta).to(p.dtype), {"row": row, "col": col}
            v = s["v"] * keep + g2 * fresh
            u = (g32 * -eta).div_(v.sqrt().add_(eps))
            return u.to(p.dtype), {"v": v}

        flat_g, treedef = _tree.flatten(grads)
        flat_s = _tree.flatten_up_to(treedef, state)
        flat_p = _tree.leaves(params)
        flat_d = model.dims if model is not None else ((),) * len(flat_g)
        outs = [leaf(g, s, p, d) for g, s, p, d in zip(flat_g, flat_s, flat_p, flat_d)]
        return (_tree.unflatten(treedef, [o[0] for o in outs]),
                _tree.unflatten(treedef, [o[1] for o in outs]))

    return Optimizer(init, update, "adafactor")
