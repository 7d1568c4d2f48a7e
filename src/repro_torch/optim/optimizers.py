"""Minimal tree optimizers (optax-style pure functions).

The port of ``repro/optim/optimizers.py``: plain (sub)gradient descent
(DSM) and classical momentum, the paper's two optimizers. Updates are
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
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import _tree

PyTree = Any
Schedule = Callable[[int], float]

__all__ = ["Optimizer", "sgd", "momentum_sgd"]


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


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """init(params) -> state; update(grads, state, params, step) -> (updates, state).

    ``updates`` are deltas to add to the params (they already include -lr).
    """

    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree, int], tuple[PyTree, PyTree]]
    name: str = "optimizer"


def sgd(lr) -> Optimizer:
    sched = _as_schedule(lr)

    def init(params):
        return ()

    def update(grads, state, params, step):
        eta = sched(step)
        return _tree.map(lambda g: _scale_f32(g, -eta), grads), state

    return Optimizer(init, update, "sgd")


def momentum_sgd(lr, mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Classical momentum (paper §4 experiment 3: mu = 0.9)."""
    sched = _as_schedule(lr)

    def init(params):
        return _tree.map(torch.zeros_like, params)

    def update(grads, state, params, step):
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
