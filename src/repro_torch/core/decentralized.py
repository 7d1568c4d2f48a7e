"""Decentralized (consensus-based) training step — the paper's eq. (3).

    w_j(k+1) = Σ_{i∈N_j∪{j}} A_{i,j} w_i(k)  −  η(k) g_j(w_j(k))

The port of the reference's ``repro/core/decentralized.py``, meshless.

* gossip mode: every parameter leaf carries a leading worker dim of size M.
  The per-worker gradient is ``torch.func.vmap`` of ``grad_and_value`` over
  that dim (workers are data-parallel replicas with different params), the
  optimizer update is elementwise, and the consensus mix is the only
  cross-worker step (:mod:`repro_torch.core.gossip`). With the ``fused``
  backend and ``mix_first``, mix and update are one pass of the gossip_mix
  kernel over the flat bus.
* allreduce mode: the centralized baseline (one param copy, the whole
  batch), which the paper compares against.

``TrainState.step`` is a Python int, so the step count, the gossip period
and the learning-rate schedule never wait on the device. ``microbatch`` and
time-varying topologies come in a later slice (ROADMAP queue 1).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core import gossip as gossip_lib
from repro_torch.core.gossip import GossipSpec
from repro_torch.optim import Optimizer

PyTree = Any

__all__ = ["TrainState", "StepMetrics", "init_state", "replicate_for_workers",
           "gradient_stats", "param_spread", "make_train_step"]


class TrainState(NamedTuple):
    step: int
    params: PyTree
    opt_state: PyTree


class StepMetrics(NamedTuple):
    loss: torch.Tensor            # mean loss over workers
    grad_energy: torch.Tensor     # Ê  = Σ_j ||g_j||²            (paper A5, E)
    grad_spread: torch.Tensor     # Ê_sp = Σ_j ||g_j - ḡ||²      (paper E_sp)
    mean_grad_norm: torch.Tensor  # √M·||ḡ||₂ — single-sample proxy for H
    param_spread: torch.Tensor    # ||ΔW||_F² = Σ_j ||w_j - w̄||² (consensus error)


def init_state(params: PyTree, optimizer: Optimizer) -> TrainState:
    return TrainState(0, params, optimizer.init(params))


def replicate_for_workers(params: PyTree, M: int) -> PyTree:
    """Give every leaf a leading worker dim (same init ⇒ R_sp = 0, paper §3)."""
    return _tree.map(lambda x: x[None].expand((M,) + tuple(x.shape)).contiguous(),
                     params)


def _tree_sq_norm(t: PyTree) -> torch.Tensor:
    return sum(torch.sum(torch.square(x.float())) for x in _tree.leaves(t))


def gradient_stats(grads_M: PyTree) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, E_sp, √M||ḡ||) from per-worker grads (leading M dim)."""
    E = _tree_sq_norm(grads_M)
    mean_g = _tree.map(lambda g: g.mean(0, keepdim=True), grads_M)
    delta = _tree.map(lambda g, m: g - m, grads_M, mean_g)
    E_sp = _tree_sq_norm(delta)
    M = _tree.leaves(grads_M)[0].shape[0]
    H_proxy = torch.sqrt(M * _tree_sq_norm(mean_g) / 1.0)
    return E, E_sp, H_proxy


def param_spread(params_M: PyTree) -> torch.Tensor:
    mean_p = _tree.map(lambda p: p.mean(0, keepdim=True), params_M)
    return _tree_sq_norm(_tree.map(lambda p, m: p - m, params_M, mean_p))


def _add_updates(params: PyTree, updates: PyTree) -> PyTree:
    return _tree.map(lambda p, u: p + u.to(p.dtype), params, updates)


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    optimizer: Optimizer,
    gossip: GossipSpec | None = None,
    mode: str = "gossip",
    mix_first: bool = True,
):
    """Build the train step ``step(state, batch) -> (state, StepMetrics)``.

    Args:
      loss_fn: (params, batch) -> scalar loss for ONE worker (no leading M).
      optimizer: a repro_torch.optim Optimizer.
      gossip: GossipSpec (required for mode='gossip').
      mode: 'gossip' | 'allreduce'.
      mix_first: paper's eq. (3) mixes the current params and subtracts the
        gradient taken at the current local params (True). False gives the
        adapt-then-combine variant — mix(w - η g).
    """
    if mode == "gossip":
        if gossip is None:
            raise ValueError("gossip mode requires a GossipSpec")
        # mix + update in ONE kernel pass over the flat bus (mix_first only:
        # adapt-then-combine needs the update applied before the mix; a
        # hierarchical spec runs two staged mixes, then adds the update)
        fuse_update = (gossip.resolved_backend() == "fused" and mix_first
                       and not gossip.hierarchical)
        vg = torch.func.vmap(torch.func.grad_and_value(loss_fn))

        def step(state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
            # batch leaves: (M, per_worker_batch, ...)
            grads, losses = vg(state.params, batch)
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params, state.step)
                mix_now = state.step % gossip.period == 0
                if fuse_update:
                    # updates already carry −lr ⇒ eta = −1 gives mix(p) + u
                    new_params = (bus.mix_bus(state.params, gossip,
                                              updates=updates, eta=-1.0)
                                  if mix_now else _add_updates(state.params, updates))
                elif mix_first:
                    mixed = (gossip_lib.mix_pytree(state.params, gossip)
                             if mix_now else state.params)
                    new_params = _add_updates(mixed, updates)
                else:
                    stepped = _add_updates(state.params, updates)
                    new_params = (gossip_lib.mix_pytree(stepped, gossip)
                                  if mix_now else stepped)
                E, E_sp, H = gradient_stats(grads)
                spread = param_spread(new_params)
            metrics = StepMetrics(losses.mean(), E, E_sp, H, spread)
            return TrainState(state.step + 1, new_params, opt_state), metrics

        return step

    if mode == "allreduce":
        # Centralized equivalent: a single param copy over the whole batch.
        vg = torch.func.grad_and_value(loss_fn)

        def step(state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
            grads, loss = vg(state.params, batch)
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params, state.step)
                new_params = _add_updates(state.params, updates)
                z = torch.zeros((), device=loss.device)
                gn = _tree_sq_norm(grads)
            metrics = StepMetrics(loss, gn, z, torch.sqrt(gn), z)
            return TrainState(state.step + 1, new_params, opt_state), metrics

        return step

    raise ValueError(f"unknown mode {mode!r}")
