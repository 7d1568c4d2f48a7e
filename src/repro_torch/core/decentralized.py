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

``microbatch > 1`` accumulates the gradient over that many chunks of the
per-worker batch in float32 (:func:`_microbatched`). A spec with
``time_varying='one_peer_exp'`` mixes step k with round ``k % log2 M`` of the
one-peer graph (fused: one k = 1 ``gossip_mix`` pass per dtype group). As
in the reference, adapt-then-combine (``mix_first=False``) with
``period == 1`` mixes with the spec's static topology even then.

``TrainState.step`` is a Python int, so the step count, the gossip period,
the time-varying round and the learning-rate schedule never wait on the
device.
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


def _microbatched(value_and_grad_fn, microbatch: int, batch_axis: int):
    """Gradient accumulation: chunk i of ``microbatch`` is rows
    ``[i·b/mb, (i+1)·b/mb)`` of the batch axis; grads accumulate in float32
    in chunk order, loss and grads are then scaled by float32 ``1/mb``. The
    grads stay float32, as in the reference. Returns ``(grads, loss)``, the
    order of ``torch.func.grad_and_value``."""

    def run(params, batch):
        def chunk(x, i):
            b = x.shape[batch_axis]
            if b % microbatch:
                raise ValueError(f"batch of {b} does not split into {microbatch} microbatches")
            n = b // microbatch
            return x.narrow(batch_axis, i * n, n)

        acc_l = acc_g = None
        for i in range(microbatch):
            g, l = value_and_grad_fn(params, _tree.map(lambda x: chunk(x, i), batch))
            with torch.no_grad():
                if acc_g is None:
                    acc_l, acc_g = l.float(), _tree.map(lambda x: x.float(), g)
                else:
                    acc_l = acc_l + l
                    _tree.map(lambda a, x: a.add_(x), acc_g, g)
            del g
        inv = 1.0 / microbatch
        with torch.no_grad():
            return _tree.map(lambda a: a.mul_(inv), acc_g), acc_l * inv

    return run


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    optimizer: Optimizer,
    gossip: GossipSpec | None = None,
    mode: str = "gossip",
    mix_first: bool = True,
    microbatch: int = 1,
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
      microbatch: gradient-accumulation factor over the per-worker batch.
    """
    # torch.func imports torch._dynamo inside the first gradient; an
    # exception caught during that import leaves a traceback cycle that holds
    # the first step's tensors until the cyclic collector runs. Importing it
    # here, before any step, keeps the first step free of cycles.
    import torch._dynamo  # noqa: F401

    if mode == "gossip":
        if gossip is None:
            raise ValueError("gossip mode requires a GossipSpec")
        # mix + update in ONE kernel pass over the flat bus (mix_first only:
        # adapt-then-combine needs the update applied before the mix; a
        # hierarchical spec runs two staged mixes, then adds the update)
        fuse_update = (gossip.resolved_backend() == "fused" and mix_first
                       and not gossip.hierarchical)
        vg = torch.func.vmap(torch.func.grad_and_value(loss_fn))
        if microbatch > 1:
            vg = _microbatched(vg, microbatch, batch_axis=1)
        if gossip.time_varying:
            gossip.one_peer_specs   # build the rounds' specs once, here

        def step(state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
            # batch leaves: (M, per_worker_batch, ...)
            grads, losses = vg(state.params, batch)
            with torch.no_grad():
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params, state.step)
                mix_now = state.step % gossip.period == 0

                def do_mix(p):
                    if gossip.time_varying:
                        return gossip_lib.mix_pytree_time_varying(p, gossip, state.step)
                    return gossip_lib.mix_pytree(p, gossip)

                if fuse_update:
                    # updates already carry −lr ⇒ eta = −1 gives mix(p) + u
                    if not mix_now:
                        new_params = _add_updates(state.params, updates)
                    elif gossip.time_varying:
                        new_params = bus.mix_and_update_time_varying(
                            state.params, gossip, updates, state.step, eta=-1.0)
                    else:
                        new_params = bus.mix_bus(state.params, gossip,
                                                 updates=updates, eta=-1.0)
                elif mix_first:
                    mixed = do_mix(state.params) if mix_now else state.params
                    new_params = _add_updates(mixed, updates)
                else:
                    stepped = _add_updates(state.params, updates)
                    if gossip.period == 1:
                        # the reference's quirk: the static topology, even
                        # under time_varying (ROADMAP queue 3)
                        new_params = gossip_lib.mix_pytree(stepped, gossip)
                    else:
                        new_params = do_mix(stepped) if mix_now else stepped
                E, E_sp, H = gradient_stats(grads)
                spread = param_spread(new_params)
            metrics = StepMetrics(losses.mean(), E, E_sp, H, spread)
            return TrainState(state.step + 1, new_params, opt_state), metrics

        return step

    if mode == "allreduce":
        # Centralized equivalent: a single param copy over the whole batch.
        vg = torch.func.grad_and_value(loss_fn)
        if microbatch > 1:
            vg = _microbatched(vg, microbatch, batch_axis=0)

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
