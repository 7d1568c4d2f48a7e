"""The paper's three ML problems and the functions that train them (paper §4).

The port of the problems and training functions of the reference's
``benchmarks/common.py``, in the same CPU-tractable synthetic form: convex
linear regression (the CT-scan analogue), a one-hidden-layer tanh classifier
(the MNIST analogue) and a tiny granite-style transformer LM (the CIFAR
analogue). A problem is the tuple ``(arrays, labels, params0, loss, name)``:
numpy data arrays indexed along axis 0, per-example labels for the
by-label split, the initial parameters (one replica, CPU tensors), the
per-worker loss ``loss(params, batch)`` and a name.

:func:`run_dsm` trains a problem with the decentralized step (eq. 3) on a
topology and returns the global-loss curve; :func:`run_sim` trains it on the
event-driven simulator (:mod:`repro_torch.sim`).

The reference draws the classifier's and the LM's initial weights with
``jax.random``; the port draws its own from a seeded ``torch.Generator``, so
the two packages start from different weights unless a caller passes the
reference's (``convert.params_from_jax``) in the problem tuple.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device, to_device
from repro_torch.core import topology as T
from repro_torch.core.decentralized import init_state, make_train_step, replicate_for_workers
from repro_torch.core.gossip import GossipSpec
from repro_torch.data import (WorkerBatcher, classification_data, linear_regression_data,
                              pad_to_equal, random_split, split_by_label, token_stream)
from repro_torch.optim import momentum_sgd, sgd

__all__ = ["problem_linear", "problem_classifier", "problem_lm", "run_dsm", "run_sim"]

Problem = tuple[tuple[np.ndarray, ...], np.ndarray, Any, Any, str]


def problem_linear(S: int = 2048, n: int = 64, seed: int = 0) -> Problem:
    X, y, _ = linear_regression_data(S=S, n=n, seed=seed)

    def loss(params, batch):
        bx, by = batch
        return torch.mean((bx @ params["w"] - by) ** 2)

    params0 = {"w": torch.zeros(n)}
    # pseudo-labels for by-label splits: quantile bins of the first feature
    labels = np.digitize(X[:, 0], np.quantile(X[:, 0], np.linspace(0, 1, 17)[1:-1]))
    return (X, y), labels.astype(np.int32), params0, loss, "linear-regr(CT-analogue)"


def problem_classifier(S: int = 2048, n: int = 32, n_classes: int = 10,
                       seed: int = 0) -> Problem:
    X, y = classification_data(S=S, n=n, n_classes=n_classes, seed=seed)

    def loss(params, batch):
        bx, by = batch
        h = torch.tanh(bx @ params["W1"] + params["b1"])
        lp = torch.log_softmax(h @ params["W2"] + params["b2"], dim=-1)
        return -torch.mean(torch.gather(lp, -1, by[:, None].long()))

    gen = torch.Generator().manual_seed(seed)
    hdim = 32
    params0 = {
        "W1": torch.randn((n, hdim), generator=gen) * 0.1, "b1": torch.zeros(hdim),
        "W2": torch.zeros((hdim, n_classes)), "b2": torch.zeros(n_classes),
    }
    return (X, y), y, params0, loss, "mlp(MNIST-analogue)"


def problem_lm(S: int = 512, seq: int = 32, vocab: int = 256, seed: int = 0) -> Problem:
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    toks, labels = token_stream(S=S, seq_len=seq, vocab=vocab, seed=seed)
    # granite-3-2b's family cut to 2 layers of 64 (the reference's widths)
    cfg = get_config("granite-3-2b", reduced=True, n_layers=2, d_model=64, n_heads=2,
                     n_kv_heads=2, head_dim=32, d_ff=128, vocab_size=vocab)
    params0 = Mo.init(torch.Generator().manual_seed(seed), cfg, device="cpu")

    def loss(params, batch):
        return Mo.loss_fn(params, cfg, {"tokens": batch[0]})

    return (toks,), labels, params0, loss, "tiny-transformer(CIFAR-analogue)"


def _parts(arrays, labels, M: int, seed: int, split: str) -> np.ndarray:
    n = len(arrays[0])
    return pad_to_equal(random_split(n, M, seed=seed) if split == "random"
                        else split_by_label(labels, M, seed=seed))


def run_dsm(problem: Problem, topo: T.Topology, *, steps: int = 150, lr: float = 0.3,
            B: int = 16, seed: int = 0, split: str = "random", momentum: float = 0.0,
            collect_grad_stats: bool = False, device: str | torch.device = "cuda"):
    """Train with DSM (einsum gossip, as the reference) on a topology.

    Returns ``(losses, stats, parts)``: the global loss of the worker-mean
    parameters on the whole dataset after every step (a host float per
    step), the per-step ``(E, E_sp, √M·||ḡ||)`` when
    ``collect_grad_stats``, and the (M, local) index partition."""
    arrays, labels, params0, loss, _ = problem
    dev = resolve_device(device)
    M = topo.M
    parts = _parts(arrays, labels, M, seed, split)
    batcher = WorkerBatcher(arrays, parts, batch_size=B, seed=seed)
    opt = momentum_sgd(lr, momentum) if momentum else sgd(lr)
    step = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"),
                           mode="gossip")
    state = init_state(replicate_for_workers(to_device(params0, dev), M), opt)
    full = to_device(arrays, dev)
    losses, stats = [], []
    for _ in range(steps):
        state, m = step(state, to_device(batcher.next(), dev))
        with torch.no_grad():
            losses.append(float(loss(_tree.map(lambda v: v.mean(0), state.params), full)))
        if collect_grad_stats:
            stats.append((float(m.grad_energy), float(m.grad_spread),
                          float(m.mean_grad_norm)))
    return np.asarray(losses), stats, parts


def run_sim(problem: Problem, topo: T.Topology, *, rounds: int = 100, lr: float = 0.3,
            B: int = 16, seed: int = 0, protocol: str = "sync", scenario=None,
            eval_every: int = 1, device: str | torch.device = "cuda", **sim_kw):
    """Train ``problem`` on the event-driven simulator: the batching of
    :func:`run_dsm` (random split), real losses on a virtual clock. Returns
    the :class:`~repro_torch.train.loop.SimRun` (``eval_curve()`` gives the
    global loss against virtual time)."""
    from repro_torch.train.loop import run_simulated

    arrays, labels, params0, loss, _ = problem
    dev = resolve_device(device)
    M = topo.M
    batcher = WorkerBatcher(arrays, _parts(arrays, labels, M, seed, "random"),
                            batch_size=B, seed=seed)
    full = to_device(arrays, dev)

    def batches():
        while True:
            yield batcher.next()

    def eval_fn(p):
        with torch.no_grad():
            return float(loss(p, full))

    return run_simulated(
        loss, replicate_for_workers(to_device(params0, dev), M), sgd(lr), batches(),
        gossip=GossipSpec(topology=topo, backend="einsum"), protocol=protocol,
        scenario=scenario, rounds=rounds, eval_fn=eval_fn if eval_every else None,
        eval_every=eval_every, device=dev, **sim_kw)
