"""Training loop: drives the decentralized (or baseline) train step and logs
the paper's gradient statistics.

The port of the meshless path of the reference's ``repro/train/loop.py``.
Metrics stay on the device and come to the host once per ``log_every``
window (plus the last step), one transfer for the whole window, so the
host queues steps ahead of the device instead of waiting on every step.
Checkpointing is a later slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device, to_device
from repro_torch.core.decentralized import (StepMetrics, TrainState, init_state,
                                            make_train_step)
from repro_torch.core.gossip import GossipSpec
from repro_torch.optim import Optimizer

PyTree = Any

__all__ = ["History", "train"]


@dataclasses.dataclass
class History:
    loss: list[float] = dataclasses.field(default_factory=list)
    grad_energy: list[float] = dataclasses.field(default_factory=list)
    grad_spread: list[float] = dataclasses.field(default_factory=list)
    mean_grad_norm: list[float] = dataclasses.field(default_factory=list)
    param_spread: list[float] = dataclasses.field(default_factory=list)
    step_time: list[float] = dataclasses.field(default_factory=list)

    def extend_from_device(self, pending: list[StepMetrics],
                           window_start: float) -> None:
        """One device→host transfer for a whole log window; the window is
        clocked after it, so the per-step time covers execution, not just
        the host queueing the work."""
        if not pending:
            return
        host = torch.stack([torch.stack([f.float() for f in m])
                            for m in pending]).cpu().numpy()
        dt = (time.perf_counter() - window_start) / len(pending)
        for row in host:
            for name, v in zip(StepMetrics._fields, row):
                getattr(self, name).append(float(v))
            self.step_time.append(dt)


def train(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    params0: PyTree,
    optimizer: Optimizer,
    batches: Iterable[PyTree],
    *,
    steps: int,
    gossip: GossipSpec | None = None,
    mode: str = "gossip",
    log_every: int = 50,
    ckpt_path: str | None = None,
    device: str | torch.device = "cuda",
    verbose: bool = True,
) -> tuple[TrainState, History]:
    """Run ``steps`` iterations; ``batches`` yields per-step batch trees
    (numpy arrays or tensors), which are moved to ``device`` with the
    params. Returns the final state and the History."""
    if ckpt_path is not None:
        raise NotImplementedError(
            "checkpointing is not ported yet (ROADMAP queue 1, item 8)")
    dev = resolve_device(device)
    step_fn = make_train_step(loss_fn, optimizer, gossip=gossip, mode=mode)
    params0 = _tree.map(lambda x: x.to(dev, copy=True), params0)
    state = init_state(params0, optimizer)
    hist = History()
    it = iter(batches)
    pending: list[StepMetrics] = []
    t_win = time.perf_counter()
    for k in range(steps):
        state, metrics = step_fn(state, to_device(next(it), dev))
        pending.append(metrics)
        if k % log_every == 0 or k == steps - 1:
            hist.extend_from_device(pending, t_win)
            pending.clear()
            t_win = time.perf_counter()
            if verbose:
                print(f"step {k:5d}  loss {hist.loss[-1]:.5f}  "
                      f"E {hist.grad_energy[-1]:.3e}  Esp {hist.grad_spread[-1]:.3e}  "
                      f"spread {hist.param_spread[-1]:.3e}")
    return state, hist
