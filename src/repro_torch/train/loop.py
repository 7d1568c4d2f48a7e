"""Training loop: drives the decentralized (or baseline) train step and logs
the paper's gradient statistics.

The port of the meshless path of the reference's ``repro/train/loop.py``.
Metrics stay on the device and come to the host once per ``log_every``
window (plus the last step), one transfer for the whole window, so the
host queues steps ahead of the device instead of waiting on every step.
Checkpoints (``ckpt_path``) go through
:class:`~repro_torch.train.checkpoint.AsyncCheckpointWriter` every
``ckpt_every`` steps and after the last, at the reference's boundaries.
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
from repro_torch.train import checkpoint as ckpt_lib

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
    # seconds each checkpoint write took on the writer's thread
    ckpt_write_s: list[float] = dataclasses.field(default_factory=list)

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
    ckpt_every: int = 0,
    ckpt_sharded: bool = False,
    device: str | torch.device = "cuda",
    verbose: bool = True,
) -> tuple[TrainState, History]:
    """Run ``steps`` iterations; ``batches`` yields per-step batch trees
    (numpy arrays or tensors), which are moved to ``device`` with the
    params. Returns the final state and the History.

    With ``ckpt_path``, ``state.params`` is saved after every
    ``ckpt_every``-th step (0: only at the end) and after the last, each
    save preceded by a metrics flush, through the asynchronous writer;
    ``ckpt_sharded`` writes one file per worker
    (``checkpoint.save_sharded``). A writer error surfaces when the loop
    ends, but never masks the loop's own exception."""
    dev = resolve_device(device)
    step_fn = make_train_step(loss_fn, optimizer, gossip=gossip, mode=mode)
    params0 = _tree.map(lambda x: x.to(dev, copy=True), params0)
    state = init_state(params0, optimizer)
    hist = History()
    it = iter(batches)
    pending: list[StepMetrics] = []
    t_win = time.perf_counter()

    def flush() -> None:
        nonlocal t_win
        hist.extend_from_device(pending, t_win)
        pending.clear()
        t_win = time.perf_counter()

    writer = ckpt_lib.AsyncCheckpointWriter() if ckpt_path else None
    try:
        for k in range(steps):
            state, metrics = step_fn(state, to_device(next(it), dev))
            pending.append(metrics)
            if k % log_every == 0 or k == steps - 1:
                flush()
                if verbose:
                    print(f"step {k:5d}  loss {hist.loss[-1]:.5f}  "
                          f"E {hist.grad_energy[-1]:.3e}  Esp {hist.grad_spread[-1]:.3e}  "
                          f"spread {hist.param_spread[-1]:.3e}")
            if ckpt_path and ckpt_every and (k + 1) % ckpt_every == 0:
                flush()
                writer.save(ckpt_path, state.params, step=k + 1, sharded=ckpt_sharded)
        flush()
        if ckpt_path:
            writer.save(ckpt_path, state.params, step=steps, sharded=ckpt_sharded)
        if writer is not None:
            writer.close()        # surfaces background write errors
            hist.ckpt_write_s = list(writer.write_seconds)
    except BaseException:
        # the loop is already failing: drain the writer, but a secondary
        # checkpoint error must not mask the real exception
        if writer is not None:
            try:
                writer.close()
            except Exception:
                pass
        raise
    return state, hist
