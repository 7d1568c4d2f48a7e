"""Training loop: drives the decentralized (or baseline) train step and logs
the paper's gradient statistics.

The port of the meshless path of the reference's ``repro/train/loop.py``:
:func:`train`, and :func:`run_simulated` with its :class:`RecoveryPolicy`,
which trains on the event-driven simulator (:mod:`repro_torch.sim`).
Metrics stay on the device and come to the host once per ``log_every``
window (plus the last step), one transfer for the whole window, so the
host queues steps ahead of the device instead of waiting on every step.
Checkpoints (``ckpt_path``) go through
:class:`~repro_torch.train.checkpoint.AsyncCheckpointWriter` every
``ckpt_every`` steps and after the last, at the reference's boundaries.
With a telemetry sink active, each metrics window is a ``train.window`` span
(its transfer a ``train.host_sync`` span) and bumps the ``train.steps`` and
``train.checkpoints`` counters and the ``train.loss`` gauge.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch import _tree, telemetry
from repro_torch.convert import resolve_device, to_device
from repro_torch.core.decentralized import (StepMetrics, TrainState, init_state,
                                            make_train_step)
from repro_torch.core.gossip import GossipSpec
from repro_torch.optim import Optimizer
from repro_torch.train import checkpoint as ckpt_lib

PyTree = Any

__all__ = ["History", "train", "RecoveryPolicy", "SimRun", "run_simulated"]


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

    def append(self, m: StepMetrics, dt: float) -> None:
        """One step's metrics (each field a host sync on a device tensor)."""
        self.loss.append(float(m.loss))
        self.grad_energy.append(float(m.grad_energy))
        self.grad_spread.append(float(m.grad_spread))
        self.mean_grad_norm.append(float(m.mean_grad_norm))
        self.param_spread.append(float(m.param_spread))
        self.step_time.append(dt)

    def as_arrays(self) -> dict[str, np.ndarray]:
        return {k: np.asarray(v) for k, v in dataclasses.asdict(self).items()}

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
    # Telemetry rides the metrics window: one emit batch per flush, nothing
    # per step; with the null sink the cost is one attribute check.
    tel = telemetry.get()

    def flush() -> None:
        nonlocal t_win
        n = len(pending)
        if tel.active and n:
            with tel.span("train.host_sync", steps=n):
                hist.extend_from_device(pending, t_win)
            dur = time.perf_counter() - t_win
            tel.complete("train.window", tel.now() - dur, dur, steps=n)
            tel.counter("train.steps", n)
            tel.gauge("train.loss", hist.loss[-1])
        else:
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
                tel.counter("train.checkpoints")
        flush()
        if ckpt_path:
            writer.save(ckpt_path, state.params, step=steps, sharded=ckpt_sharded)
            tel.counter("train.checkpoints")
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


# ---------------------------------------------------------------------------
# Event-driven simulated training (repro_torch.sim)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """How a simulated fleet responds to step failures and rejoins.

    A failed step attempt (the ``fault_inject`` hook of
    :func:`run_simulated`) is retried after exponential backoff
    (``backoff_base * backoff_factor**attempt`` virtual seconds) up to
    ``max_retries`` times; once retries exhaust, the worker's parameter
    slice is restored — from the consensus average of the last checkpoint
    when ``ckpt_path`` is set and one has landed, else from the live
    fleet's current mean — and the step proceeds from the restored state.
    Rejoining workers (churn JOIN events) restore the same way. With
    ``ckpt_path`` set, the stacked state is checkpointed through the
    :class:`~repro_torch.train.checkpoint.AsyncCheckpointWriter` every
    ``ckpt_every`` commits (sharded per worker when ``ckpt_sharded``).
    """

    max_retries: int = 3
    backoff_base: float = 0.5
    backoff_factor: float = 2.0
    ckpt_path: str | None = None
    ckpt_every: int = 10
    ckpt_sharded: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if not self.backoff_base > 0:
            raise ValueError(f"backoff_base must be positive, got {self.backoff_base}")
        if not self.backoff_factor >= 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got {self.backoff_factor}")
        if self.ckpt_every <= 0:
            raise ValueError(f"ckpt_every must be positive, got {self.ckpt_every}")


class _RecoveryManager:
    """Wires a :class:`RecoveryPolicy` into a sim protocol (its ``recovery``
    attribute): answers the per-attempt failure/backoff question, writes
    periodic consensus checkpoints, and restores failed/rejoining workers."""

    def __init__(self, policy: RecoveryPolicy, executor,
                 fault_inject: Callable[[int, int, int], bool] | None = None):
        self.policy = policy
        self.executor = executor
        self.fault_inject = fault_inject
        self.engine = None   # set by run_simulated once the Engine exists
        self.attempts: dict[tuple[int, int], int] = {}
        self.stats = {"step_failures": 0, "retries": 0, "restores": 0,
                      "rejoins": 0, "checkpoints": 0}
        self.writer = ckpt_lib.AsyncCheckpointWriter() if policy.ckpt_path else None
        self._saved_any = False
        self._commits = 0

    # -- protocol hooks ---------------------------------------------------

    def step_failure_delay(self, j: int, k: int) -> float | None:
        """None → the attempt proceeds; a float → this attempt failed,
        retry after that many virtual seconds. Exhausted retries restore
        worker j and let the attempt proceed from the restored state."""
        if self.fault_inject is None:
            return None
        a = self.attempts.get((j, k), 0)
        if not self.fault_inject(j, k, a):
            self.attempts.pop((j, k), None)
            return None
        self.stats["step_failures"] += 1
        a += 1
        self.attempts[(j, k)] = a
        if a <= self.policy.max_retries:
            self.stats["retries"] += 1
            return self.policy.backoff_base * self.policy.backoff_factor ** (a - 1)
        self.attempts.pop((j, k), None)
        self._restore(j)
        return None

    def after_commit(self, j: int, k: int) -> None:
        if self.writer is None:
            return
        self._commits += 1
        if self._commits % self.policy.ckpt_every == 0:
            self.writer.save(self.policy.ckpt_path, self.executor.W, step=k,
                             sharded=self.policy.ckpt_sharded)
            self._saved_any = True
            self.stats["checkpoints"] += 1

    def on_rejoin(self, j: int) -> None:
        self.stats["rejoins"] += 1
        self._restore(j)

    # -- restore ----------------------------------------------------------

    def _restore(self, j: int) -> None:
        """Overwrite worker j's slice with the latest consensus estimate:
        the worker-mean of the last sharded/monolithic checkpoint if one
        landed, else the live fleet's current mean (excluding j)."""
        self.stats["restores"] += 1
        ex = self.executor
        w = None
        if self.writer is not None and self._saved_any:
            self.writer.wait()   # the snapshot must be fully on disk
            like = _tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                             ex.W)
            w = ckpt_lib.consensus_params(
                ckpt_lib.restore(self.policy.ckpt_path, like, device=ex.device))
        if w is None:
            mask = np.asarray(self.engine.alive).copy()
            mask[j] = False
            if not mask.any():
                mask[:] = True
            w = ex.mean_params(mask)
        ex.W = ex.set_slice_(ex.W, j, w)

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


@dataclasses.dataclass
class SimRun:
    """Result of a simulated run: final stacked state + the event trace."""

    params: PyTree           # (M, ...) stacked parameters at the end
    opt_state: PyTree
    trace: Any               # repro_torch.sim.trace.Trace
    rounds: np.ndarray       # per-worker completed rounds
    virtual_time: float      # final virtual clock

    def loss_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(virtual times, per-round mean train-batch loss)."""
        return self.trace.round_loss_curve()

    def eval_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(virtual times, global loss of the worker-mean parameters)."""
        return self.trace.eval_curve()


def _meshless_payload_bytes(params_template: PyTree,
                            wire_dtype: str | None = None) -> int:
    """Per-message bytes of one whole-replica gossip payload: the bus
    layout plan's padded buffer for an unsharded replica (``wire_dtype``
    prices the compressed cross-pod lane of the same plan)."""
    from repro_torch.core.bus import plan_layout

    return plan_layout(params_template, lead_ndim=0).padded_bytes(wire_dtype)


def run_simulated(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    params0: PyTree,
    optimizer: Optimizer,
    batches: Iterable[PyTree],
    *,
    gossip: GossipSpec,
    protocol: str = "sync",
    scenario=None,
    mesh=None,
    rounds: int = 100,
    eval_fn: Callable[[PyTree], float] | None = None,
    eval_every: int = 1,
    max_events: int | None = None,
    max_time: float | None = None,
    trace_path: str | None = None,
    barrier_timeout: float | None = None,
    degrade_mode: str = "reabsorb",
    commit: str = "slice",
    commit_batch: bool = True,
    snap_depth: int = 4,
    dci_dtype: str | None = None,
    recovery: RecoveryPolicy | None = None,
    fault_inject: Callable[[int, int, int], bool] | None = None,
    health: "bool | object" = False,
    run_dir: str | None = None,
    device: str | torch.device = "cuda",
) -> SimRun:
    """Train under virtual wall-clocks on the discrete-event simulator.

    Executes *real* train steps on ``device`` — the sync protocol's
    ``commit='full'`` runs the very ``make_train_step`` program ``train()``
    runs — while the engine advances per-worker clocks through the
    scenario's straggler distribution, link delays, churn, and topology
    switches.

    Args:
      loss_fn / optimizer: as in :func:`train`.
      params0: stacked parameters with leading worker dim M
        (``replicate_for_workers``); copied to ``device``.
      batches: per-step batch iterable, leaves shaped (M, B, ...) — same
        contract as :func:`train`; replayed out-of-order via a cache for the
        asynchronous protocols, each batch moved to ``device`` once.
      gossip: GossipSpec (topology + mixing backend; runs meshless). With
        ``commit='full'``, ``backend='fused'`` mixes through the
        ``gossip_mix`` kernel.
      protocol: 'sync' | 'async' | 'stale' | 'hier'
        (see ``repro_torch.sim.protocols``).
      scenario: ``repro_torch.sim.Scenario`` (default: ideal unit-time world).
      mesh: makes the engine mesh-aware (two link classes): a
        ``sim.MeshSpec``, or the string ``'topology'`` to adopt a
        hierarchical (kronecker) topology's own pod assignment (per-message
        payload bytes from the bus layout plan over ``params0``). A device
        mesh of workers raises (ROADMAP queue 1, "Distributed").
      rounds: per-worker round budget (protocols stop scheduling past it).
      eval_fn: optional (mean-params tree) -> float global loss; recorded
        per round (sync/hier: every `eval_every` rounds when the whole round
        completes; async/stale: every `eval_every` completed computations).
      trace_path: if set, write the JSON event trace there.
      barrier_timeout / degrade_mode: makes the barrier protocols
        (sync/hier) churn-capable — a worker whose barrier stalls for
        `barrier_timeout` virtual seconds commits over the snapshots that
        arrived, with the survivor-repaired weight column (`degrade_mode`
        'reabsorb' | 'renormalize'). Fault-free runs are unaffected.
      commit / commit_batch / snap_depth: barrier-protocol commit
        architecture. ``commit='slice'`` (default) runs the O(M) per-slice
        step per completion, mixing over the round-tagged snapshot planes
        (``snap_depth`` deep, each a full stacked copy of the params); with
        ``commit_batch=True`` same-instant completions ride ONE vmapped
        per-slice step (disabled automatically when a recovery manager is
        attached). ``commit='full'`` runs the full M-row program per
        commit (required for ``adafactor_like``, whose factored second
        moment couples the workers).
      dci_dtype: 'bfloat16' | 'int8' | None — compress the cross-pod (DCI)
        stage of the ``hier`` protocol through the bus wire format with
        error feedback; with a mesh attached, DCI messages are charged the
        compressed wire bytes. ``None`` leaves the protocol exact.
      recovery / fault_inject: attach a :class:`RecoveryPolicy`.
        ``fault_inject(worker, round, attempt) -> bool`` marks a step
        attempt as failed (retried with backoff per the policy; restored
        from the last consensus checkpoint once retries exhaust). Passing
        either enables the recovery manager; its counters land in
        ``trace.meta['recovery']``.
      health: emit gossip-health gauges (spectral gap / effective number of
        neighbors of the ACTIVE mixing matrix) onto the trace timeline at
        t=0 and on every matrix-changing event. True for defaults, or a
        ``telemetry.HealthConfig``. Gauges are excluded from
        ``Trace.signature()``.
      run_dir: if set, export the telemetry bundle there — ``trace.json``
        (provenance-stamped meta), ``perfetto.json`` (Chrome-trace
        timeline), and ``telemetry.json`` when a telemetry sink is active.
        Summarize with ``python -m repro_torch.telemetry.report <run_dir>``.
      device: where the stacked state and the batches live.
    """
    from repro_torch import sim

    dev = resolve_device(device)
    proto_cls = sim.PROTOCOLS.get(protocol)
    if proto_cls is None:
        raise ValueError(f"unknown protocol {protocol!r}; "
                         f"choose from {sorted(sim.PROTOCOLS)}")
    proto_kw = {}
    if barrier_timeout is not None:
        if protocol not in ("sync", "hier"):
            raise ValueError(
                "barrier_timeout configures the barrier protocols "
                f"(sync/hier); protocol {protocol!r} has no barrier")
        proto_kw = dict(barrier_timeout=barrier_timeout,
                        degrade_mode=degrade_mode)
    if protocol in ("sync", "hier"):
        proto_kw.update(commit=commit, commit_batch=commit_batch,
                        snap_depth=snap_depth)
    elif commit != "slice":
        raise ValueError(
            "commit configures the barrier protocols (sync/hier); "
            f"protocol {protocol!r} has no commit mode")
    if dci_dtype is not None:
        if protocol != "hier":
            raise ValueError(
                "dci_dtype compresses the cross-pod (DCI) stage of the "
                f"hier protocol; protocol {protocol!r} has no DCI stage")
        proto_kw.update(dci_dtype=dci_dtype)
    if mesh is not None:
        template = _tree.map(
            lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"), params0)
        if isinstance(mesh, str) and mesh == "topology":
            mesh = sim.MeshSpec.from_topology(gossip.topology)
        mesh = sim.MeshSpec.ensure(mesh, gossip.topology)
        if not mesh.payload_bytes:
            # fill in the per-message wire bytes from the bus layout plan so
            # bandwidth terms and the per-class byte accounting are real
            mesh = dataclasses.replace(
                mesh, payload_bytes=_meshless_payload_bytes(template))
        if dci_dtype is not None and not mesh.dci_payload_bytes:
            # cross-pod messages ship the quantized image: charge the
            # compressed wire bytes (same plan, wire pricing) on DCI links
            mesh = dataclasses.replace(
                mesh, dci_payload_bytes=_meshless_payload_bytes(template, dci_dtype))
    executor = sim.TrainExecutor(loss_fn, optimizer,
                                 _tree.map(lambda x: x.to(dev), params0),
                                 batches, gossip, commit=commit)
    if executor.coupled and protocol == "hier":
        raise ValueError(
            "the hier protocol commits per worker slice in both commit "
            "modes (its commit='full' only changes the mix-source "
            "assembly), so optimizers with cross-worker-coupled state "
            "cannot run on it. Use protocol='sync' with commit='full', or "
            "a worker-elementwise optimizer.")
    proto = proto_cls(executor=executor, eval_fn=eval_fn,
                      eval_every=eval_every, **proto_kw)
    mgr = None
    if recovery is not None or fault_inject is not None:
        mgr = _RecoveryManager(recovery or RecoveryPolicy(), executor, fault_inject)
        proto.recovery = mgr
    eng = sim.Engine(gossip.topology, scenario, mesh=mesh, health=health)
    if mgr is not None:
        mgr.engine = eng
    try:
        eng.run(proto, until_round=rounds, max_events=max_events, max_time=max_time)
    finally:
        if mgr is not None:
            mgr.close()
    tel = telemetry.get()
    if mgr is not None:
        eng.trace.meta["recovery"] = dict(mgr.stats)
        if tel.active:
            for k, v in mgr.stats.items():
                tel.counter(f"recovery.{k}", v)
    if trace_path:
        eng.trace.save(trace_path)
    if run_dir:
        from repro_torch.telemetry.perfetto import save_perfetto

        eng.trace.meta["provenance"] = telemetry.provenance(
            config=dict(protocol=protocol, rounds=rounds,
                        topology=gossip.topology.name,
                        M=gossip.topology.M,
                        scenario=eng.scenario.describe()),
            writer="run_simulated")
        eng.trace.save(os.path.join(run_dir, "trace.json"))
        save_perfetto(eng.trace, os.path.join(run_dir, "perfetto.json"))
        if tel.active:
            tel.save(os.path.join(run_dir, "telemetry.json"))
    return SimRun(params=executor.W, opt_state=executor.opt, trace=eng.trace,
                  rounds=proto.rounds.copy(), virtual_time=eng.clock)
