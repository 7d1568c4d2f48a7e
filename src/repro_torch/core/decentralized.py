"""Decentralized (consensus-based) training step — the paper's eq. (3).

    w_j(k+1) = Σ_{i∈N_j∪{j}} A_{i,j} w_i(k)  −  η(k) g_j(w_j(k))

The port of the reference's ``repro/core/decentralized.py``.

* gossip mode: every parameter leaf carries a leading worker dim of size M.
  The per-worker gradient is ``torch.func.vmap`` of ``grad_and_value`` over
  that dim (workers are data-parallel replicas with different params), the
  optimizer update is elementwise, and the consensus mix is the only
  cross-worker step (:mod:`repro_torch.core.gossip`). With the ``fused``
  backend and ``mix_first``, mix and update are one pass of the gossip_mix
  kernel over the flat bus.
* allreduce mode: the centralized baseline (one param copy, the whole
  batch), which the paper compares against.

On a live worker mesh (``mesh=``, a ``launch.mesh.WorkerMesh`` or its
``DeviceMesh``) each rank holds its own workers' whole replicas (a worker
dim of ``M / n_workers``, ``launch.shardings.local_tree`` of the global
tree) and their batches; the mix exchanges with the neighbours on other
ranks, and :class:`StepMetrics` are global over all M workers (sums over
the rank's workers, all-reduced over the worker groups). In allreduce mode
the params are replicated and the batch is cut over the worker axes; the
gradient is all-reduced as a mean, which is the whole batch's gradient for
a loss that is a mean over rows. A layer that couples the rows of a call
(an MoE layer routing the whole call, ``moe_dispatch='global'``) computes
it over the whole batch with collectives over the worker groups
(``launch.mesh.rows_cut_over``, ``layers._route_logits``): its aux loss
is the whole batch's on every rank, and its gradient reaches each rank
scaled so that the mean over ranks is the whole batch's. With
``microbatch > 1`` such a layer refuses: the reference's microbatches are
chunks of the global batch's rows, which cut across the ranks' rows.

With a model axis (``model_factor`` k > 1) a rank holds its 1/k shard of
every leaf that ``param_specs`` shards over it (and the rest whole) and its
workers' whole batches; the gradient runs inside
``launch.mesh.model_parallel``, where every family's layers (dense, MoE,
MLA, the encoder-decoder, Mamba-2 and RG-LRU) compute on their shards with
collectives over the model group (``launch.tensor_parallel``). The metrics sum a sharded leaf's squares over the
model group and count a replicated leaf once.

``microbatch > 1`` accumulates the gradient over that many chunks of the
per-worker batch in float32 (:func:`_microbatched`). A spec with
``time_varying='one_peer_exp'`` mixes step k with round ``k % log2 M`` of the
one-peer graph (fused: one k = 1 ``gossip_mix`` pass per dtype group). As
in the reference, adapt-then-combine (``mix_first=False``) with
``period == 1`` mixes with the spec's static topology even then.

``TrainState.step`` is a Python int, so the step count, the gossip period,
the time-varying round and the learning-rate schedule never wait on the
device.

With a telemetry sink active (:mod:`repro_torch.telemetry`) a step is a
``train.step`` span holding ``train.grad`` (the gradient: forward, backward
and remat's recompute), ``train.forward`` (the loss function inside the
gradient's transforms, so the backward, which autograd runs after it
returns, stays in ``train.grad``'s own time), ``train.optim`` (the
optimizer's update) and ``train.stats`` (:func:`step_metrics`); the mix
adds the bus's spans and counters (:func:`repro_torch.core.bus.mix_bus`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch import _tree, telemetry
from repro_torch.core import bus
from repro_torch.core import gossip as gossip_lib
from repro_torch.core.gossip import GossipSpec
from repro_torch.launch import cost
from repro_torch.launch.mesh import model_parallel, rows_cut_over
from repro_torch.launch.tensor_parallel import ModelCut, model_cut
from repro_torch.optim import Optimizer

PyTree = Any

__all__ = ["TrainState", "StepMetrics", "init_state", "replicate_for_workers",
           "gradient_stats", "param_spread", "step_metrics", "make_train_step"]


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


def _sq_norms(leaves, cut: ModelCut | None) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σ ||x||² over the leaves ``cut`` shards over the model axis, Σ over
    the others), float32: the first is this rank's part of a sum over the
    model group; without a cut every leaf is whole."""
    z = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    parts = [z, z]
    for x, sharded in zip(leaves, cut.sharded if cut is not None else (False,) * len(leaves)):
        i = 0 if sharded else 1
        parts[i] = parts[i] + torch.sum(torch.square(x.float()))
    return parts[0], parts[1]


def _model_sum(parts, cut: ModelCut | None) -> torch.Tensor:
    """Sums whose ``parts`` are (sharded, whole) pairs of float32 scalars
    (:func:`_sq_norms`): the sharded parts all-reduced over the model
    group (one all-reduce), the whole parts added once."""
    sharded = torch.stack([p[0] for p in parts])
    if cut is not None:
        sharded = _all_sum(sharded, [cut.group])
    return sharded + torch.stack([p[1] for p in parts])


def _all_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """``x`` summed in place over the worker groups, one all-reduce per
    worker axis of more than one rank; no collective without groups
    (meshless)."""
    import torch.distributed as dist

    for group in groups:
        if dist.get_world_size(group) > 1:
            dist.all_reduce(x, group=group)
            cost.record_collective("all-reduce", x.numel() * x.element_size(), group)
    return x


def _spread(tree: PyTree, M: int, groups, cut: ModelCut | None = None):
    """(Σ_j ||x_j − x̄||² over this process's workers, ||x̄||²) of a
    worker-stacked tree, each as a :func:`_sq_norms` pair (over the
    leaves ``cut`` shards over the model axis, over the others). x̄ is
    the float32 sum over all M workers ÷ M, rounded to each leaf's dtype
    as the reference's mean is: the rank's sums of every leaf land in one
    flat float32 buffer, which one all-reduce over ``groups`` completes
    (4 bytes per element of the rank's part of a replica). The squares sum
    in float32."""
    leaves = _tree.leaves(tree)
    sizes = [x[0].numel() for x in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=leaves[0].device)
    means = [v.view(x.shape[1:]) for x, v in zip(leaves, flat.split(sizes))]
    for x, v in zip(leaves, means):
        torch.sum(x, 0, dtype=torch.float32, out=v)
    _all_sum(flat, groups).div_(M)
    flags = cut.sharded if cut is not None else (False,) * len(leaves)
    z = torch.zeros((), dtype=torch.float32, device=flat.device)
    spread, mean_sq = [z, z], [z, z]
    for x, v, sharded in zip(leaves, means, flags):
        mean, i = v.to(x.dtype), 0 if sharded else 1
        spread[i] = spread[i] + torch.sum(torch.square((x - mean).float()))
        mean_sq[i] = mean_sq[i] + torch.sum(torch.square(mean.float()))
    return tuple(spread), tuple(mean_sq)



def gradient_stats(grads_M: PyTree) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(E, E_sp, √M·||ḡ||₂) of per-worker gradients (leading worker dim M),
    float32 scalars: the terms :func:`step_metrics` reports, meshless."""
    M = _tree.leaves(grads_M)[0].shape[0]
    E_sp, mean_sq = _spread(grads_M, M, ())
    return _sq_norms(_tree.leaves(grads_M), None)[1], E_sp[1], torch.sqrt(M * mean_sq[1])


def param_spread(params_M: PyTree) -> torch.Tensor:
    """The consensus spread Σ_j ||w_j − w̄||² of worker-stacked params."""
    return _spread(params_M, _tree.leaves(params_M)[0].shape[0], ())[0][1]

def step_metrics(losses: torch.Tensor, grads_M: PyTree, params_M: PyTree, M: int,
                 groups=(), compute_stats: bool = True,
                 cut: ModelCut | None = None) -> StepMetrics:
    """The gossip step's :class:`StepMetrics` over all M workers, from this
    process's per-worker losses, gradients and new params (leading worker
    dim: all M, or a rank's own on a mesh, whose ``groups`` are the worker
    axes' process groups). The loss is the mean over the M workers,
    E = Σ_j ||g_j||², E_sp = Σ_j ||g_j − ḡ||², H = √M·||ḡ||₂ and the
    consensus spread Σ_j ||w_j − w̄||²: sums over the rank's workers,
    all-reduced. With a model axis (``cut``, ``launch.tensor_parallel``) a
    leaf sharded over it sums its squares over the model group and a
    replicated one counts once; the loss is every model rank's own.
    ``compute_stats=False`` leaves E, E_sp, H and the spread float32
    zeros."""
    loss_sum = losses.sum(dtype=torch.float32)
    if not compute_stats:
        z = torch.zeros((), dtype=torch.float32, device=losses.device)
        return StepMetrics(_all_sum(loss_sum.reshape(1), groups)[0] / M, z, z, z, z)
    E = _sq_norms(_tree.leaves(grads_M), cut)
    E_sp, mean_g_sq = _spread(grads_M, M, groups, cut)
    spread, _ = _spread(params_M, M, groups, cut)
    E, E_sp, mean_g_sq, spread = _model_sum([E, E_sp, mean_g_sq, spread], cut)
    sums = _all_sum(torch.stack([loss_sum, E, E_sp, spread]), groups)
    return StepMetrics(sums[0] / M, sums[1], sums[2], torch.sqrt(M * mean_g_sq), sums[3])


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


def _step_mesh(mesh, param_specs):
    """The live WorkerMesh a step runs on (None meshless); a model axis
    needs the ``param_specs`` that cut the replica over it."""
    if mesh is None:
        return None
    wm = bus._live(mesh)
    if wm.model_factor > 1 and param_specs is None:
        raise ValueError(f"a train step over {wm.describe()} needs the param_specs that "
                         "cut each replica over the model axis (shardings.param_pspecs)")
    return wm


def _mean_over_ranks(x: torch.Tensor, groups, n: int) -> torch.Tensor:
    """The mean of ``x`` over the ``n`` ranks of the worker groups, summed
    in float32 and cast back to ``x``'s dtype."""
    if not groups:
        return x
    return (_all_sum(x.float().reshape(-1), groups).reshape(x.shape) / n).to(x.dtype)


def make_train_step(
    loss_fn: Callable[[PyTree, PyTree], torch.Tensor],
    optimizer: Optimizer,
    gossip: GossipSpec | None = None,
    mode: str = "gossip",
    mesh=None,
    compute_stats: bool = True,
    mix_first: bool = True,
    microbatch: int = 1,
    param_specs: Any = None,
):
    """Build the train step ``step(state, batch) -> (state, StepMetrics)``.

    Args:
      loss_fn: (params, batch) -> scalar loss for ONE worker (no leading M).
      optimizer: a repro_torch.optim Optimizer.
      gossip: GossipSpec (required for mode='gossip').
      mode: 'gossip' | 'allreduce'.
      mesh: a live ``launch.mesh.WorkerMesh`` (or its ``DeviceMesh``).
        Gossip mode: the state and batch are this rank's workers'
        (``launch.shardings.local_tree``), the mix exchanges with the other
        ranks and the metrics are global. Allreduce mode: the params are
        replicated over the worker axes, the batch is this rank's cut of
        the global batch (``shardings.batch_pspecs``) and the gradient is
        all-reduced as a mean over the worker groups; a globally routed MoE
        layer routes over the whole batch. At model factor k > 1 the
        params are also cut over the model axis by ``param_specs``
        (required there), every model rank of a worker group sees the
        group's whole batch, and the layers run tensor parallel (module
        docstring).
      compute_stats: gossip mode only; False skips the step's E, E_sp, H
        and consensus spread, which are then float32 zeros (the loss stays).
      mix_first: paper's eq. (3) mixes the current params and subtracts the
        gradient taken at the current local params (True). False gives the
        adapt-then-combine variant — mix(w - η g).
      microbatch: gradient-accumulation factor over the per-worker batch.
      param_specs: per-leaf PartitionSpecs of the (worker-stacked) params —
        ``shardings.param_pspecs`` output; the gossip backends take them.
    """
    # torch.func imports torch._dynamo inside the first gradient; an
    # exception caught during that import leaves a traceback cycle that holds
    # the first step's tensors until the cyclic collector runs. Importing it
    # here, before any step, keeps the first step free of cycles.
    import torch._dynamo  # noqa: F401

    if mode == "fsdp":
        raise ValueError(
            "the 'fsdp' train mode is retired: shard the replica over the "
            "WorkerMesh model axis instead (mode='gossip' with param_specs "
            "from shardings.param_pspecs — see launch/mesh.WorkerMesh)")
    if mode not in ("gossip", "allreduce"):
        raise ValueError(f"unknown mode {mode!r}")
    wm = _step_mesh(mesh, param_specs)
    groups = wm.worker_groups if wm is not None else []

    def forward(params, batch):
        with telemetry.get().span("train.forward"):
            return loss_fn(params, batch)

    def cut_of(tree) -> ModelCut | None:
        return model_cut(param_specs, _tree.flatten(tree)[1], wm)

    if mode == "gossip":
        if gossip is None:
            raise ValueError("gossip mode requires a GossipSpec")
        M = gossip.topology.M
        # mix + update in ONE kernel pass over the flat bus (mix_first only:
        # adapt-then-combine needs the update applied before the mix; a
        # hierarchical spec runs two staged mixes, then adds the update)
        fuse_update = (gossip.resolved_backend() == "fused" and mix_first
                       and not gossip.hierarchical)
        vg = torch.func.vmap(torch.func.grad_and_value(forward))
        if microbatch > 1:
            vg = _microbatched(vg, microbatch, batch_axis=1)
        if gossip.time_varying:
            gossip.one_peer_specs   # build the rounds' specs once, here

        def step(state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
            tel = telemetry.get()
            with tel.span("train.step"):
                return _step(tel, state, batch)

        def _step(tel, state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
            # batch leaves: (M, per_worker_batch, ...), this rank's workers on a mesh
            with tel.span("train.grad"), model_parallel(wm):
                grads, losses = vg(state.params, batch)
            cut = cut_of(state.params)
            with torch.no_grad():
                with tel.span("train.optim"):
                    updates, opt_state = optimizer.update(
                        grads, state.opt_state, state.params, state.step,
                        cuts=groups or None, model=cut)
                mix_now = state.step % gossip.period == 0

                def do_mix(p):
                    if gossip.time_varying:
                        return gossip_lib.mix_pytree_time_varying(
                            p, gossip, state.step, wm, param_specs=param_specs)
                    return gossip_lib.mix_pytree(p, gossip, wm, param_specs=param_specs)

                if fuse_update:
                    # updates already carry −lr ⇒ eta = −1 gives mix(p) + u
                    if not mix_now:
                        new_params = _add_updates(state.params, updates)
                    elif gossip.time_varying:
                        new_params = bus.mix_and_update_time_varying(
                            state.params, gossip, updates, state.step, wm, eta=-1.0,
                            param_specs=param_specs)
                    else:
                        new_params = bus.mix_bus(state.params, gossip, wm, updates=updates,
                                                 eta=-1.0, param_specs=param_specs)
                elif mix_first:
                    mixed = do_mix(state.params) if mix_now else state.params
                    new_params = _add_updates(mixed, updates)
                else:
                    stepped = _add_updates(state.params, updates)
                    if gossip.period == 1:
                        # the reference's quirk: the static topology, even
                        # under time_varying (ROADMAP queue 3)
                        new_params = gossip_lib.mix_pytree(stepped, gossip, wm,
                                                           param_specs=param_specs)
                    else:
                        new_params = do_mix(stepped) if mix_now else stepped
                with tel.span("train.stats"):
                    metrics = step_metrics(losses, grads, new_params, M, groups,
                                           compute_stats, cut)
            return TrainState(state.step + 1, new_params, opt_state), metrics

        return step

    # allreduce: the centralized equivalent, a single param copy over the
    # whole batch (on a mesh, this rank's cut of it)
    vg = torch.func.grad_and_value(forward)
    if microbatch > 1:
        vg = _microbatched(vg, microbatch, batch_axis=0)
    n = wm.n_workers if wm is not None else 1

    def step(state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
        tel = telemetry.get()
        with tel.span("train.step"):
            return _step(tel, state, batch)

    def _step(tel, state: TrainState, batch: PyTree) -> tuple[TrainState, StepMetrics]:
        with tel.span("train.grad"), rows_cut_over(wm, microbatch), model_parallel(wm):
            grads, loss = vg(state.params, batch)
        cut = cut_of(state.params)
        with torch.no_grad():
            grads = _tree.map(lambda g: _mean_over_ranks(g, groups, n), grads)
            loss = _mean_over_ranks(loss, groups, n)
            with tel.span("train.optim"):
                updates, opt_state = optimizer.update(
                    grads, state.opt_state, state.params, state.step, model=cut)
            new_params = _add_updates(state.params, updates)
            with tel.span("train.stats"):
                z = torch.zeros((), device=loss.device)
                gn = _model_sum([_sq_norms(_tree.leaves(grads), cut)], cut)[0]
        metrics = StepMetrics(loss, gn, z, torch.sqrt(gn), z)
        return TrainState(state.step + 1, new_params, opt_state), metrics

    return step
