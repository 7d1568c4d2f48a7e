"""What one eager call costs a rank: FLOPs, bytes, peak live bytes, the
hand-written kernels' work and the collectives it issues.

The counterpart of the reference's ``repro/launch/hlo_cost.py``. The
reference compiles a step ahead of time and reads the cost out of XLA's HLO
text: dot FLOPs, operand and result bytes, collective payloads, each
multiplied by the trip count of the ``while`` loop around it. Torch runs a
step eagerly and writes no such text, so nothing here parses HLO.
:func:`measure` runs the call itself, on whatever device its inputs are on
(``meta`` tensors for a dry run without a card, CUDA tensors on the card),
and counts at the call layer, every op as it is dispatched, so a Python
loop counts once per turn it takes and needs no trip count:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` (products:
  matmuls, convolutions, attention), plus the FLOPs of the hand-written
  product kernels (flash attention).
* **Bytes**: every aten op's input and output bytes; a view, an
  allocation (``empty``) and a collective move none.
* **Peak live bytes**: every storage alive during the call, the inputs'
  included, from its first sight to its release; the port's counterpart of
  XLA's ``memory_analysis``.
* **Kernels**: a hand-written kernel launches through ``ctypes``, which no
  dispatch mode sees, so each wrapper reports its own work
  (:func:`record_kernel`), the figures its bound uses, on ``meta`` and on
  the card alike; its bytes add to the call's.
* **Collectives**: the port's nine call sites report each call
  (:func:`record_collective`): its kind, its result bytes on this rank and
  the global ranks of its group (of a permute, its pairs). One
  ``batch_isend_irecv`` is one ``collective-permute``, as one
  ``lax.ppermute`` is in the reference. The dispatch mode also counts the
  ``c10d`` ops it sees, so a collective issued without a report shows as a
  ``c10d`` op no event accounts for (:meth:`Cost.unreported_c10d`).

:func:`permute_link_classes` classifies each permute by its pairs' mesh
coordinates, as the reference's does from ``source_target_pairs``.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable

import numpy as np
import torch

__all__ = ["COLLECTIVES", "Collective", "KernelWork", "Cost", "measure", "record_kernel",
           "record_collective", "permute_link_classes"]

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# aten ops that allocate and move nothing
_ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided", "new_empty",
                          "new_empty_strided"))


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective call as a rank issues it.

    ``nbytes`` is its result's bytes on this rank (the reference's
    convention: an all-gather's whole gathered result, a permute's received
    buffers); ``ranks`` the global ranks of its group, of a permute every
    rank its pairs touch; ``pairs`` a permute's (source, destination)
    global ranks; ``c10d_ops`` the ``c10d`` ops the call dispatches (a
    permute's sends and receives of this rank)."""

    kind: str
    nbytes: int
    ranks: tuple[int, ...]
    pairs: tuple[tuple[int, int], ...] = ()
    c10d_ops: int = 1


@dataclasses.dataclass(frozen=True)
class KernelWork:
    """One call of a hand-written kernel: its operations and the bytes it
    must move (each input read once, each output written once); with
    ``products`` its operations are FLOPs of products (tensor-core work)."""

    name: str
    ops: float
    nbytes: float
    products: bool = False


@dataclasses.dataclass(eq=False)
class Cost:
    """A call's cost on this rank (:func:`measure`)."""

    flops: float = 0.0
    bytes: float = 0.0
    peak_bytes: int = 0
    kernels: list = dataclasses.field(default_factory=list)
    collectives: list = dataclasses.field(default_factory=list)
    c10d_ops: dict = dataclasses.field(default_factory=dict)
    seconds: float = 0.0

    def kernel_events(self, name: str) -> int:
        return sum(1 for k in self.kernels if k.name == name)

    def unreported_c10d(self) -> int:
        """``c10d`` ops seen minus those the recorded collectives account
        for: 0 when every collective call site reported its call."""
        return sum(self.c10d_ops.values()) - sum(c.c10d_ops for c in self.collectives)


# the recorders of the measure() calls running now, innermost last. Kept for
# the process, not the context: a backward pass on the card runs on the
# autograd engine's device thread while the caller waits.
_ACTIVE: list = []


def record_kernel(name: str, work: Callable[[], tuple[float, float]], *,
                  products: bool = False) -> None:
    """A kernel wrapper's report of one call (on ``meta``, or one launch on
    the card) to every :func:`measure` running now: ``work()`` gives its
    (operations, bytes), and is called only while one runs."""
    if _ACTIVE:
        ops, nbytes = work()
        event = KernelWork(name, float(ops), float(nbytes), products)
        for rec in _ACTIVE:
            rec.kernels.append(event)


def _group_ranks(group) -> tuple[int, ...]:
    import torch.distributed as dist

    if group is None or group == dist.group.WORLD:
        return tuple(range(dist.get_world_size()))
    return tuple(int(r) for r in dist.get_process_group_ranks(group))


def record_collective(kind: str, nbytes: int, group=None, *, pairs=None,
                      c10d_ops: int = 1) -> None:
    """A collective call site's report of one call to every :func:`measure`
    running now: ``group`` its process group (None: the world); a permute
    gives its global (source, destination) ``pairs`` instead."""
    if not _ACTIVE:
        return
    if kind not in COLLECTIVES:
        raise ValueError(f"unknown collective kind {kind!r}")
    if pairs is not None:
        pairs = tuple((int(s), int(d)) for s, d in pairs)
        ranks = tuple(sorted({r for pr in pairs for r in pr}))
    else:
        pairs, ranks = (), _group_ranks(group)
    event = Collective(kind, int(nbytes), ranks, pairs, int(c10d_ops))
    for rec in _ACTIVE:
        rec.collectives.append(event)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _Storages:
    """Live storages and their bytes, each counted from first sight to its
    release (a weak reference's callback); the peak of their sum."""

    def __init__(self):
        self.live: dict[int, int] = {}
        self.refs: dict[int, Any] = {}
        self.total = self.peak = 0

    def see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self.live:
            return
        n = st.nbytes()
        self.live[key] = n
        self.refs[key] = weakref.ref(st, lambda _r, key=key: self._release(key))
        self.total += n
        self.peak = max(self.peak, self.total)

    def _release(self, key: int) -> None:
        self.total -= self.live.pop(key, 0)
        self.refs.pop(key, None)


def _counter_mode(cost: Cost, storages: _Storages):
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Counter(TorchDispatchMode):
        """Adds up each aten op's input and output bytes, counts the c10d
        ops, and tracks the storages the ops return."""

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.namespace == "c10d":
                name = func.__name__.split(".")[0]
                cost.c10d_ops[name] = cost.c10d_ops.get(name, 0) + 1
                return out
            outs = _tensors(out)
            for t in outs:
                storages.see(t)
            if not func.is_view and func.__name__.split(".")[0] not in _ALLOCATIONS:
                cost.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)) + outs)
            return out

    return _Counter()


def measure(fn: Callable, *args, **kw) -> tuple[Any, Cost]:
    """Run ``fn(*args, **kw)`` eagerly and count what it costs this rank
    (module docstring): ``(its result, a Cost)``. The storages of every
    tensor in ``args`` and ``kw`` count as live from the start; ``seconds``
    is the host's time for the call (on the card: until it synchronizes)."""
    from torch.utils.flop_counter import FlopCounterMode

    cost, storages = Cost(), _Storages()
    for t in _tensors((args, kw)):
        storages.see(t)
    _ACTIVE.append(cost)
    t0 = time.perf_counter()
    try:
        with FlopCounterMode(display=False) as flops, _counter_mode(cost, storages):
            out = fn(*args, **kw)
        if any(t.is_cuda for t in _tensors((args, kw, out))):
            torch.cuda.synchronize()
    finally:
        _ACTIVE.remove(cost)
    cost.seconds = time.perf_counter() - t0
    cost.flops = float(flops.get_total_flops()) + sum(
        k.ops for k in cost.kernels if k.products)
    cost.bytes += sum(k.nbytes for k in cost.kernels)
    cost.peak_bytes = storages.peak
    return out, cost


def permute_link_classes(cost: Cost, mesh, pod_axis: str = "pod") -> dict:
    """Classify every recorded collective-permute as ``ici`` (every
    non-self pair stays within one pod), ``dci`` (every non-self pair
    crosses pods and keeps every other coordinate: it rides the pod axis
    alone) or ``mixed`` (anything else), from its pairs' coordinates on the
    live ``mesh`` (a WorkerMesh or its DeviceMesh), as the reference's
    ``hlo_cost.permute_link_classes`` classifies ``source_target_pairs``.
    The names are the reference's: within a pod and between pods."""
    from repro_torch.launch.mesh import WorkerMesh

    dm = WorkerMesh.raw(mesh)
    names = tuple(dm.mesh_dim_names or ())
    if pod_axis not in names:
        raise ValueError(f"mesh has no {pod_axis!r} axis: {names}")
    pod_i = names.index(pod_axis)
    grid = dm.mesh.cpu().numpy()
    where = {int(r): c for c, r in np.ndenumerate(grid)}
    out = {"ici": 0, "dci": 0, "mixed": 0, "ops": []}
    for ev in cost.collectives:
        if ev.kind != "collective-permute":
            continue
        classes = set()
        for s, t in ev.pairs:
            if s == t:
                continue
            sc, tc = where[s], where[t]
            others_fixed = all(a == b for i, (a, b) in enumerate(zip(sc, tc)) if i != pod_i)
            if sc[pod_i] == tc[pod_i]:
                classes.add("ici")
            elif others_fixed:
                classes.add("dci")
            else:
                classes.add("mixed")
        if not classes:
            continue
        cls = classes.pop() if len(classes) == 1 else "mixed"
        out[cls] += 1
        out["ops"].append({"class": cls, "n_pairs": len(ev.pairs)})
    return out
