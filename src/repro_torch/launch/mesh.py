"""Worker-group meshes: how the ranks factor into gossip workers.

The port of the reference's ``repro/launch/mesh.py``. A mesh splits into
**worker axes**, which host the M decentralized workers (the nodes of the
gossip topology), × an intra-replica **model axis**, which shards each
worker's replica k ways. :class:`WorkerMesh` holds that factorization;
shardings, the gossip backends and the bus read it.

A mesh comes in two forms, as the reference's does:

* **abstract** (:class:`AbstractMesh`): axis names and sizes, no process
  group. The spec math and the production shapes (16 × 16, 2 × 16 × 16)
  need nothing more; :func:`make_production_mesh` returns one.
* **live**: a ``torch.distributed.device_mesh.DeviceMesh`` over the ranks of
  the default process group (:func:`make_host_mesh`). Its device type is
  ``"cuda"`` unless the caller asks for ``"cpu"`` or ``"meta"``, and the
  process group's backend must match it: NCCL on the card, gloo on the CPU,
  gloo on CUDA tensors where the caller names it (ranks sharing one card),
  or, for ``"meta"`` (a dry run, ``launch.dryrun``), torch's fake process
  group, whose collectives move nothing: one process stands for rank 0 of
  a world of any size (:func:`init_fake_group`). Nothing here switches
  device or backend.

On a live mesh each rank holds the tensors of ``M / n_workers`` consecutive
workers (one when the mesh has a worker per rank) and, for a leaf sharded
over the model axis, its 1/k piece (``launch.shardings.local_tree``).
Inside :func:`model_parallel` the layers compute on those pieces with
collectives over the model group (``launch.tensor_parallel``): every
family trains there, and serving runs there on a rank's cut of the
consensus.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch import _tree

__all__ = ["AbstractMesh", "WorkerMesh", "SINGLE_POD", "MULTI_POD", "MODEL_AXIS",
           "make_production_mesh", "make_worker_mesh", "make_host_mesh",
           "worker_axes", "n_workers", "rows_cut_over", "rows_cut",
           "ModelShard", "model_parallel", "model_shard", "report_group",
           "init_fake_group"]

SINGLE_POD = (16, 16)                  # 256 chips
MULTI_POD = (2, 16, 16)                # 2 pods × 256 chips = 512

MODEL_AXIS = "model"

# the process-group backend each device type of a live mesh runs on
_BACKEND = {"cuda": "nccl", "cpu": "gloo", "meta": "cpu:fake,meta:fake"}
# the one other pairing a caller may ask for by name: gloo on CUDA tensors,
# for several ranks sharing one card (NCCL refuses two ranks on a device;
# gloo stages each collective through host memory)
_NAMED = {("cuda", "gloo")}


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group behind them."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} vs {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def _is_live(mesh) -> bool:
    from torch.distributed.device_mesh import DeviceMesh

    return isinstance(mesh, DeviceMesh)


def _names_and_shape(mesh) -> tuple[tuple[str, ...], dict[str, int]]:
    if _is_live(mesh):
        names = tuple(mesh.mesh_dim_names or ())
        if len(names) != mesh.ndim:
            raise ValueError("a live mesh needs mesh_dim_names")
        return names, dict(zip(names, (int(n) for n in mesh.mesh.shape)))
    return tuple(mesh.axis_names), dict(mesh.shape)


@dataclasses.dataclass(frozen=True)
class WorkerMesh:
    """A mesh factorized into worker axes × an intra-replica model axis.

    Attributes:
      mesh: an :class:`AbstractMesh` or a live ``DeviceMesh``.
      worker_axes: axis name(s) hosting the decentralized workers, e.g.
        ``('data',)`` or ``('pod', 'data')`` for multi-pod; the worker index
        ravels their coordinates, first axis major.
      model_axis: the axis sharding each worker's replica (``None``:
        replicas are unsharded, shard factor k = 1).
    """

    mesh: Any
    worker_axes: tuple[str, ...]
    model_axis: str | None = MODEL_AXIS

    @classmethod
    def from_mesh(cls, mesh, model_axis: str | None = MODEL_AXIS) -> "WorkerMesh":
        """Factor ``mesh``: every axis except ``model_axis`` hosts workers."""
        names, _ = _names_and_shape(mesh)
        ma = model_axis if model_axis in names else None
        return cls(mesh=mesh, worker_axes=tuple(a for a in names if a != ma),
                   model_axis=ma)

    @classmethod
    def ensure(cls, mesh_or_wm) -> "WorkerMesh | None":
        """Normalize: accept a WorkerMesh, a raw mesh, or None."""
        if mesh_or_wm is None or isinstance(mesh_or_wm, cls):
            return mesh_or_wm
        return cls.from_mesh(mesh_or_wm)

    @staticmethod
    def raw(mesh_or_wm):
        """The underlying mesh from either form (None passes through)."""
        if isinstance(mesh_or_wm, WorkerMesh):
            return mesh_or_wm.mesh
        return mesh_or_wm

    # -- mesh passthrough ----------------------------------------------------
    @property
    def axis_names(self) -> tuple[str, ...]:
        return _names_and_shape(self.mesh)[0]

    @property
    def shape(self) -> dict[str, int]:
        return _names_and_shape(self.mesh)[1]

    @property
    def live(self) -> bool:
        return _is_live(self.mesh)

    # -- factor sizes --------------------------------------------------------
    @property
    def n_workers(self) -> int:
        return int(np.prod([self.shape[a] for a in self.worker_axes], dtype=np.int64))

    @property
    def model_factor(self) -> int:
        """k — how many ways each worker's replica is sharded."""
        if self.model_axis is None or self.model_axis not in self.axis_names:
            return 1
        return self.shape[self.model_axis]

    # -- PartitionSpec helpers -----------------------------------------------
    @property
    def wa(self):
        """The worker axes as a spec entry (a name, or a tuple of names)."""
        return self.worker_axes[0] if len(self.worker_axes) == 1 else self.worker_axes

    def worker_spec(self, *trailing):
        """PartitionSpec(worker_axes, *trailing): a leading worker dim."""
        from repro_torch.models.params import PartitionSpec

        return PartitionSpec(self.wa, *trailing)

    def bus_row_tile(self, dtype="float32") -> int:
        """Row-count quantum of the gossip bus on this mesh: every dtype
        group's rows are a multiple of ``sublane(dtype) × model_factor``, so
        each model shard owns whole sublane tiles (``core.bus.plan_layout``)."""
        from repro_torch.core.bus import sublane_rows

        dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        return sublane_rows(dt) * self.model_factor

    # -- the live mesh: this rank's place ------------------------------------
    def _require_live(self):
        if not self.live:
            raise ValueError(f"{self.describe()} is abstract: this needs a live "
                             "DeviceMesh (make_host_mesh)")

    @property
    def coordinate(self) -> dict[str, int]:
        """This rank's coordinate, axis by axis."""
        self._require_live()
        coord = self.mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not in the mesh")
        return dict(zip(self.axis_names, (int(c) for c in coord)))

    @property
    def worker_index(self) -> int:
        """This rank's worker-grid index (its worker coordinates raveled)."""
        coord = self.coordinate
        return int(np.ravel_multi_index(tuple(coord[a] for a in self.worker_axes),
                                        tuple(self.shape[a] for a in self.worker_axes)))

    @property
    def model_index(self) -> int:
        return self.coordinate[self.model_axis] if self.model_factor > 1 else 0

    def rank_of(self, worker: int, shard: int = 0) -> int:
        """The global rank hosting worker-grid index ``worker``, model shard
        ``shard``."""
        self._require_live()
        coord = dict(zip(self.worker_axes, np.unravel_index(
            worker, tuple(self.shape[a] for a in self.worker_axes))))
        if self.model_axis in self.axis_names:
            coord[self.model_axis] = shard
        return int(self.mesh.mesh[tuple(int(coord[a]) for a in self.axis_names)])

    def _axis_group(self, axis: str):
        return self.mesh.get_group(axis)

    @property
    def worker_groups(self) -> list:
        """The process groups of the worker axes, one per axis: a collective
        over all workers runs over each in turn."""
        self._require_live()
        return [self._axis_group(a) for a in self.worker_axes]

    @property
    def p2p_group(self):
        """The group point-to-point exchanges between workers run in: the
        worker axis's own with one worker axis, else the default group.
        Peers are global ranks either way."""
        self._require_live()
        return self._axis_group(self.worker_axes[0]) if len(self.worker_axes) == 1 else None

    @property
    def model_group(self):
        """The process group of this rank's model shards (k > 1 only)."""
        self._require_live()
        return self._axis_group(self.model_axis) if self.model_factor > 1 else None

    # -- simulator mirror ----------------------------------------------------
    def sim_payload_bytes(self, params_template, param_specs=None, *,
                          lead_ndim: int = 0, wire_dtype=None) -> int:
        """Per-rank bytes of ONE bulk gossip exchange on this mesh:
        ``BusLayout.padded_bytes`` of the bus plan for the local shard view
        (tensor-sharded leaves contribute their 1/k shard, every other leaf
        its ``⌈n/k⌉`` row-split chunk). ``params_template`` is a per-worker
        tree (``meta`` tensors work); ``lead_ndim`` leading dims are ignored.
        ``wire_dtype`` ('bfloat16'|'int8') prices the compressed lane."""
        from repro_torch.core.bus import plan_layout, sharded_leaf_flags

        k = self.model_factor
        leaves, treedef = _tree.flatten(params_template)
        sizes = [int(np.prod(x.shape[lead_ndim:], dtype=np.int64)) for x in leaves]
        if k <= 1:
            flags = (True,) * len(leaves)
        elif param_specs is None:
            flags = (False,) * len(leaves)   # row-split everything
        else:
            flags = sharded_leaf_flags(param_specs, self.model_axis, treedef=treedef)
        local = []
        for x, n, f in zip(leaves, sizes, flags):
            if f and n % k:
                raise ValueError(f"leaf of {n} elements marked tensor-sharded but does "
                                 f"not divide the model factor {k}")
            local.append(torch.empty((n // k if f else n,), dtype=x.dtype, device="meta"))
        layout = plan_layout(_tree.unflatten(treedef, local), lead_ndim=0, shards=k,
                             leaf_sharded=flags)
        return layout.padded_bytes(wire_dtype)

    def sim_spec(self, *, params_template=None, param_specs=None, dci_dtype=None):
        """Mirror into a :class:`repro_torch.sim.MeshSpec`: worker group =
        coordinate along the leading worker axis (one group without a pod
        axis), payload bytes from :meth:`sim_payload_bytes` when a template is
        given; ``dci_dtype`` also prices cross-pod messages compressed."""
        from repro_torch.sim.scenarios import MeshSpec

        sizes = [self.shape[a] for a in self.worker_axes]
        n = int(np.prod(sizes))
        inner = n if len(sizes) == 1 else n // sizes[0]
        payload = dci_payload = 0
        if params_template is not None:
            payload = self.sim_payload_bytes(params_template, param_specs)
            if dci_dtype is not None:
                dci_payload = self.sim_payload_bytes(params_template, param_specs,
                                                     wire_dtype=dci_dtype)
        return MeshSpec(group_of=tuple(i // inner for i in range(n)),
                        payload_bytes=payload, dci_payload_bytes=dci_payload,
                        name=self.describe())

    def describe(self) -> str:
        w = "×".join(f"{a}={self.shape[a]}" for a in self.worker_axes)
        return f"workers[{w}]={self.n_workers} × {self.model_axis or '-'}={self.model_factor}"


class ModelShard(NamedTuple):
    """This rank's place on the model axis of a live mesh: the axis's
    process group, its size k and this rank's index along it."""

    group: Any
    k: int
    index: int


# this rank's ModelShard while the call running now computes on its model
# shards of the replica (the train step on a mesh with k > 1), else None
_MODEL: contextvars.ContextVar = contextvars.ContextVar("model_parallel", default=None)


@contextlib.contextmanager
def model_parallel(wm: "WorkerMesh | None"):
    """Within it, the layers compute on this rank's model shards of the
    replica with collectives over ``wm``'s model group (Megatron-style
    tensor parallelism, ``launch.tensor_parallel``); a mesh of model factor
    1, or None, leaves the layers meshless. The state is a context
    variable: a computation replayed on another thread (a recomputed layer
    in the backward pass, which the card's autograd engine runs on its
    device thread) must run in a copy of the caller's context."""
    shard = None
    if wm is not None and wm.model_factor > 1:
        shard = ModelShard(wm.model_group, wm.model_factor, wm.model_index)
    token = _MODEL.set(shard)
    try:
        yield
    finally:
        _MODEL.reset(token)


def model_shard() -> "ModelShard | None":
    """The :class:`ModelShard` of the :func:`model_parallel` context running
    now (None outside one, or at model factor 1)."""
    return _MODEL.get()


# the live WorkerMesh whose ranks each hold a cut of the rows of the call
# running now (allreduce mode's forward on a mesh), else None
_ROWS_CUT: contextvars.ContextVar = contextvars.ContextVar("rows_cut_over", default=None)


@contextlib.contextmanager
def rows_cut_over(wm: "WorkerMesh | None", microbatch: int = 1):
    """Within it, the call running on this rank sees only its cut of the
    batch's rows, in worker order, the others' rows being on the other
    ranks of ``wm`` (None: the call is whole), or, with ``microbatch`` > 1,
    a chunk of that cut. A layer whose function couples the rows of a call
    computes it over the whole call with collectives over ``wm``'s worker
    groups (:func:`rows_cut`)."""
    token = _ROWS_CUT.set(None if wm is None else (wm, microbatch))
    try:
        yield
    finally:
        _ROWS_CUT.reset(token)


def rows_cut(what: str) -> "WorkerMesh | None":
    """The live WorkerMesh of several worker groups whose ranks hold the
    rows of the call running now (:func:`rows_cut_over`), else None; ``what``,
    a computation over all the rows of a call together, names the refusal
    of an abstract mesh, which has no process group to compute it over."""
    cut = _ROWS_CUT.get()
    if cut is None or cut[0].n_workers <= 1:
        return None
    wm, microbatch = cut
    if microbatch > 1:
        raise NotImplementedError(
            f"{what} over {microbatch} microbatches with the batch's rows cut over "
            f"{wm.describe()}: the whole call's microbatches are chunks of the global "
            "rows, which cut across the ranks' rows; use microbatch=1 or "
            "moe_dispatch='per_sequence'")
    if not wm.live:
        raise ValueError(f"{what} with the batch's rows cut over {wm.describe()}: computing "
                         "it over the whole call needs a live mesh (make_host_mesh), whose "
                         "worker groups the ranks exchange over")
    return wm


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """The production shapes, abstract: 16 × 16 (data, model), or 2 × 16 × 16
    (pod, data, model)."""
    if multi_pod:
        return AbstractMesh(MULTI_POD, ("pod", "data", "model"))
    return AbstractMesh(SINGLE_POD, ("data", "model"))


def make_worker_mesh(*, multi_pod: bool = False) -> WorkerMesh:
    """Production WorkerMesh: (pod ×) data workers × 16-way model groups."""
    return WorkerMesh.from_mesh(make_production_mesh(multi_pod=multi_pod))


def make_host_mesh(data: int = 2, model: int = 2, pod: int | None = None, *,
                   device: str = "cuda", backend: str | None = None):
    """A live mesh over the first ``(pod ×) data × model`` ranks of the
    default process group, which the caller has initialized (NCCL for
    ``device='cuda'``, gloo for ``'cpu'``; for ``'meta'``, the fake group,
    which this initializes at the mesh's size if no group is); every rank
    calls this. Ranks past the mesh get no coordinate. ``backend='gloo'`` with
    ``device='cuda'`` asks for gloo on CUDA tensors by name (ranks sharing
    one card); the mesh never picks another backend itself."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if device not in _BACKEND:
        raise ValueError(f"device {device!r}: expected one of {sorted(_BACKEND)}")
    want = backend or _BACKEND[device]
    if want != _BACKEND[device] and (device, want) not in _NAMED:
        raise ValueError(f"a {device} mesh does not run on {want}")
    shape, names = ((pod, data, model), ("pod", "data", "model")) if pod else \
        ((data, model), ("data", "model"))
    n = int(np.prod(shape))
    if device == "meta" and not dist.is_initialized():
        init_fake_group(n)
    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh needs an initialized default process group")
    if dist.get_backend() != want:
        raise ValueError(f"a {device} mesh runs on {want}; the default process group "
                         f"is {dist.get_backend()}")
    if n > dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    mesh = DeviceMesh(device, torch.arange(n).view(shape), mesh_dim_names=names)
    key = (dist.group.WORLD, tuple(range(n)))
    if n > 1 and key not in _REPORT_GROUPS:
        # every rank of the world takes part, so the group's name (a count of
        # the groups made, the same on every rank) agrees. A group made
        # later with local synchronization by the mesh's ranks alone is named
        # by a hash of its ranks and of the groups each rank has made, which
        # differs between ranks once a mesh over a subset of them exists,
        # and then never forms.
        _REPORT_GROUPS[key] = dist.new_group(list(range(n)),
                                             backend=None if device == "meta" else "gloo")
    return mesh


def init_fake_group(world_size: int) -> None:
    """Initialize the default process group as torch's fake group
    (``torch.testing._internal.distributed.fake_pg``, a private module) on
    the CPU and ``meta`` devices: rank 0 of ``world_size`` in this one
    process, every collective returning at once without moving data. The
    group is the process's, so a dry run runs in a process of its own."""
    import torch.distributed as dist

    try:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401  (registers "fake")
    except ImportError as e:
        raise RuntimeError("a meta mesh needs torch's fake process group, "
                           "torch.testing._internal.distributed.fake_pg, which this "
                           f"torch ({torch.__version__}) lacks") from e
    dist.init_process_group(_BACKEND["meta"], store=dist.HashStore(), rank=0,
                            world_size=world_size)


# the gloo group of each live mesh's ranks, by default group and ranks, made
# with the mesh (make_host_mesh): a sharded checkpoint's ranks report their
# shards written over it, a group of its own, so that the report can run on
# a writer's thread beside the loop's collectives
_REPORT_GROUPS: dict = {}


def report_group(mesh):
    """The gloo group over the ranks of the live ``mesh`` that
    :func:`make_host_mesh` made with it (None for a mesh of one rank)."""
    import torch.distributed as dist

    ranks = tuple(sorted(int(r) for r in mesh.mesh.flatten().tolist()))
    if len(ranks) == 1:
        return None
    group = _REPORT_GROUPS.get((dist.group.WORLD, ranks))
    if group is None:
        raise ValueError(f"no report group over ranks {ranks}: a live mesh of several "
                         "ranks comes from make_host_mesh, called by every rank")
    return group


def worker_axes(mesh) -> tuple[str, ...]:
    """Mesh axes hosting the decentralized workers (all but 'model')."""
    return WorkerMesh.ensure(mesh).worker_axes


def n_workers(mesh) -> int:
    return WorkerMesh.ensure(mesh).n_workers
