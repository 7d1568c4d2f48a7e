"""Launch helpers: the worker mesh and its sharding rules (``mesh``,
``shardings``, ``tensor_parallel``), and the launch tooling: a call's cost
on a rank (``cost``), its roofline terms on the H100 (``roofline``) and the
dry run of every (architecture × input shape) on the production mesh,
on meta tensors (``dryrun``)."""
from repro_torch.launch.mesh import (
    MODEL_AXIS,
    AbstractMesh,
    WorkerMesh,
    make_host_mesh,
    make_production_mesh,
    make_worker_mesh,
    n_workers,
    worker_axes,
)

__all__ = ["AbstractMesh", "WorkerMesh", "MODEL_AXIS", "make_host_mesh",
           "make_production_mesh", "make_worker_mesh", "n_workers", "worker_axes"]
