"""Mesh launch helpers: the worker mesh and its sharding rules."""
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
