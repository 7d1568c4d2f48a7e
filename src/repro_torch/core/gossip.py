"""Gossip / consensus mixing (paper eq. 3, first term).

The port of the reference's ``repro/core/gossip.py``. Every parameter leaf
carries a leading worker dimension of size M, so mixing leaf ``x`` of shape
(M, ...) is ``x ← einsum('im,i...->m...', A, x)``.

Backends (selected via :class:`GossipSpec`):

* ``einsum``    — dense contraction with A; correct for any A (the oracle).
* ``ppermute``  — over a worker mesh: one exchange per leaf and
  non-identity permutation of A's Birkhoff decomposition
  (``batch_isend_irecv``), the weighted terms summed in the leaf's dtype.
* ``allreduce`` — over a worker mesh: the clique's mean, one all-reduce per
  leaf over the worker axes (the parameter-server baseline the paper
  compares with).
* ``fused``     — the flat-buffer gossip bus (:mod:`repro_torch.core.bus`):
  the tree packs into one buffer per dtype and the mix (+ optimizer update,
  in the train step) is one pass of the fused ``gossip_mix`` kernel, one
  exchange per permutation over a mesh.

On a mesh (``mesh=``: a ``launch.mesh.WorkerMesh`` or its live
``DeviceMesh``) every rank passes its own workers' leaves (a worker dim of
``M / n_workers``) and gets theirs back; without one, ``ppermute`` and
``allreduce`` mix with the einsum oracle, as the reference's do.

``GossipSpec(time_varying='one_peer_exp')`` mixes step k with the one-peer
exponential graph of round ``k mod log2 M`` (:func:`mix_pytree_time_varying`;
the train step's fused path is :func:`repro_torch.core.bus.mix_and_update_time_varying`).
:func:`survivor_mix` and :func:`survivor_hierarchical_mix` mix over a
partial fleet with the repaired matrices of :mod:`repro_torch.core.topology`.

``GossipSpec(hierarchical=True)`` runs a Kronecker (multi-pod) topology as
its two factorized stages, intra-pod then cross-pod (:func:`hierarchical_mix`);
:func:`hierarchical_mix_compressed` sends the cross-pod stage over the
compressed wire of :func:`repro_torch.core.bus.mix_bus_compressed`.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core.topology import (
    Topology,
    one_peer_exponential,
    repair_hier_stages,
    split_kronecker,
    survivor_matrix,
)

__all__ = ["GossipSpec", "mix_pytree", "mix_reference", "mix_pytree_reference",
           "make_mixer", "mix_pytree_time_varying", "split_hierarchical",
           "hierarchical_mix", "hierarchical_mix_compressed", "survivor_mix",
           "survivor_hierarchical_mix"]

PyTree = Any


@dataclasses.dataclass(frozen=True)
class GossipSpec:
    """Static description of how the consensus step executes.

    topology: the Topology (consensus matrix A, M workers).
    backend: 'einsum' | 'ppermute' | 'allreduce' | 'fused' | 'auto'
      ('auto': 'allreduce' on a clique, 'ppermute' otherwise).
    worker_axes: mesh axis name(s) the worker dim is sharded over.
    model_axis: the intra-replica axis (``WorkerMesh.model_axis``) or None;
      with it and ``param_specs`` the fused bus gossips per model shard.
    period: gossip every `period` optimizer steps (1 = the paper's DSM).
    time_varying: None (static topology) or 'one_peer_exp': the step-k
      matrix pairs node i with node i + 2^(k mod log2 M) (degree 1, exact
      consensus every log2 M rounds); M must be a power of two.
    hierarchical: run a kronecker/`hier` topology as its two factorized
      stages (:func:`split_hierarchical`), intra-pod then cross-pod, instead
      of one mix with the product matrix: the same consensus matrix.
    """

    topology: Topology
    backend: str = "auto"
    worker_axes: tuple[str, ...] = ("data",)
    model_axis: str | None = None
    period: int = 1
    time_varying: str | None = None
    hierarchical: bool = False

    def __post_init__(self):
        if self.time_varying not in (None, "one_peer_exp"):
            raise ValueError(f"unknown time_varying {self.time_varying!r}")

    @classmethod
    def for_mesh(cls, topology: Topology, wmesh, **kw) -> "GossipSpec":
        """A spec bound to a WorkerMesh: its worker axes, and its model axis
        when the shard factor k > 1."""
        from repro_torch.launch.mesh import WorkerMesh

        wm = WorkerMesh.ensure(wmesh)
        return cls(topology=topology, worker_axes=wm.worker_axes,
                   model_axis=wm.model_axis if wm.model_factor > 1 else None, **kw)

    def resolved_backend(self) -> str:
        if self.backend != "auto":
            return self.backend
        t = self.topology
        if t.circulant_offsets is not None and len(t.circulant_offsets) == t.M:
            return "allreduce"  # clique
        return "ppermute"

    @functools.cached_property
    def permutations(self) -> list[tuple[float, np.ndarray]]:
        return self.topology.permutations()

    @functools.cached_property
    def one_peer_specs(self) -> list["GossipSpec"]:
        """The log2(M) static specs of the one-peer rounds, built once per
        spec, so a step pays neither the topology build nor its
        decomposition (each sub-spec caches its permutations)."""
        M = self.topology.M
        tau = int(np.log2(M))
        if 1 << tau != M:
            raise ValueError("one_peer_exp needs M a power of two")
        return [dataclasses.replace(self, topology=one_peer_exponential(M, k),
                                    time_varying=None)
                for k in range(tau)]


def mix_reference(x: torch.Tensor, A) -> torch.Tensor:
    """Dense W·A for one leaf with leading worker dim: x[m] ← Σ_i A[i,m] x[i].

    A is cast to ``x``'s dtype first, as in the reference, so a bf16 tree
    mixes with a bf16 A.
    """
    A = torch.as_tensor(np.asarray(A), dtype=x.dtype, device=x.device)
    return torch.einsum("im,i...->m...", A, x)


def mix_pytree_reference(params: PyTree, A) -> PyTree:
    return _tree.map(lambda x: mix_reference(x, A), params)


# ---------------------------------------------------------------------------
# Mixing over a worker mesh
# ---------------------------------------------------------------------------


def _allreduce_leaf(x: torch.Tensor, wm, M: int) -> torch.Tensor:
    """The mean over all M workers of one leaf (this rank's m workers
    summed, then one all-reduce per worker axis), for each of them."""
    import torch.distributed as dist

    y = x.sum(0, keepdim=True) if x.shape[0] > 1 else x.clone()
    for group in wm.worker_groups:
        dist.all_reduce(y, group=group)
    return (y / M).expand_as(x).clone()


def _ppermute_leaf(x: torch.Tensor, spec: GossipSpec, wm) -> torch.Tensor:
    """Mix one leaf of this rank's workers: ``Σ_p w_p·P_p(x)`` in the leaf's
    dtype, the weight cast to it first, one exchange per non-identity
    permutation (perm[j] is the source of destination j)."""
    M = spec.topology.M
    ident = np.arange(M)
    x = x.contiguous()
    acc = None
    for w, perm in spec.permutations:
        wt = torch.tensor(w, dtype=x.dtype, device=x.device)
        if np.array_equal(perm, ident):
            contrib = x * wt
        else:
            (got,), pending = bus._ppermute([x], [(int(perm[j]), j) for j in range(M)],
                                            wm, M)
            bus._wait([pending])
            contrib = got * wt
        acc = contrib if acc is None else acc + contrib
    return acc


def _shard_map_mix(params: PyTree, spec: GossipSpec, wm, leaf_fn) -> PyTree:
    """``leaf_fn`` over this rank's leaves: the reference's shard_map body,
    whose per-shard view is what a rank holds here (its workers, each
    tensor-sharded leaf already cut to its model shard)."""
    if spec.topology.M % wm.n_workers:
        raise ValueError(f"{spec.topology.M} workers do not split over {wm.describe()}")
    return _tree.map(leaf_fn, params)


def mix_pytree(params: PyTree, spec: GossipSpec, mesh=None, *,
               param_specs: PyTree | None = None) -> PyTree:
    """Consensus step over the parameter tree (leaves have a leading worker
    dim: all M workers, or this rank's on a ``mesh``). ``param_specs``
    reaches the fused bus (per-model-shard gossip)."""
    if spec.hierarchical:
        intra, inter = split_hierarchical(dataclasses.replace(spec, hierarchical=False))
        return mix_pytree(mix_pytree(params, intra, mesh, param_specs=param_specs),
                          inter, mesh, param_specs=param_specs)
    backend = spec.resolved_backend()
    if backend not in ("einsum", "fused", "allreduce", "ppermute"):
        raise ValueError(f"unknown gossip backend {backend!r}")
    wm = bus._live(mesh)
    if backend == "fused":
        return bus.mix_bus(params, spec, wm, param_specs=param_specs)
    if backend == "einsum" or wm is None:
        if wm is not None:
            raise ValueError("the einsum backend mixes all M workers' leaves at once; "
                             "over a mesh use 'ppermute', 'allreduce' or 'fused'")
        return mix_pytree_reference(params, spec.topology.A)
    if backend == "allreduce":
        return _shard_map_mix(params, spec, wm,
                              lambda x: _allreduce_leaf(x, wm, spec.topology.M))
    return _shard_map_mix(params, spec, wm, lambda x: _ppermute_leaf(x, spec, wm))


def make_mixer(spec: GossipSpec, mesh=None):
    """Returns a params -> mixed_params closure for the given spec."""

    def mixer(params: PyTree) -> PyTree:
        return mix_pytree(params, spec, mesh)

    return mixer


def mix_pytree_time_varying(params: PyTree, spec: GossipSpec, step: int, mesh=None, *,
                            param_specs: PyTree | None = None) -> PyTree:
    """Step-dependent consensus (``spec.time_varying = 'one_peer_exp'``): the
    normal mix with the pairwise topology of round ``step % log2(M)``."""
    rounds = spec.one_peer_specs
    return mix_pytree(params, rounds[step % len(rounds)], mesh, param_specs=param_specs)


# ---------------------------------------------------------------------------
# Hierarchical multi-pod mixing
# ---------------------------------------------------------------------------


def split_hierarchical(spec: GossipSpec) -> tuple[GossipSpec, GossipSpec]:
    """Factor a spec on a kronecker/`hier` topology into its two stages:
    ``(intra, inter)`` specs on the same M workers, ``I ⊗ A_inner`` (pod
    local) and ``A_outer ⊗ I`` (cross-pod), whose back-to-back mix equals
    one mix with the Kronecker matrix."""
    intra_t, inter_t = split_kronecker(spec.topology)
    return (dataclasses.replace(spec, topology=intra_t),
            dataclasses.replace(spec, topology=inter_t))


def hierarchical_mix(params: PyTree, intra: GossipSpec, inter: GossipSpec,
                     mesh=None) -> PyTree:
    """Two-level gossip: mix inside each pod, then across pods. The
    equivalent consensus matrix is ``A_inter ⊗ A_intra``."""
    return mix_pytree(mix_pytree(params, intra, mesh), inter, mesh)


def hierarchical_mix_compressed(params: PyTree, intra: GossipSpec,
                                inter: GossipSpec, mesh=None, *,
                                dci_dtype: str | None = None,
                                residual: list | None = None
                                ) -> tuple[PyTree, list | None]:
    """Two-level gossip with a lossy cross-pod (DCI) stage.

    The intra-pod stage is the exact mix of ``intra``'s backend; the
    cross-pod stage rides :func:`repro_torch.core.bus.mix_bus_compressed`
    (bf16 cast, or int8 with a per-row scale, plus error feedback). Returns
    ``(mixed_params, residual)``; thread ``residual`` across rounds.
    ``dci_dtype=None`` is bit-identical to :func:`hierarchical_mix` and
    passes ``residual`` through.
    """
    if dci_dtype is None:
        return hierarchical_mix(params, intra, inter, mesh), residual
    return bus.mix_bus_compressed(mix_pytree(params, intra, mesh), inter, mesh,
                                  wire_dtype=dci_dtype, residual=residual)


# ---------------------------------------------------------------------------
# Survivor-renormalized mixing (fault tolerance: mix over a partial fleet)
# ---------------------------------------------------------------------------


def survivor_mix(params: PyTree, topology: Topology, alive,
                 mode: str = "reabsorb") -> PyTree:
    """Consensus step over the survivors only (dense path).

    The matrix is :func:`~repro_torch.core.topology.survivor_matrix`'s repair
    of A for the live-mask ``alive``: dead workers get zero weight and their
    slices pass through untouched; a full mask mixes with A itself."""
    A = survivor_matrix(topology.A, np.asarray(alive, dtype=bool), mode)
    return mix_pytree_reference(params, A)


def survivor_hierarchical_mix(params: PyTree, topology: Topology, alive,
                              mode: str = "reabsorb") -> PyTree:
    """Two-stage hierarchical mix with the stages re-planned for the
    live-mask by :func:`~repro_torch.core.topology.repair_hier_stages`
    (whole dead pods contracted out of the outer graph), applied
    back-to-back (dense path)."""
    intra_A, inter_A = repair_hier_stages(
        topology, np.asarray(alive, dtype=bool), mode)
    return mix_pytree_reference(mix_pytree_reference(params, intra_A), inter_A)
