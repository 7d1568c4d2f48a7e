"""Gossip-health gauges: convergence-side metrics of the ACTIVE mixing matrix.

A numpy-only copy of the reference's ``repro/telemetry/health.py`` on the
port's :mod:`repro_torch.core.topology`.

The paper ranks topologies by spectral gap, but Vogels et al. ("Beyond
spectral gap", PAPERS.md) show the gauge that actually tracks decentralized
convergence is the topology's *effective number of neighbors* — the variance
reduction a worker gets from repeated gossip averaging, which can differ
wildly between graphs of equal spectral gap. Both are cheap functions of the
consensus matrix, so we emit both, and we emit them for the matrix the fleet
is *actually* mixing with right now: survivor-repaired after churn
(``survivor_matrix`` / ``repair_hier_stages``), edge-blocked during link-fault
windows, switched after a topology SWITCH. Outage repairs become visible as
gauge steps on the same timeline as the event trace.

Effective number of neighbors (Vogels et al., §3): run the noise process

    x_{t+1} = γ·Aᵀ·(x_t + ξ_t),   ξ_t ~ N(0, I)  i.i.d. per worker

(the repo's column convention: ``w_j ← Σ_i A[i,j] w_i``). Its stationary
mean per-worker variance, normalized by the isolated worker's
``γ²/(1−γ²)``, is the variance-reduction factor

    n_eff(γ) = [γ²/(1−γ²)] / [(1/M)·tr Σ_∞],
    tr Σ_∞ = Σ_k γ^{2k}·‖A^k‖_F²  (= Σ_i γ²|λ_i|²/(1−γ²|λ_i|²) for normal A)

with n_eff = M for the clique, 1 for isolated workers, and in between for
sparse graphs. The closed form over eigenvalue moduli applies to normal
matrices (every healthy topology here); survivor-repaired matrices need not
stay normal, so they fall back to iterating the covariance recursion to its
fixed point (geometric convergence at γ²·λ_max² — a handful of M×M matmuls).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np

__all__ = ["HealthConfig", "effective_neighbors", "health_gauges",
           "active_matrix", "DEFAULT_GAMMA"]

# Vogels et al. sweep γ∈(0,1); 0.9 sits in the regime where sparse
# topologies separate cleanly without the γ→1 collapse to n_eff = M.
DEFAULT_GAMMA = 0.9


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Engine-side gauge configuration.

    gamma: decay of the effective-neighbors noise process.
    mode: survivor-repair mode when no protocol overrides it
      ('reabsorb' | 'renormalize' — see ``core/topology.survivor_column``).
    """

    gamma: float = DEFAULT_GAMMA
    mode: str = "reabsorb"

    def __post_init__(self):
        if not 0.0 < self.gamma < 1.0:
            raise ValueError(f"gamma must be in (0, 1), got {self.gamma}")


def effective_neighbors(A: np.ndarray, gamma: float = DEFAULT_GAMMA, *,
                        tol: float = 1e-12, max_iter: int = 100_000) -> float:
    """Vogels-style effective number of neighbors n_eff(γ); module docstring.

    Accepts any square non-negative mixing matrix — including the raw
    survivor-repaired outputs of ``survivor_matrix`` (isolated dead rows
    contribute variance like isolated workers, dragging n_eff down, which is
    exactly the health signal an outage should show).
    """
    A = np.asarray(A, np.float64)
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"mixing matrix must be square, got {A.shape}")
    if not 0.0 < gamma < 1.0:
        raise ValueError(f"gamma must be in (0, 1), got {gamma}")
    M = A.shape[0]
    if M == 1:
        return 1.0
    g2 = gamma * gamma
    iso = g2 / (1.0 - g2)
    if np.allclose(A @ A.T, A.T @ A, atol=1e-9):
        lam2 = np.abs(np.linalg.eigvals(A)) ** 2
        lam2 = np.minimum(lam2, 1.0)        # clip fp noise above 1
        mean_var = float(np.mean(g2 * lam2 / (1.0 - g2 * lam2)))
    else:
        S = np.zeros((M, M))
        eye = np.eye(M)
        for _ in range(max_iter):
            S_new = g2 * (A.T @ (S + eye) @ A)
            if np.abs(S_new - S).max() < tol:
                S = S_new
                break
            S = S_new
        mean_var = float(np.trace(S)) / M
    if mean_var <= 0.0:
        return float(M)     # A ≈ 0: noise is annihilated entirely
    return float(iso / mean_var)


def health_gauges(A: np.ndarray, gamma: float = DEFAULT_GAMMA) -> dict:
    """The gauge set emitted on every active-matrix change."""
    from repro_torch.core.topology import second_eigenvalue_modulus

    lam2 = second_eigenvalue_modulus(np.asarray(A, np.float64))
    return {
        "spectral_gap": 1.0 - lam2,
        "lambda2": lam2,
        "effective_neighbors": effective_neighbors(A, gamma),
    }


def active_matrix(topology, alive: np.ndarray | None = None, *,
                  blocked: Callable[[int, int], bool] | None = None,
                  mode: str = "reabsorb", hier: bool = False) -> np.ndarray:
    """The mixing matrix the fleet is ACTUALLY applying right now.

    Starts from ``topology.A`` and layers on the same repairs the runtime
    applies:

    * dead workers (``alive`` mask) are isolated and surviving columns
      re-stochasticized (``survivor_matrix``); with ``hier=True`` on a
      kronecker/`hier` topology the two-stage churn re-plan
      (``repair_hier_stages`` — whole-pod drops bridge the outer graph) is
      used instead, matching ``survivor_hierarchical_mix``;
    * ``blocked(i, j) -> bool`` marks edges currently unusable (an open
      :class:`~repro_torch.sim.scenarios.LinkFault` DOWN window): each affected
      column is repaired with ``survivor_column`` over its usable
      in-estimates, the exact column the timed-out barrier protocols mix
      with. Degraded (slow-but-alive) links do NOT change the matrix.

    Healthy fleet, no blocks ⇒ returns ``topology.A`` (copy) bit-identically.
    """
    from repro_torch.core.topology import (repair_hier_stages, survivor_column,
                                     survivor_matrix)

    A = np.asarray(topology.A, np.float64)
    M = A.shape[0]
    alive = np.ones(M, dtype=bool) if alive is None \
        else np.asarray(alive, dtype=bool)
    if hier and topology.group_of is not None and not alive.all():
        try:
            intra, inter = repair_hier_stages(topology, alive, mode)
            A = inter @ intra
        except ValueError:      # not a clean kronecker — flat repair
            A = survivor_matrix(A, alive, mode)
    else:
        A = survivor_matrix(A, alive, mode)
    if blocked is not None:
        A = A.copy()
        for j in range(M):
            if not alive[j]:
                continue
            keep = alive.copy()
            hit = False
            for i in np.nonzero(A[:, j])[0]:
                if i != j and keep[i] and blocked(int(i), j):
                    keep[i] = False
                    hit = True
            if hit:
                A[:, j] = survivor_column(A[:, j], j, keep, mode)
    return A


def round_bytes_by_class(topology, payload_bytes: int,
                         group_of: Any = None) -> dict[str, int]:
    """Padded bus bytes one full gossip round ships, split by link class.

    Each directed edge of the topology carries one per-device bus payload
    (``BusLayout.padded_bytes``) per round; edges partition into intra-pod
    (ICI) vs cross-pod (DCI) exactly as the mesh-aware simulator charges
    them (``core/topology.edge_classes``). The number the sim's
    ``Trace.link_accounting`` byte totals cross-check against:
    ``messages × payload == rounds × round_bytes_by_class``.
    """
    from repro_torch.core.topology import edge_classes

    classes = edge_classes(topology, group_of)
    return {cls: len(edges) * int(payload_bytes)
            for cls, edges in classes.items()}
