"""Convergence analysis of the paper (§3, App. C/D) as executable code.

A numpy-only copy of the reference's ``repro/core/analysis.py`` on the
port's own topology and partition modules.

Implements:
  * empirical estimation of E, E_sp, H, α, β from gradient samples (Table 1),
  * the refined bound (7) (Prop. 3.1), the classic bound (8) (Cor. 3.2) and
    its full-batch form (9),
  * Prop. 3.3 analytic moments Ê, Ê_sp, Ĥ under random partitioning with
    replication factor C, and the β̂ estimate of eq. (12),
  * the Fig. 3 procedure predicting the iteration k' at which ring and clique
    training losses should visibly diverge (k'_o from (8), k'_n from (7)),
  * Appendix C insensitivity horizons: K_l (Lian et al. 2017, Cor. 2) and
    K'_l (Pu et al. 2019, eq. 21).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np

from repro_torch.core import topology as topo_lib
from repro_torch.core.topology import Topology

PyTree = Any


# ---------------------------------------------------------------------------
# Empirical constants from gradient samples
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GradientConstants:
    """Empirical E, E_sp, H, α for a given problem + topology (paper Table 1)."""

    E: float
    E_sp: float
    H: float
    alpha: float
    M: int

    @property
    def beta(self) -> float:  # eq. (10)
        return float((1.0 / self.alpha) * self.E / (np.sqrt(self.E_sp) * self.H))

    @property
    def ratio_E_Esp(self) -> float:
        return float(np.sqrt(self.E / self.E_sp))

    @property
    def ratio_E_H(self) -> float:
        return float(np.sqrt(self.E) / self.H)


def gradient_matrix(grads_per_worker: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-worker flat gradients into the paper's n×M matrix G."""
    return np.stack([np.ravel(g) for g in grads_per_worker], axis=1)


def estimate_constants(
    G_samples: Sequence[np.ndarray], topology: Topology
) -> GradientConstants:
    """Estimate E, E_sp, H, α from i.i.d. minibatch gradient matrices.

    Args:
      G_samples: list of (n, M) gradient matrices, one per independent
        minibatch draw at fixed parameters (paper: empirical averages using
        the random minibatches drawn at the first iteration).
      topology: used for the eigenspace decomposition defining α.
    """
    G_samples = [np.asarray(G, np.float64) for G in G_samples]
    M = G_samples[0].shape[1]
    E = float(np.mean([np.linalg.norm(G, "fro") ** 2 for G in G_samples]))
    ones = np.ones((M, M)) / M
    deltas = [G - G @ ones for G in G_samples]
    E_sp = float(np.mean([np.linalg.norm(D, "fro") ** 2 for D in deltas]))
    G_mean = np.mean(G_samples, axis=0)  # ≈ E_ξ[G]
    H = float(np.linalg.norm(G_mean, "fro"))
    # α from the spread of ΔG energy over A's eigenspaces (ΔG rows, length M,
    # are projected onto each eigenspace — paper eq. 32/33)
    lam, _ = topo_lib.spectral_projectors(topology.A)
    e = np.mean([topo_lib.energy_fractions(D, topology.A) for D in deltas], axis=0)
    alpha = topo_lib.alpha_from_fractions(e, lam)
    alpha = float(np.clip(alpha, 1e-12, 1.0))
    return GradientConstants(E=E, E_sp=E_sp, H=H, alpha=alpha, M=M)


# ---------------------------------------------------------------------------
# Bounds (7), (8), (9)
# ---------------------------------------------------------------------------


def _lam_series(lam2: float, K: np.ndarray) -> np.ndarray:
    """(1 - |λ2|^K) / (1 - |λ2|), stable at λ2 → 1 (= K)."""
    lam2 = float(lam2)
    K = np.asarray(K, np.float64)
    if abs(1.0 - lam2) < 1e-12:
        return K
    return (1.0 - lam2**K) / (1.0 - lam2)


def bound_new(K, *, M, eta, dist0, E, E_sp, H, R_sp, alpha, lam2) -> np.ndarray:
    """Refined bound — Prop. 3.1, eq. (7). K counts iterations (K ≥ 1)."""
    K = np.asarray(K, np.float64)
    s = _lam_series(lam2, K)
    t1 = M / (2 * eta * K) * dist0**2
    t2 = eta * E / 2
    t3 = 2 * H * np.sqrt(R_sp) * np.sqrt(M) / K * s
    t4 = 2 * eta * H * np.sqrt(E_sp) * (
        (1 - alpha) * (K - 1) / K + alpha / (1 - lam2) * (1 - s / K)
    )
    return t1 + t2 + t3 + t4


def bound_old(K, *, M, eta, dist0, E, R, lam2) -> np.ndarray:
    """Classic bound — Cor. 3.2, eq. (8)."""
    K = np.asarray(K, np.float64)
    s = _lam_series(lam2, K)
    t1 = M / (2 * eta * K) * dist0**2
    t2 = eta * E / 2
    t3 = 2 * np.sqrt(E) * np.sqrt(R) * np.sqrt(M) / K * s
    t4 = 2 * eta * E / (1 - lam2) * (1 - s / K)
    return t1 + t2 + t3 + t4


def bound_full_batch(K, *, M, eta, dist0, L, R, lam2) -> np.ndarray:
    """Full-batch form — eq. (9), with ||g_j||₂ ≤ L."""
    K = np.asarray(K, np.float64)
    s = _lam_series(lam2, K)
    t1 = M / (2 * eta * K) * dist0**2
    t2 = eta * M * L**2 / 2
    t3 = 2 * L * np.sqrt(R) * M / K * s
    t4 = 2 * eta * L**2 * M / (1 - lam2) * (1 - s / K)
    return t1 + t2 + t3 + t4


def bound_local(K, *, M, eta, dist0, E, E_sp, H, R_sp, alpha, lam2) -> np.ndarray:
    """Per-node time-average bound — Prop. D.4, eq. (56)."""
    K = np.asarray(K, np.float64)
    s = _lam_series(lam2, K)
    t1 = M / (2 * eta * K) * dist0**2
    t2 = eta * E / 2
    t3 = H * 3 * M * np.sqrt(R_sp) / K * s
    t4 = 3 * eta * np.sqrt(M) * H * np.sqrt(E_sp) * (
        (1 - alpha) * (K - 1) / K + alpha / (1 - lam2) * (1 - s / K)
    )
    return t1 + t2 + t3 + t4


# ---------------------------------------------------------------------------
# Prop. 3.3 — analytic moments under random partitioning (eq. 11/12)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PartitionMoments:
    """Ê, Ê_sp, Ĥ for dataset size S, batch B, workers M, replication C."""

    E: float
    E_sp: float
    H: float
    alpha: float = 1.0

    @property
    def beta_hat(self) -> float:  # eq. (12): β̂ = (1/α)·Ê/(√Ê_sp·Ĥ)
        return float((1.0 / self.alpha) * self.E / (np.sqrt(self.E_sp) * self.H))


def prop33_moments(
    *, M: int, S: int, B: int, C: int, grad_norm2: float, sigma2: float,
    alpha: float = 1.0,
) -> PartitionMoments:
    """Analytic estimators of eq. (11)/(12).

    Args:
      grad_norm2: ||∂F||₂² — squared norm of the full gradient.
      sigma2: σ² — trace of the covariance of per-datapoint subgradients.
    """
    if not (1 <= C <= M):
        raise ValueError("need 1 <= C <= M")
    if B > C * S // M:
        raise ValueError("batch cannot exceed local dataset size C·S/M")
    E = M * (grad_norm2 + (S - B) / (B * (S - 1)) * sigma2)
    E_sp = sigma2 * (M * C * (S - B) - C * S + M * B) / (C * B * (S - 1))
    H = np.sqrt(M) * np.sqrt(grad_norm2 + (M - C) / (C * (S - 1)) * sigma2)
    return PartitionMoments(E=float(E), E_sp=float(E_sp), H=float(H), alpha=alpha)


def monte_carlo_moments(
    per_point_grads: np.ndarray, *, M: int, B: int, C: int = 1,
    n_perm: int = 20, n_batch: int = 20, seed: int = 0,
) -> PartitionMoments:
    """Monte-Carlo estimate of the Prop. 3.3 moments — used to *verify* the
    proposition in tests.

    Args:
      per_point_grads: (S, n) array of per-datapoint subgradients at fixed w.
    """
    rng = np.random.default_rng(seed)
    S, n = per_point_grads.shape
    if (C * S) % M:
        raise ValueError("C*S must divide by M")
    local = C * S // M
    from repro_torch.data.partition import replicated_split

    Es, Esps, Gmeans = [], [], []
    for p_i in range(n_perm):
        parts = replicated_split(S, M, C, seed=seed * 10_000 + p_i)
        node_points = [list(p) for p in parts]
        Gmean_pi = np.stack(
            [per_point_grads[node_points[m]].mean(0) for m in range(M)], axis=1
        )
        Gmeans.append(Gmean_pi)
        for _ in range(n_batch):
            cols = []
            for m in range(M):
                sel = rng.choice(node_points[m], size=B, replace=False)
                cols.append(per_point_grads[sel].mean(0))
            G = np.stack(cols, axis=1)
            Es.append(np.linalg.norm(G, "fro") ** 2)
            D = G - G.mean(1, keepdims=True)
            Esps.append(np.linalg.norm(D, "fro") ** 2)
    H = float(np.mean([np.linalg.norm(G, "fro") for G in Gmeans]))
    return PartitionMoments(E=float(np.mean(Es)), E_sp=float(np.mean(Esps)), H=H)


# ---------------------------------------------------------------------------
# Fig. 3 procedure — predicted divergence iteration k'
# ---------------------------------------------------------------------------


def predicted_divergence_iteration(
    bound_fn: Callable[[np.ndarray, float], np.ndarray],
    *,
    lam2_sparse: float,
    lam2_dense: float,
    loss_curve_dense: np.ndarray,
    pct: float,
    K_max: int | None = None,
) -> float:
    """Iteration k' where the bound predicts sparse/dense losses differ by
    `pct` of the total training-loss decrease (paper Fig. 3 + Table 1).

    The bound is rescaled so the dense-topology bound curve is tangent to the
    dense experimental loss curve (footnote 9).

    Args:
      bound_fn: (K_array, lam2) -> bound values (suboptimality gap).
      loss_curve_dense: experimental loss per iteration for the dense topology.
    Returns k' (np.inf if beyond the experiment length).
    """
    T = len(loss_curve_dense)
    K = np.arange(1, T + 1, dtype=np.float64)
    b_dense = np.asarray(bound_fn(K, lam2_dense), np.float64)
    gap_dense = loss_curve_dense - loss_curve_dense.min()
    # tangency rescale: largest c with c*bound >= experimental gap everywhere
    with np.errstate(divide="ignore", invalid="ignore"):
        ratios = gap_dense / b_dense
    c = float(np.nanmax(ratios[np.isfinite(ratios)])) if np.any(np.isfinite(ratios)) else 1.0
    c = max(c, 1e-30)
    b_sparse = np.asarray(bound_fn(K, lam2_sparse), np.float64)
    total_drop = float(loss_curve_dense[0] - loss_curve_dense.min())
    if total_drop <= 0:
        return float("inf")
    diff = c * (b_sparse - b_dense) / total_drop
    idx = np.nonzero(diff >= pct)[0]
    k = float(K[idx[0]]) if len(idx) else float("inf")
    if K_max is not None and k > K_max:
        return float("inf")
    return k


# ---------------------------------------------------------------------------
# Appendix C — insensitivity horizons from prior work
# ---------------------------------------------------------------------------


def lian_horizon(*, L: float, M: int, sigma2: float, f0: float, lam2: float) -> float:
    """K_l of eq. (19) (Lian et al. 2017, Cor. 2)."""
    return 4 * L**4 * M**5 / (sigma2 * (f0 + L) ** 2 * (1 - lam2) ** 2)


def pu_horizon(*, L: float, M: int, mu: float, lam2: float) -> float:
    """K'_l of eq. (21) (Pu et al. 2019)."""
    g = 1 - lam2**2
    return 6912 * M * L**4 / (mu**4 * g**2) - 4 * L**2 / mu**2 - 7


# ---------------------------------------------------------------------------
# Toy example (App. F) — exact objective trajectory, eq. (78)
# ---------------------------------------------------------------------------


def toy_example_objective(k: np.ndarray, *, lam2: float, eta: float, zeta: float) -> np.ndarray:
    """max_i F(ŵ_i(k-1)) for the App. F toy problem — eq. (78)."""
    k = np.asarray(k, np.float64)
    s = np.where(k > 0, (1 - lam2**k) / (k * (1 - lam2)), 1.0)
    return 1 + zeta + eta * zeta / (1 - lam2) * (1 - s) - eta * zeta**2 * k / 2
