"""Communication topologies and consensus matrices (paper §2, App. B/F/G).

A numpy-only copy of the reference's ``repro/core/topology.py``, cut to what
the decentralized train step needs: the ``Topology`` container, the weight
rules, the regular graph builders, the permutation decompositions the gossip
bus runs on, and the spectral helpers. ``A[i, j]`` is the weight node j
gives node i's estimate, so the consensus step is ``W(k+1) = W(k) @ A``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "Topology", "clique", "undirected_ring", "ring_lattice",
    "directed_ring_lattice", "torus_2d", "hypercube", "uniform_weights",
    "metropolis_weights", "circulant_decomposition",
    "permutation_decomposition", "spectral_gap", "second_eigenvalue_modulus",
    "spectral_projectors", "BY_NAME", "make",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication graph + doubly stochastic, normal consensus matrix.

    ``circulant_offsets``: if node i listens to i+δ mod M for δ in offsets
    (δ=0 is the self loop), the sorted offset tuple; else None.
    """

    name: str
    A: np.ndarray
    directed: bool = False
    circulant_offsets: tuple[int, ...] | None = None

    def __post_init__(self):
        A = np.asarray(self.A, dtype=np.float64)
        object.__setattr__(self, "A", A)
        _check_consensus_matrix(A)

    @property
    def M(self) -> int:
        return self.A.shape[0]

    @functools.cached_property
    def eigenvalues(self) -> np.ndarray:
        """Eigenvalues sorted by decreasing modulus (λ1 = 1 first)."""
        lam = np.linalg.eigvals(self.A)
        return lam[np.argsort(-np.abs(lam), kind="stable")]

    @property
    def lambda2(self) -> float:
        return float(np.abs(self.eigenvalues[1])) if self.M > 1 else 0.0

    @property
    def spectral_gap(self) -> float:
        return 1.0 - self.lambda2

    def permutations(self) -> list[tuple[float, np.ndarray]]:
        """Weighted permutations summing to A: the circulant closed form when
        it applies (one per offset, identity included), else Birkhoff peeling."""
        if self.circulant_offsets is not None:
            out = circulant_decomposition(self.A)
            if out is not None:
                return out
        return permutation_decomposition(self.A)


def _check_consensus_matrix(A: np.ndarray, tol: float = 1e-9) -> None:
    if A.ndim != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"consensus matrix must be square, got {A.shape}")
    if np.any(A < -tol):
        raise ValueError("consensus matrix must be non-negative")
    if not np.allclose(A.sum(0), 1.0, atol=1e-7) or not np.allclose(A.sum(1), 1.0, atol=1e-7):
        raise ValueError("consensus matrix must be doubly stochastic")
    if not np.allclose(A.T @ A, A @ A.T, atol=1e-7):
        raise ValueError("consensus matrix must be normal (A^T A = A A^T)")


# ---------------------------------------------------------------------------
# Weight rules
# ---------------------------------------------------------------------------


def uniform_weights(adj: np.ndarray) -> np.ndarray:
    """A_ij = 1/(d+1) for regular graphs with self-loops (paper App. F)."""
    M = adj.shape[0]
    adj = adj.astype(bool) | np.eye(M, dtype=bool)
    deg = adj.sum(0)
    if not np.all(deg == deg[0]):
        raise ValueError("uniform weights need a regular graph; use metropolis_weights")
    return adj.astype(np.float64) / deg[0]


def metropolis_weights(adj: np.ndarray) -> np.ndarray:
    """Metropolis–Hastings weights: doubly stochastic for any undirected graph."""
    M = adj.shape[0]
    adj = adj.astype(bool)
    np.fill_diagonal(adj, False)
    if not np.array_equal(adj, adj.T):
        raise ValueError("metropolis weights require an undirected graph")
    deg = adj.sum(0)
    A = np.zeros((M, M))
    ii, jj = np.nonzero(adj)
    A[ii, jj] = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    np.fill_diagonal(A, 1.0 - A.sum(0))
    return A


# ---------------------------------------------------------------------------
# Graph builders
# ---------------------------------------------------------------------------


def _circulant(M: int, offsets: Sequence[int], name: str, directed: bool) -> Topology:
    offsets = tuple(sorted({o % M for o in offsets} | {0}))
    A = np.zeros((M, M))
    w = 1.0 / len(offsets)
    for d in offsets:
        # node j listens to node (j + d) mod M  ⇒  A[(j+d)%M, j] = w
        idx = (np.arange(M) + d) % M
        A[idx, np.arange(M)] += w
    return Topology(name=name, A=A, directed=directed, circulant_offsets=offsets)


def clique(M: int) -> Topology:
    """Fully connected: A = 11^T / M."""
    return _circulant(M, tuple(range(M)), f"clique-{M}", directed=False)


def undirected_ring(M: int) -> Topology:
    """Cycle graph, degree 2 (the paper's sparsest undirected topology)."""
    return _circulant(M, (1, M - 1), f"ring-{M}", directed=False)


def ring_lattice(M: int, d: int) -> Topology:
    """Undirected d-regular ring lattice (paper App. F): i ↔ i±1..i±d/2."""
    if d % 2 or d >= M:
        raise ValueError("ring_lattice needs even d < M")
    offs = [k for k in range(1, d // 2 + 1)] + [M - k for k in range(1, d // 2 + 1)]
    return _circulant(M, offs, f"ring_lattice-{M}-d{d}", directed=False)


def directed_ring_lattice(M: int, d: int) -> Topology:
    """Directed regular ring lattice (paper App. G): i listens to i+1..i+d."""
    if not 1 <= d < M:
        raise ValueError("need 1 <= d < M")
    return _circulant(M, range(1, d + 1), f"dir_ring_lattice-{M}-d{d}", directed=True)


def torus_2d(rows: int, cols: int) -> Topology:
    """2-D torus, degree 4."""
    M = rows * cols
    adj = np.zeros((M, M), dtype=bool)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for rr, cc in (((r + 1) % rows, c), ((r - 1) % rows, c), (r, (c + 1) % cols), (r, (c - 1) % cols)):
                adj[i, rr * cols + cc] = True
    np.fill_diagonal(adj, False)
    deg = adj.sum(0)
    A = uniform_weights(adj) if np.all(deg == deg[0]) else metropolis_weights(adj)
    return Topology(name=f"torus-{rows}x{cols}", A=A, directed=False)


def hypercube(log2M: int) -> Topology:
    """Hypercube on 2^log2M nodes (degree log2M); neighbors via bit flips."""
    M = 1 << log2M
    adj = np.zeros((M, M), dtype=bool)
    for i in range(M):
        for b in range(log2M):
            adj[i, i ^ (1 << b)] = True
    return Topology(name=f"hypercube-{M}", A=uniform_weights(adj), directed=False)


# ---------------------------------------------------------------------------
# Spectral analysis (paper §3, App. B)
# ---------------------------------------------------------------------------


def second_eigenvalue_modulus(A: np.ndarray) -> float:
    lam = np.linalg.eigvals(np.asarray(A, np.float64))
    return float(np.sort(np.abs(lam))[-2]) if A.shape[0] > 1 else 0.0


def spectral_gap(A: np.ndarray) -> float:
    return 1.0 - second_eigenvalue_modulus(A)


def spectral_projectors(A: np.ndarray, tol: float = 1e-8):
    """Spectral decomposition A = Σ_q λ_q P_q with orthogonal projectors,
    distinct eigenvalues sorted by decreasing modulus (real for symmetric A)."""
    A = np.asarray(A, np.float64)
    if np.allclose(A, A.T, atol=1e-10):
        lam, V = np.linalg.eigh(A)
    else:
        lam, V = np.linalg.eig(A)
    order = np.argsort(-np.abs(lam), kind="stable")
    lam, V = lam[order], V[:, order]
    groups: list[list[int]] = []
    for i, l in enumerate(lam):
        for g in groups:
            if abs(lam[g[0]] - l) < tol:
                g.append(i)
                break
        else:
            groups.append([i])
    lambdas, projectors = [], []
    for g in groups:
        Q, _ = np.linalg.qr(V[:, g])   # orthonormalize inside the eigenspace
        lambdas.append(lam[g[0]])
        projectors.append(Q @ Q.conj().T)
    return np.asarray(lambdas), projectors


# ---------------------------------------------------------------------------
# Permutation decomposition (Birkhoff-style peeling on the graph support)
# ---------------------------------------------------------------------------


def circulant_decomposition(A: np.ndarray, tol: float = 1e-12) -> list[tuple[float, np.ndarray]] | None:
    """Closed-form decomposition of a circulant A into cyclic-shift perms, or
    None when A is not truly circulant."""
    A = np.asarray(A, np.float64)
    M = A.shape[0]
    cols = np.arange(M)
    recon = np.zeros_like(A)
    out: list[tuple[float, np.ndarray]] = []
    for d in np.nonzero(A[:, 0] > tol)[0]:
        w = float(A[d, 0])
        perm = (cols + d) % M
        recon[perm, cols] += w
        out.append((w, perm))
    if not np.allclose(recon, A, atol=1e-9):
        return None
    out.sort(key=lambda t: -t[0])
    return out


def permutation_decomposition(A: np.ndarray, tol: float = 1e-12) -> list[tuple[float, np.ndarray]]:
    """Decompose a doubly-stochastic A into Σ w_p · Perm_p.

    ``perm[j]`` is the source node whose estimate node j receives in that
    round; the identity permutation (self weights) is included.
    """
    A = np.asarray(A, np.float64).copy()
    M = A.shape[0]
    out: list[tuple[float, np.ndarray]] = []
    while A.max() > tol:
        perm = _perfect_matching(A > tol)
        if perm is None:
            raise RuntimeError("Birkhoff peeling failed (no perfect matching)")
        w = float(A[perm, np.arange(M)].min())
        A[perm, np.arange(M)] -= w
        out.append((w, perm))
    out.sort(key=lambda t: -t[0])
    return out


def _perfect_matching(support: np.ndarray) -> np.ndarray | None:
    """Perfect matching rows→cols via augmenting paths: perm[j] = i, or None."""
    M = support.shape[0]
    match_col = -np.ones(M, dtype=int)  # col j -> row i
    match_row = -np.ones(M, dtype=int)

    def augment(i: int, visited: np.ndarray) -> bool:
        for j in np.nonzero(support[i])[0]:
            if visited[j]:
                continue
            visited[j] = True
            if match_col[j] < 0 or augment(match_col[j], visited):
                match_col[j] = i
                match_row[i] = j
                return True
        return False

    for i in range(M):
        if not augment(i, np.zeros(M, dtype=bool)):
            return None
    return match_col


BY_NAME: dict[str, Callable[..., Topology]] = {
    "clique": clique,
    "ring": undirected_ring,
    "ring_lattice": ring_lattice,
    "directed_ring_lattice": directed_ring_lattice,
    "torus": torus_2d,
    "hypercube": hypercube,
}


def make(name: str, M: int, **kw) -> Topology:
    """Build a topology by name with M nodes (degree etc. via kwargs)."""
    if name == "torus":
        side = int(np.sqrt(M))
        if side * side != M:
            raise ValueError("torus needs square M")
        return torus_2d(side, side)
    if name == "hypercube":
        l = int(np.log2(M))
        if 1 << l != M:
            raise ValueError("hypercube needs M power of two")
        return hypercube(l)
    return BY_NAME[name](M, **kw)
