"""Communication topologies and consensus matrices (paper §2, App. B/F/G).

A numpy-only copy of the reference's ``repro/core/topology.py``: the
``Topology`` container, the weight rules, the graph builders (regular,
random and expander), the Kronecker (multi-pod) builders and their two-stage
factorization, survivor repair for a partial fleet, the one-peer
time-varying graph, the permutation decompositions the gossip bus runs on,
and the spectral helpers (incl. the paper's energy fractions and α). ``A[i, j]`` is the weight node j
gives node i's estimate, so the consensus step is ``W(k+1) = W(k) @ A``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

__all__ = [
    "Topology", "clique", "undirected_ring", "ring_lattice",
    "directed_ring_lattice", "torus_2d", "hypercube", "star",
    "random_regular", "expander", "kronecker", "hier", "split_kronecker",
    "kronecker_factors", "edge_classes", "survivor_matrix", "survivor_column",
    "repair_hier_stages", "one_peer_exponential", "uniform_weights",
    "metropolis_weights", "circulant_decomposition",
    "permutation_decomposition", "spectral_gap", "second_eigenvalue_modulus",
    "spectral_projectors", "energy_fractions", "alpha_from_fractions",
    "BY_NAME", "make",
]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A communication graph + doubly stochastic, normal consensus matrix.

    ``circulant_offsets``: if node i listens to i+δ mod M for δ in offsets
    (δ=0 is the self loop), the sorted offset tuple; else None.
    ``group_of``: optional per-node group (pod) id, set by the hierarchical
    builders (:func:`kronecker`, :func:`hier`); None ⇒ no grouping.
    """

    name: str
    A: np.ndarray
    directed: bool = False
    circulant_offsets: tuple[int, ...] | None = None
    group_of: tuple[int, ...] | None = None

    def __post_init__(self):
        A = np.asarray(self.A, dtype=np.float64)
        object.__setattr__(self, "A", A)
        _check_consensus_matrix(A)
        if self.group_of is not None:
            g = tuple(int(x) for x in self.group_of)
            if len(g) != A.shape[0]:
                raise ValueError(
                    f"group_of must assign all {A.shape[0]} nodes, got {len(g)}")
            object.__setattr__(self, "group_of", g)

    @property
    def M(self) -> int:
        return self.A.shape[0]

    @property
    def in_degree(self) -> int:
        """Max in-degree excluding the self loop."""
        return int(max((np.count_nonzero(self.A[:, j]) - 1) for j in range(self.M)))

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

    def neighbors_in(self, j: int) -> np.ndarray:
        """In-neighborhood N_j (predecessors, excluding j itself)."""
        (idx,) = np.nonzero(self.A[:, j])
        return idx[idx != j]

    def neighbors_out(self, i: int) -> np.ndarray:
        (idx,) = np.nonzero(self.A[i, :])
        return idx[idx != i]

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


def star(M: int) -> Topology:
    """Star (hub-and-spoke), the PS physical topology; Metropolis weights."""
    adj = np.zeros((M, M), dtype=bool)
    adj[0, 1:] = adj[1:, 0] = True
    return Topology(name=f"star-{M}", A=metropolis_weights(adj), directed=False)


def random_regular(M: int, d: int, seed: int = 0, max_tries: int = 2000) -> Topology:
    """Random d-regular undirected simple graph via the pairing model."""
    if (M * d) % 2 or d >= M:
        raise ValueError("need M*d even and d < M")
    rng = np.random.default_rng(seed)
    for _ in range(max_tries):
        stubs = np.repeat(np.arange(M), d)
        rng.shuffle(stubs)
        pairs = stubs.reshape(-1, 2)
        if np.any(pairs[:, 0] == pairs[:, 1]):
            continue
        adj = np.zeros((M, M), dtype=bool)
        key = pairs.min(1) * M + pairs.max(1)
        if len(np.unique(key)) != len(key):  # multi-edge
            continue
        adj[pairs[:, 0], pairs[:, 1]] = True
        adj |= adj.T
        if _is_connected(adj):
            return Topology(name=f"rr-{M}-d{d}-s{seed}", A=uniform_weights(adj), directed=False)
    raise RuntimeError("failed to sample a connected random regular graph")


def expander(M: int, d: int, seed: int = 0, n_candidates: int = 50) -> Topology:
    """Best-of-N random regular graph by spectral gap (paper App. G)."""
    if d == 2:
        return undirected_ring(M)
    if d >= M - 1:
        return clique(M)
    best = None
    for s in range(n_candidates):
        t = random_regular(M, d, seed=seed * 10_000 + s)
        if best is None or t.spectral_gap > best.spectral_gap:
            best = t
    return dataclasses.replace(best, name=f"expander-{M}-d{d}")


def _is_connected(adj: np.ndarray) -> bool:
    M = adj.shape[0]
    seen = np.zeros(M, dtype=bool)
    stack = [0]
    seen[0] = True
    while stack:
        i = stack.pop()
        for j in np.nonzero(adj[i])[0]:
            if not seen[j]:
                seen[j] = True
                stack.append(int(j))
    return bool(seen.all())


def kronecker(outer: Topology, inner: Topology, name: str | None = None) -> Topology:
    """Hierarchical topology A_outer ⊗ A_inner (multi-pod): worker (p, i)
    mixes within its pod via A_inner and across pods via A_outer. Node (p, i)
    is index ``p·M_inner + i``; ``group_of`` records the pod id p."""
    A = np.kron(outer.A, inner.A)
    group_of = tuple(int(p) for p in np.repeat(np.arange(outer.M), inner.M))
    return Topology(
        name=name or f"kron({outer.name},{inner.name})", A=A,
        directed=outer.directed or inner.directed, group_of=group_of)


def hier(n_pods: int, pod_size: int, *, outer: str = "ring",
         inner: str = "clique") -> Topology:
    """A ring over pods ⊗ a clique within each pod by default; ``outer`` and
    ``inner`` name any builder of :data:`BY_NAME`."""
    return kronecker(make(outer, n_pods), make(inner, pod_size),
                     name=f"hier-{outer}{n_pods}x{inner}{pod_size}")


def split_kronecker(topo: Topology) -> tuple[Topology, Topology]:
    """Factor a :func:`kronecker` topology into its two M-node stages.

    ``intra.A = I_P ⊗ A_inner`` (every edge inside a pod) and
    ``inter.A = A_outer ⊗ I_s`` (every non-self edge crosses pods), with
    ``inter.A @ intra.A == topo.A``. Requires ``topo.group_of`` with equal
    contiguous groups."""
    A_outer, A_inner = kronecker_factors(topo)
    P_, s = A_outer.shape[0], A_inner.shape[0]
    intra = Topology(name=f"{topo.name}-intra", A=np.kron(np.eye(P_), A_inner),
                     directed=topo.directed, group_of=topo.group_of)
    inter = Topology(name=f"{topo.name}-inter", A=np.kron(A_outer, np.eye(s)),
                     directed=topo.directed, group_of=topo.group_of)
    return intra, inter


def kronecker_factors(topo: Topology) -> tuple[np.ndarray, np.ndarray]:
    """Recover (A_outer, A_inner) of a :func:`kronecker` topology.

    Block (p, q) of A is ``A_outer[p, q] · A_inner`` and A_inner's entries
    sum to s, so each block's total weight is ``s · A_outer[p, q]``. Raises
    ValueError if the topology is not a Kronecker product over equal
    contiguous groups."""
    if topo.group_of is None:
        raise ValueError(f"{topo.name} has no group metadata (not a kronecker)")
    g = np.asarray(topo.group_of)
    P_ = int(g.max()) + 1
    s = topo.M // P_
    if topo.M != P_ * s or not np.array_equal(g, np.repeat(np.arange(P_), s)):
        raise ValueError("split_kronecker needs equal contiguous groups")
    blocks = topo.A.reshape(P_, s, P_, s).transpose(0, 2, 1, 3)
    A_outer = blocks.sum((2, 3)) / s
    p0, q0 = np.unravel_index(int(np.argmax(A_outer)), A_outer.shape)
    A_inner = blocks[p0, q0] / A_outer[p0, q0]
    if not np.allclose(np.kron(A_outer, A_inner), topo.A, atol=1e-9):
        raise ValueError(f"{topo.name} is not a kronecker of its blocks")
    return A_outer, A_inner


# ---------------------------------------------------------------------------
# Survivor-renormalized mixing (fault tolerance: mix over a partial fleet)
# ---------------------------------------------------------------------------


def survivor_column(col: np.ndarray, j: int, keep: np.ndarray,
                    mode: str = "reabsorb") -> np.ndarray:
    """Repair column j of A for a partial set of usable estimates ``keep``.

    Dropped weight goes back to the self loop (``'reabsorb'``) or is spread
    over the survivors (``'renormalize'``); with everything kept the input
    column comes back bit-identical."""
    col = np.asarray(col, np.float64).copy()
    keep = np.asarray(keep, dtype=bool)
    drop = ~keep
    drop[j] = False          # worker j always holds its own estimate
    if not drop.any():
        return col
    lost = float(col[drop].sum())
    col[drop] = 0.0
    if mode == "reabsorb":
        col[j] += lost
    elif mode == "renormalize":
        s = col.sum()
        if s <= 0.0:
            col[j] = 1.0
        else:
            col /= s
    else:
        raise ValueError(f"survivor mode must be reabsorb|renormalize, got {mode!r}")
    return col


def survivor_matrix(A: np.ndarray, alive: np.ndarray,
                    mode: str = "reabsorb") -> np.ndarray:
    """Repair a consensus matrix for a partial worker fleet (a raw matrix).

    Dead workers are isolated (identity row and column: they hold their last
    state and feed nobody); every live column is repaired by
    :func:`survivor_column`. A full live-mask returns a copy of A."""
    A = np.asarray(A, np.float64)
    alive = np.asarray(alive, dtype=bool)
    if alive.shape != (A.shape[0],):
        raise ValueError(f"live mask covers {alive.shape} workers, "
                         f"matrix is {A.shape}")
    if not alive.any():
        raise ValueError("survivor_matrix needs at least one live worker")
    out = A.copy()
    if alive.all():
        return out
    M = A.shape[0]
    for j in range(M):
        if alive[j]:
            out[:, j] = survivor_column(A[:, j], j, alive, mode)
        else:
            out[:, j] = 0.0
            out[j, j] = 1.0
    return out


def _bridge_adjacency(adj: np.ndarray, node_alive: np.ndarray) -> np.ndarray:
    """Contract dead nodes out of an undirected graph: live p and q become
    adjacent iff a path whose interior is entirely dead joins them."""
    new = np.zeros_like(adj)
    for p in np.nonzero(node_alive)[0]:
        stack = list(np.nonzero(adj[p])[0])
        seen = {int(p)}
        while stack:
            q = int(stack.pop())
            if q in seen:
                continue
            seen.add(q)
            if node_alive[q]:
                new[p, q] = new[q, p] = True
            else:
                stack.extend(np.nonzero(adj[q])[0])
    np.fill_diagonal(new, False)
    return new


def repair_hier_stages(topo: Topology, alive: np.ndarray,
                       mode: str = "reabsorb") -> tuple[np.ndarray, np.ndarray]:
    """Re-plan the two hierarchical stages for a partial fleet.

    Returns raw ``(intra_A, inter_A)`` with ``inter_A @ intra_A`` the repaired
    step: each pod's inner block survivor-repaired; pods that lost every
    member contracted out of the outer graph (neighbours bridged, fresh
    Metropolis weights), then the per-worker survivor repair. A directed or
    asymmetric outer factor gets the plain survivor repair. A full live-mask
    gives exactly :func:`split_kronecker`'s stages."""
    alive = np.asarray(alive, dtype=bool)
    intra_t, inter_t = split_kronecker(topo)
    if alive.all():
        return intra_t.A.copy(), inter_t.A.copy()
    intra_A = survivor_matrix(intra_t.A, alive, mode)
    g = np.asarray(topo.group_of)
    P_ = int(g.max()) + 1
    s = topo.M // P_
    pod_alive = np.array([bool(alive[g == p].any()) for p in range(P_)])
    if pod_alive.all() or topo.directed:
        inter_A = survivor_matrix(inter_t.A, alive, mode)
    else:
        A_outer, _ = kronecker_factors(topo)
        adj = A_outer > 1e-12
        np.fill_diagonal(adj, False)
        if not np.array_equal(adj, adj.T):
            inter_A = survivor_matrix(inter_t.A, alive, mode)
        else:
            bridged = _bridge_adjacency(adj, pod_alive)
            A_outer2 = metropolis_weights(bridged)
            inter_A = survivor_matrix(np.kron(A_outer2, np.eye(s)), alive, mode)
    return intra_A, inter_A


def edge_classes(topo: Topology, group_of: Sequence[int] | None = None
                 ) -> dict[str, list[tuple[int, int]]]:
    """Split the directed edges (src i, dst j) into intra-group ``'ici'`` and
    cross-group ``'dci'`` classes, in row-major order. ``group_of`` defaults
    to the topology's own; with no grouping every edge is ICI."""
    g = group_of if group_of is not None else topo.group_of
    if g is None:
        g = np.zeros(topo.M, dtype=int)
    g = np.asarray(g, dtype=int)
    if len(g) != topo.M:
        raise ValueError(f"group_of covers {len(g)} nodes, topology has {topo.M}")
    out: dict[str, list[tuple[int, int]]] = {"ici": [], "dci": []}
    ii, jj = np.nonzero(topo.A)
    for i, j in zip(ii.tolist(), jj.tolist()):
        if i == j:
            continue
        out["dci" if g[i] != g[j] else "ici"].append((i, j))
    return out


def one_peer_exponential(M: int, k: int) -> Topology:
    """Time-varying one-peer exponential graph (Assran et al.): at step k each
    node averages with the single peer at offset 2^(k mod log2 M)."""
    if M & (M - 1):
        raise ValueError("one_peer_exponential needs M a power of two")
    tau = int(np.log2(M))
    off = 1 << (k % tau)
    A = 0.5 * (np.eye(M) + np.roll(np.eye(M), off, axis=1))
    # roll of identity is a permutation => A normal & doubly stochastic.
    return Topology(name=f"onepeer-{M}-k{k % tau}", A=A, directed=True,
                    circulant_offsets=(0, off))


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


def energy_fractions(G_rows: np.ndarray, A: np.ndarray) -> np.ndarray:
    """Normalized energy fractions e_q of ΔG in each eigenspace (paper eq. 32):
    e[0] is the λ1 = 1 subspace (set to 0) and Σ_{q≥1} e[q] = 1."""
    lam, projs = spectral_projectors(A)
    G = np.asarray(G_rows, np.float64)
    energies = np.array([float(np.linalg.norm(G @ P, "fro") ** 2) for P in projs])
    total = energies[1:].sum()
    if total <= 0:
        e = np.zeros_like(energies)
        if len(e) > 1:
            e[1] = 1.0
        return e
    e = energies / total
    e[0] = 0.0
    return e


def alpha_from_fractions(e: np.ndarray, lambdas: np.ndarray) -> float:
    """α (paper eq. 6): effective energy fraction in the λ2 subspace."""
    lam2 = abs(lambdas[1]) if len(lambdas) > 1 else 0.0
    if lam2 == 0:
        return 1.0
    ratios = np.abs(lambdas[1:]) / lam2
    return float(np.sqrt(np.sum(e[1:] * ratios**2)))


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
    "star": star,
    "random_regular": random_regular,
    "expander": expander,
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
