"""Dataset partitioning across workers (paper §2/§3).

A numpy-only copy of the reference's ``repro/data/partition.py``: the random
split, the replicated split of Prop. 3.3 and the split by label; the same
seed gives the same parts.
"""
from __future__ import annotations

import numpy as np

__all__ = ["random_split", "replicated_split", "split_by_label", "pad_to_equal"]


def random_split(n: int, M: int, seed: int = 0) -> list[np.ndarray]:
    """Random equal split of indices 0..n-1 into M parts."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, M)]


def replicated_split(n: int, M: int, C: int, seed: int = 0,
                     max_repair: int = 100_000) -> list[np.ndarray]:
    """Random permutation of the C-expanded dataset with the Prop. 3.3
    constraint that the C copies of a point land at C *distinct* nodes,
    sampled by shuffle + swap-repair."""
    if not 1 <= C <= M:
        raise ValueError("need 1 <= C <= M")
    if (n * C) % M:
        raise ValueError("C*n must divide by M for equal local datasets")
    rng = np.random.default_rng(seed)
    if C == M:  # full replication: every node holds the whole dataset
        return [np.arange(n) for _ in range(M)]
    expanded = np.repeat(np.arange(n), C)
    rng.shuffle(expanded)
    local = n * C // M
    parts = expanded.reshape(M, local)
    if C == 1:
        return [np.sort(p) for p in parts]
    for _ in range(max_repair):
        dup = None
        for m in range(M):
            vals, counts = np.unique(parts[m], return_counts=True)
            bad = vals[counts > 1]
            if len(bad):
                dup = (m, bad[0])
                break
        if dup is None:
            return [np.sort(p) for p in parts]
        m, point = dup
        i = int(np.nonzero(parts[m] == point)[0][1])  # second copy
        # swap with a random slot at another node that creates no new dup
        for _ in range(200):
            m2 = int(rng.integers(M))
            if m2 == m:
                continue
            j = int(rng.integers(local))
            other = parts[m2][j]
            if other != point and point not in parts[m2] and \
               np.count_nonzero(parts[m] == other) == 0:
                parts[m][i], parts[m2][j] = other, point
                break
    raise RuntimeError("swap repair did not converge")


def split_by_label(labels: np.ndarray, M: int, seed: int = 0) -> list[np.ndarray]:
    """All examples of a label go to the same node (paper's split-by-digit);
    labels are dealt to nodes round-robin after shuffling the label ids."""
    rng = np.random.default_rng(seed)
    uniq = rng.permutation(np.unique(labels))
    parts: list[list[int]] = [[] for _ in range(M)]
    for i, lab in enumerate(uniq):
        parts[i % M].extend(np.nonzero(labels == lab)[0])
    return [np.sort(np.asarray(p)) for p in parts]


def pad_to_equal(parts: list[np.ndarray], seed: int = 0) -> np.ndarray:
    """Stack parts to (M, local) by resampling short parts (with replacement)."""
    rng = np.random.default_rng(seed)
    local = max(len(p) for p in parts)
    out = []
    for p in parts:
        if len(p) < local:
            extra = rng.choice(p, size=local - len(p), replace=True)
            p = np.concatenate([p, extra])
        out.append(np.sort(p))
    return np.stack(out)
