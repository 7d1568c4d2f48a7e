"""Dataset partitioning across workers (paper §2/§3).

A numpy-only copy of the reference's random-split path
(``repro/data/partition.py``); the same seed gives the same parts.
"""
from __future__ import annotations

import numpy as np

__all__ = ["random_split", "pad_to_equal"]


def random_split(n: int, M: int, seed: int = 0) -> list[np.ndarray]:
    """Random equal split of indices 0..n-1 into M parts."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, M)]


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
