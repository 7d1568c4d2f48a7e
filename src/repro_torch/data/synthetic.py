"""Synthetic datasets + per-worker minibatch pipeline.

A numpy-only copy of the reference's ``repro/data/synthetic.py``: the same
seed gives the same data and the same minibatches. ``WorkerBatcher`` draws
the per-worker minibatches ξ_j(k) of paper eq. (3) as numpy arrays;
``repro_torch.convert.to_device`` (or ``train``) puts them on the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["linear_regression_data", "classification_data", "token_stream",
           "WorkerBatcher"]


def linear_regression_data(S: int = 4096, n: int = 64, noise: float = 0.1,
                           seed: int = 0):
    """y = x·w* + ε.  Returns (X (S,n), y (S,), w_star)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S, n)).astype(np.float32)
    w_star = rng.normal(size=(n,)).astype(np.float32)
    y = X @ w_star + noise * rng.normal(size=(S,)).astype(np.float32)
    return X, y.astype(np.float32), w_star


def classification_data(S: int = 4096, n: int = 32, n_classes: int = 10,
                        sep: float = 3.0, seed: int = 0):
    """Gaussian mixture: class c centered at sep·μ_c. Returns (X, labels)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n)).astype(np.float32)
    centers *= sep / np.linalg.norm(centers, axis=1, keepdims=True)
    labels = rng.integers(0, n_classes, size=S)
    X = centers[labels] + rng.normal(size=(S, n)).astype(np.float32)
    return X.astype(np.float32), labels.astype(np.int32)


def token_stream(S: int = 2048, seq_len: int = 64, vocab: int = 512,
                 n_topics: int = 8, seed: int = 0):
    """(S, seq_len+1) int32 token sequences; each sequence drawn from one of
    n_topics unigram distributions (labels returned for split-by-label)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1)
    topics = []
    for t in range(n_topics):
        p = 1.0 / ranks ** (1.0 + 0.1 * t)
        p = rng.permutation(p)
        topics.append(p / p.sum())
    labels = rng.integers(0, n_topics, size=S)
    toks = np.stack([
        rng.choice(vocab, size=seq_len + 1, p=topics[labels[i]]) for i in range(S)
    ])
    return toks.astype(np.int32), labels.astype(np.int32)


@dataclasses.dataclass
class WorkerBatcher:
    """Draws per-worker minibatches from a partitioned dataset.

    arrays: tuple of arrays indexed along axis 0 (e.g. (X, y) or (tokens,)).
    parts:  (M, local) index matrix (see ``repro_torch.data.partition``).
    """

    arrays: tuple[np.ndarray, ...]
    parts: np.ndarray
    batch_size: int
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    @property
    def M(self) -> int:
        return self.parts.shape[0]

    def next(self) -> tuple[np.ndarray, ...]:
        """Returns arrays of shape (M, B, ...)."""
        idx = np.stack([
            self._rng.choice(self.parts[m], size=self.batch_size, replace=False)
            for m in range(self.M)
        ])
        return tuple(a[idx] for a in self.arrays)

    def full_local(self) -> tuple[np.ndarray, ...]:
        """Full local datasets, shape (M, local, ...)."""
        return tuple(a[self.parts] for a in self.arrays)
