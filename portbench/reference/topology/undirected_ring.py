"""Consensus matrix of the undirected ring: each worker and its two
neighbours, a third each."""
import numpy as np

from portbench.reference.plain import uniform_over


def matrix(step: int, M: int) -> np.ndarray:
    return uniform_over([{j, (j + 1) % M, (j - 1) % M} for j in range(M)])
