"""Consensus matrix of the clique: every worker, 1/M each."""
import numpy as np

from portbench.reference.plain import uniform_over


def matrix(step: int, M: int) -> np.ndarray:
    return uniform_over([set(range(M)) for _ in range(M)])
