"""Consensus matrix of the hypercube of 2**log2M workers: each worker and
the log2M workers whose index differs in one bit, equal weights."""
import numpy as np

from portbench.reference.plain import uniform_over


def matrix(step: int, log2M: int) -> np.ndarray:
    M = 1 << log2M
    return uniform_over([{j} | {j ^ (1 << b) for b in range(log2M)} for j in range(M)])
