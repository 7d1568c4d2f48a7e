"""Consensus matrix of the one-peer exponential graph at step ``step``
(Assran et al.): round r = (k + step) mod log2 M; each worker keeps half of
its parameters and takes half of the worker 2^r behind it, so each sends
half of its own to the worker 2^r ahead. Step 0 is the train step's first
(its state's step counter)."""
import numpy as np

from portbench.reference.plain import uniform_over


def matrix(step: int, M: int, k: int) -> np.ndarray:
    tau = M.bit_length() - 1
    if 1 << tau != M:
        raise ValueError(f"the one-peer exponential graph needs M a power of two, not {M}")
    off = 1 << ((k + step) % tau)
    return uniform_over([{j, (j - off) % M} for j in range(M)])
