"""The benchmark's frozen arithmetic: the card's peaks and the work a step needs.

Counted from a configuration file's published shapes, through the
benchmark's own tensor layout (``weights.layout``, each layer's tensors
given by its family's file), never from what the program launches, so a
later change to the program can move the time but not the count. A
parameter is an element of a drawn tensor: embeddings, attention or MLA
projections, MLPs, routers and experts; norm scales are left out, as the
port's ``ModelConfig.n_params`` and ``launch.roofline.active_params``
counted them when this benchmark was written. A token touches a routed
layer's ``experts.*`` tensors in the share top-k / experts that its family
gives (``routed``).

Peaks are NVIDIA's data-sheet values for the H100 SXM (80 GB HBM3) at its
700 W power limit; a card set below it runs slower, and every result line
carries the card's name beside the numbers.
"""
from __future__ import annotations

from portbench import harness, weights

BF16_PEAK_FLOPS = 989e12      # dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12     # HBM3

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _counted(c: dict) -> list[tuple[str, int]]:
    return [(n, weights.numel(s)) for n, s, sd in weights.layout(c) if sd != "ones"]


def n_params(c: dict) -> int:
    """Parameters of one replica."""
    return sum(k for _, k in _counted(c))


def active_params(c: dict) -> int:
    """Parameters a token touches: of routed experts, top-k of them."""
    share = harness.family(c["model_type"]).routed(c)
    if share is None:
        return n_params(c)
    E, k = share
    return sum(n_ * k // E if ".experts." in n else n_ for n, n_ in _counted(c))


def train_flops(c: dict, tokens: int) -> float:
    """Model FLOPs of training on ``tokens`` tokens: 6·N_active per token
    (recomputation under remat is not counted)."""
    return 6.0 * active_params(c) * tokens


def param_bytes(c: dict) -> int:
    return n_params(c) * DTYPE_BYTES[c["torch_dtype"]]


def mix_bytes(c: dict, M: int) -> int:
    """Bytes one consensus step over M replicas must move at the least: the
    params and the updates read once and the result written once, each
    M·P elements in the configured dtype. Neither neighbour copies nor
    padding are counted, whatever implements the mix."""
    return 3 * M * param_bytes(c)
