"""Roofline terms of a step on the NVIDIA H100, from its recorded cost.

The counterpart of the reference's ``repro/launch/roofline.py``. Three
terms per (arch × shape × mesh), each the least time one card could take
for its share of a step:

    compute    = FLOPs / peak FLOP/s of the compute dtype
    memory     = bytes / HBM bytes/s
    collective = Σ collective result bytes / the rate of the slowest link
                 each collective's group spans

The FLOPs, bytes and collectives are a rank's, as
:func:`repro_torch.launch.cost.measure` records them from the step itself
(the reference reads them out of compiled HLO text). A collective's bytes
are its result's, per rank, the reference's convention: one consistent
measure of what goes onto the wire, not a model of each algorithm.

``MODEL_FLOPS`` = 6·N·D (dense) or 6·N_active·D (MoE) per trained token
gives the useful share of the counted FLOPs, which shows what recomputation
(``cfg.remat``) and padding cost.

The card's rates live here and only here; ``chip_smoke.py`` bounds its
kernels with them. Data-sheet values of the NVIDIA H100 SXM (H100 80GB
HBM3) at its 700 W power limit; a card set below it runs slower under load.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.cost import COLLECTIVES, Cost

__all__ = ["MEMORY_RATES", "F32_PEAK", "BF16_PEAK", "NVLINK_RATE", "NETWORK_RATE",
           "NODE_CARDS", "memory_rate", "peak_flops", "link_rate", "collective_bytes",
           "collective_counts", "model_flops", "active_params", "RooflineTerms", "analyze"]

# Device-memory rates (bytes/s) from NVIDIA's data sheets, by card name
# (first match wins).
MEMORY_RATES = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                ("H100", 3.35e12))
F32_PEAK = 67e12        # FLOP/s, float32 outside the tensor cores (H100 SXM data sheet)
BF16_PEAK = 989e12      # FLOP/s, bf16 dense tensor-core rate (H100 SXM data sheet)
# Links between cards. NVLink 4 within a node of 8 SXM cards: 900 GB/s per
# card both ways together, 450e9 B/s per direction (H100 SXM data sheet).
# Between nodes: one 400 Gb/s NDR InfiniBand port per card (the DGX H100
# layout), 50e9 B/s per direction.
NODE_CARDS = 8
NVLINK_RATE = 450e9
NETWORK_RATE = 50e9

DEFAULT_CARD = "NVIDIA H100 80GB HBM3"


def memory_rate(name: str) -> float:
    """The HBM rate (bytes/s) of the card named ``name``."""
    for key, bw in MEMORY_RATES:
        if key in name:
            return bw
    raise RuntimeError(f"no memory rate on record for {name!r}")


def peak_flops(dtype: str) -> float:
    """The peak FLOP/s of products in ``dtype`` ('bfloat16' or 'float32';
    float32 runs on the CUDA cores: the port keeps TF32 off)."""
    rates = {"bfloat16": BF16_PEAK, "float32": F32_PEAK}
    if dtype not in rates:
        raise ValueError(f"no peak rate on record for {dtype!r}")
    return rates[dtype]


def link_rate(ranks) -> float | None:
    """The rate (bytes/s) of the slowest link a group of global ``ranks``
    spans, ranks numbered node by node (``NODE_CARDS`` to a node); None for
    a group of one rank, which moves nothing."""
    ranks = set(ranks)
    if len(ranks) <= 1:
        return None
    return NVLINK_RATE if len({r // NODE_CARDS for r in ranks}) == 1 else NETWORK_RATE


def collective_bytes(events) -> dict[str, float]:
    """Per-kind result bytes of the recorded collectives, and their
    ``"total"``."""
    out: dict[str, float] = {c: 0.0 for c in COLLECTIVES}
    out["total"] = 0.0
    for ev in events:
        out[ev.kind] += ev.nbytes
        out["total"] += ev.nbytes
    return out


def collective_counts(events) -> dict[str, int]:
    counts = {c: 0 for c in COLLECTIVES}
    for ev in events:
        counts[ev.kind] += 1
    return counts


def model_flops(cfg: ModelConfig, n_tokens: int, kind: str = "train") -> float:
    """6·N_active·D for training, 2·N_active·D for inference forward."""
    n_active = active_params(cfg)
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens


def active_params(cfg: ModelConfig) -> float:
    """Parameters touched per token (MoE: top-k + shared experts only)."""
    total = cfg.n_params()
    if not cfg.n_experts:
        return float(total)
    gate = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[cfg.mlp_type]
    per_expert = gate * cfg.d_model * cfg.d_ff_expert
    n_moe_layers = sum(cfg.moe_layer_flags)
    inactive = (cfg.n_experts - cfg.top_k) * per_expert * n_moe_layers
    return float(total - inactive)


@dataclasses.dataclass
class RooflineTerms:
    flops: float               # per-rank FLOPs
    bytes_accessed: float      # per-rank bytes
    coll_bytes: float          # per-rank collective result bytes
    chips: int
    n_tokens: int
    model_flops_total: float   # 6·N·D (whole step, all chips)
    peak_bytes: float = 0.0    # per-rank peak live bytes
    coll_bytes_nvlink: float = 0.0    # the part of coll_bytes whose groups stay in a node
    coll_bytes_network: float = 0.0   # the part whose groups span nodes
    peak_flops: float = BF16_PEAK
    hbm_rate: float = memory_rate(DEFAULT_CARD)

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.hbm_rate

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_nvlink / NVLINK_RATE + self.coll_bytes_network / NETWORK_RATE

    @property
    def t_bound(self) -> float:
        """The least time of the step: the largest of the three terms."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / total counted FLOPs (all chips)."""
        total = self.flops * self.chips
        return self.model_flops_total / total if total else float("nan")

    def as_dict(self) -> dict[str, Any]:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "coll_bytes_per_chip": self.coll_bytes,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops_total": self.model_flops_total,
            "useful_flops_ratio": self.useful_flops_ratio,
            "chips": self.chips,
            "n_tokens": self.n_tokens,
            "peak_bytes_per_chip": self.peak_bytes,
            "coll_bytes_nvlink_per_chip": self.coll_bytes_nvlink,
            "coll_bytes_network_per_chip": self.coll_bytes_network,
        }


def analyze(cost: Cost, cfg: ModelConfig, *, chips: int, n_tokens: int,
            kind: str = "train", card: str = DEFAULT_CARD) -> RooflineTerms:
    """Roofline terms of a rank's recorded ``cost`` on the card named
    ``card``, its products at the peak of ``cfg.compute_dtype``."""
    by_rate = {NVLINK_RATE: 0.0, NETWORK_RATE: 0.0, None: 0.0}
    for ev in cost.collectives:
        by_rate[link_rate(ev.ranks)] += ev.nbytes
    return RooflineTerms(
        flops=cost.flops, bytes_accessed=cost.bytes,
        coll_bytes=collective_bytes(cost.collectives)["total"],
        chips=chips, n_tokens=n_tokens,
        model_flops_total=model_flops(cfg, n_tokens, kind), peak_bytes=cost.peak_bytes,
        coll_bytes_nvlink=by_rate[NVLINK_RATE], coll_bytes_network=by_rate[NETWORK_RATE],
        peak_flops=peak_flops(cfg.compute_dtype), hbm_rate=memory_rate(card))
