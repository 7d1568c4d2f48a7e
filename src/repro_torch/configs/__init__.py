"""Architecture registry: the configs whose model families the port runs.

granite-3-2b, deepseek-7b and chameleon-34b (dense SwiGLU GQA/MHA, the
last with qk-norm), gemma-2b (GeGLU, MQA at head dim 256, scaled
embeddings), nemotron-4-340b (squared ReLU, head dim 192) and mixtral-8x7b
(capacity-routed MoE with sliding-window attention), deepseek-v2-lite-16b
(MLA with 64 routed and 2 shared experts), mamba2-2.7b (Mamba-2 SSD, no
attention), recurrentgemma-2b (RG-LRU layers beside local MQA attention)
and seamless-m4t-large-v2 (an encoder over precomputed frame embeddings and
a decoder with cross-attention): every config of the reference."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "deepseek-7b": "deepseek_7b",
    "gemma-2b": "gemma_2b",
    "nemotron-4-340b": "nemotron_4_340b",
    "mixtral-8x7b": "mixtral_8x7b",
    "chameleon-34b": "chameleon_34b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "mamba2-2.7b": "mamba2_2_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
}

ARCH_NAMES = tuple(ARCH_MODULES)


def get_config(name: str, *, reduced: bool = False, **overrides) -> ModelConfig:
    if name not in ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[name]}")
    cfg: ModelConfig = mod.CONFIG
    if reduced:
        cfg = cfg.reduced()
        cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


__all__ = ["ModelConfig", "ARCH_NAMES", "get_config"]
