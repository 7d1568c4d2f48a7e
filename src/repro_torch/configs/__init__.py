"""Architecture registry. Only the dense GQA family runs in the port so far,
so only granite-3-2b is registered; the reference's other nine configs come
with their model families (ROADMAP queue 1)."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.base import ModelConfig

ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
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
