"""Shared layers: RMSNorm, rotary embeddings, the SwiGLU MLP.

The port of the part of the reference's ``repro/models/layers.py`` the
dense GQA family uses; the other MLP variants and Mixture-of-Experts come
with their model families. Modules expose ``<name>_defs(cfg, ...)``
returning a ParamDef tree and ``<name>_apply(params, cfg, x, ...)``.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.params import ParamDef

PyTree = Any

__all__ = ["rmsnorm_defs", "rmsnorm_apply", "rope", "mlp_defs", "mlp_apply"]


def rmsnorm_defs(dim: int, axis: str = "embed") -> PyTree:
    return {"scale": ParamDef((dim,), (axis,), init="ones")}


def rmsnorm_apply(params: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's float32 frequencies, computed by numpy as it does,
    moved to ``device`` once: a host→device copy at every call would make
    the host wait for the device twice per layer (decode is host-bound)."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, split-halves layout (not interleaved), in float32.

    x: (..., L, H, hd); positions: (..., L).
    """
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs        # (..., L, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_defs(cfg: ModelConfig) -> PyTree:
    if cfg.mlp_type != "swiglu":
        raise ValueError(f"the port's MLP is SwiGLU only, not {cfg.mlp_type!r}")
    D, Fd = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamDef((D, Fd), ("embed", "ff")),
        "w_up": ParamDef((D, Fd), ("embed", "ff")),
        "w_down": ParamDef((Fd, D), ("ff", "embed")),
    }


def mlp_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU: (silu(x W_gate) * x W_up) W_down."""
    return (F.silu(x @ params["w_gate"]) * (x @ params["w_up"])) @ params["w_down"]
