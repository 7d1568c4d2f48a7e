"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427].

The port of the reference's ``repro/models/rglru.py``: ``rglru_defs``,
``RGLRUCache``/``init_rglru_cache``, ``_gates`` and ``rglru_apply``. The
Real-Gated Linear Recurrent Unit:

    r_t = σ(x_t W_a + b_a)            (recurrence gate)
    i_t = σ(x_t W_x + b_x)            (input gate)
    a_t = exp(-c · softplus(Λ) · r_t) (per-channel decay, c = 8)
    h_t = a_t ⊙ h_{t-1} + √(1 - a_t²) ⊙ (i_t ⊙ x_t)

inside Griffin's recurrent block: linear in → causal conv(4) → RG-LRU on one
branch, linear + GELU (tanh form) on the other, multiplied, linear out.

Training and prefill evaluate the linear recurrence with a log-depth scan
in float32 (:func:`linear_scan`), where the reference calls
``jax.lax.associative_scan``: ⌈log₂ L⌉ doubling passes, each out of place,
so the train step's ``vmap`` batches it and a long prompt costs a few dozen
launches per layer, not one per position. Its float operations come in
another order than XLA's scan (ROADMAP queue 3). Decode is the O(1) update.
The cache is written in place, as ``KVCache`` is.

Inside ``launch.mesh.model_parallel``, with the width W cut over the model
axis (the reference's ``lru`` specs: the input projections' and the conv's
columns, the gates' biases and ``lambda_p``, the rows of ``wa``, ``wx``
and ``w_out``), the block is tensor parallel: ``x`` enters through
``copy_to_model``, the depthwise conv runs on the rank's W/k channels, and
each gate product ``conv @ wa`` (a partial sum over W) is summed over the
model group and cut to the rank's columns
(``tensor_parallel.reduce_scatter_model``); the gates and the scan are
elementwise on those columns, and the output projection's partial sum
leaves through ``reduce_from_model``. The cache holds the rank's W/k
channels.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import model_shard
from repro_torch.models.layers import _gelu
from repro_torch.models.params import ParamDef

PyTree = Any
C_RGLRU = 8.0

__all__ = ["rglru_defs", "RGLRUCache", "init_rglru_cache", "linear_scan", "rglru_apply"]


def rglru_defs(cfg: ModelConfig) -> PyTree:
    D = cfg.d_model
    W = cfg.lru_width or D
    return {
        "w_in_rec": ParamDef((D, W), ("embed", "lru")),
        "w_in_gate": ParamDef((D, W), ("embed", "lru")),
        "conv_w": ParamDef((4, W), (None, "lru"), scale=0.5),
        "conv_b": ParamDef((W,), ("lru",), init="zeros"),
        "wa": ParamDef((W, W), ("lru", None), scale=0.02),
        "ba": ParamDef((W,), ("lru",), init="zeros"),
        "wx": ParamDef((W, W), ("lru", None), scale=0.02),
        "bx": ParamDef((W,), ("lru",), init="zeros"),
        "lambda_p": ParamDef((W,), ("lru",), init="ones"),
        "w_out": ParamDef((W, D), ("lru", "embed")),
    }


class RGLRUCache(NamedTuple):
    conv: torch.Tensor   # (B, 3, W): the last inputs of the causal conv
    h: torch.Tensor      # (B, W) float32
    pos: int


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, layers: int | None = None) -> RGLRUCache:
    """An empty cache; inside ``launch.mesh.model_parallel`` the rank's
    W/k channels where k divides the width."""
    shard, W = model_shard(), cfg.lru_width or cfg.d_model
    W = W // shard.k if shard is not None and W % shard.k == 0 else W
    lead = (batch,) if layers is None else (layers, batch)
    return RGLRUCache(torch.zeros(lead + (3, W), dtype=dtype, device=device),
                      torch.zeros(lead + (W,), dtype=torch.float32, device=device), 0)


def _gates(params, x, cut: bool = False):
    """The decay and input terms of the conv output ``x``; ``cut``: ``x``
    holds the rank's channels, so each gate product is a partial sum over
    the model group (module note)."""
    gate = (lambda t: tp.reduce_scatter_model(t, -1)) if cut else (lambda t: t)
    r = torch.sigmoid(gate(x @ params["wa"]) + params["ba"]).float()
    i = torch.sigmoid(gate(x @ params["wx"]) + params["bx"]).float()
    log_a = -C_RGLRU * F.softplus(params["lambda_p"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 0.0)) * (i * x.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t from h_{-1} = 0, along dim 1, in ⌈log₂ L⌉
    doubling passes: after the pass of stride d, (a_t, b_t) compose the
    steps t-2d+1 … t, i.e. ``(a, b) ← (a·a_shift, a·b_shift + b)`` with the
    shifted operands padded by the identity (1, 0)."""
    L = a.shape[1]
    d = 1
    while d < L:
        a_shift = torch.cat([torch.ones_like(a[:, :d]), a[:, :-d]], dim=1)
        b_shift = torch.cat([torch.zeros_like(b[:, :d]), b[:, :-d]], dim=1)
        b = a * b_shift + b
        a = a * a_shift
        d *= 2
    return b


def rglru_apply(params, cfg: ModelConfig, x, *, cache: RGLRUCache | None = None):
    """x: (B, L, D) -> ((B, L, D), new cache or None)."""
    B, L, D = x.shape
    W = params["wa"].shape[-2]                  # the rank's channels on the model axis
    cut = W < (cfg.lru_width or D)
    if cut:
        x = tp.copy_to_model(x)
    gate = _gelu(x @ params["w_in_gate"])
    xr = x @ params["w_in_rec"]

    if cache is None or L > 1:
        xp = torch.cat([xr.new_zeros((B, 3, W)), xr], dim=1)
        conv = sum(xp[:, i:i + L] * params["conv_w"][i][None, None] for i in range(4))
        conv = conv + params["conv_b"]
        a, bterm = _gates(params, conv, cut)                       # (B, L, W) each
        h = linear_scan(a, bterm)
        new_cache = None
        if cache is not None:         # prefill
            cache.conv.copy_(xp[:, L:])
            cache.h.copy_(h[:, -1])
            new_cache = RGLRUCache(cache.conv, cache.h, cache.pos + L)
    else:
        hist = torch.cat([cache.conv, xr], dim=1)                  # (B, 4, W)
        conv = torch.einsum("bkw,kw->bw", hist, params["conv_w"]) + params["conv_b"]
        a, bterm = _gates(params, conv[:, None], cut)
        h = (a[:, 0] * cache.h + bterm[:, 0])[:, None]
        cache.conv.copy_(hist[:, 1:])
        cache.h.copy_(h[:, 0])
        new_cache = RGLRUCache(cache.conv, cache.h, cache.pos + 1)

    y = (h.to(x.dtype) * gate) @ params["w_out"]
    return (tp.reduce_from_model(y) if cut else y), new_cache
