"""Attention for training: dense and blockwise GQA.

The port of the training path of the reference's
``repro/models/attention.py``: ``dense_attention``, ``blockwise_attention``
(the online-softmax algorithm in plain PyTorch), ``attention_any`` and the
cache-free branch of ``gqa_apply``. Tensors keep the reference's
``(B, L, H, hd)`` layout. KV caches, MLA and cross-attention come with the
serving and model-family slices.

Where the reference asks for a float32 product of low-precision operands
(``preferred_element_type=float32``), :func:`f32_product` multiplies in the
operands' dtype and casts the result: identical for float32, one bf16
rounding of the scores for bf16 (ROADMAP queue 3 records it).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import rope
from repro_torch.models.params import ParamDef

PyTree = Any
NEG_INF = -1e30   # finite: a fully masked row recovers where -inf gives NaN

__all__ = ["NEG_INF", "repeat_kv", "dense_attention", "blockwise_attention",
           "attention_any", "gqa_defs", "gqa_apply", "f32_product"]


def f32_product(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum(eq, a, b)`` as float32 (see the module note for bf16)."""
    return torch.einsum(eq, a, b).float()


def _mask_bias(q_pos, kv_pos, *, causal: bool, window: int | None) -> torch.Tensor:
    """(Lq, Lkv) additive float32 bias from absolute positions."""
    qp = q_pos[:, None]
    kp = kv_pos[None, :]
    ok = torch.ones((qp.shape[0], kp.shape[1]), dtype=torch.bool, device=qp.device)
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def repeat_kv(x: torch.Tensor, H: int) -> torch.Tensor:
    """(B, L, Kh, hd) -> (B, L, H, hd)."""
    Kh = x.shape[2]
    if Kh == H:
        return x
    return torch.repeat_interleave(x, H // Kh, dim=2)


def dense_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                    scale=None) -> torch.Tensor:
    """q: (B, Lq, H, hd); k/v: (B, Lkv, Kh, hd); GQA kv repeated to H heads."""
    H, hd = q.shape[2], q.shape[3]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    s = f32_product("bqhd,bshd->bhqs", q, k)
    s = s * scale + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def blockwise_attention(q, k, v, q_base: int, *, causal=True, window=None,
                        q_chunk=1024, kv_chunk=1024, scale=None) -> torch.Tensor:
    """Flash-style attention; never materializes (Lq, Lkv) scores.

    Loops over q blocks; each q block visits only the kv blocks its mask can
    reach (causal / sliding window), carrying the running max, sum and
    accumulator in float32.
    """
    B, Lq, H, hd = q.shape
    Lkv = k.shape[1]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    nq = max(Lq // q_chunk, 1)
    q_chunk = Lq // nq
    nkv = max(Lkv // kv_chunk, 1)
    kv_chunk = Lkv // nkv
    dev = q.device

    outs = []
    for qb in range(nq):
        q_pos = q_base + qb * q_chunk + torch.arange(q_chunk, device=dev)
        qg = q[:, qb * q_chunk:(qb + 1) * q_chunk]
        hi = nkv if not causal else min(
            (q_base + (qb + 1) * q_chunk - 1) // kv_chunk + 1, nkv)
        lo = 0
        if window is not None:
            lo = max((q_base + qb * q_chunk - window + 1) // kv_chunk, 0)
        m = torch.full((B, H, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, H, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, q_chunk, v.shape[-1]), dtype=torch.float32, device=dev)
        for kb in range(lo, hi):
            ks = k[:, kb * kv_chunk:(kb + 1) * kv_chunk]
            vs = v[:, kb * kv_chunk:(kb + 1) * kv_chunk]
            kv_pos = kb * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = f32_product("bqhd,bshd->bhqs", qg, ks) * scale
            s = s + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(vs.dtype), vs).float()
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(o.to(q.dtype))
    out = torch.cat(outs, dim=2) if nq > 1 else outs[0]
    # (B, H, Lq, hd_v) -> (B, Lq, H, hd_v)
    return out.permute(0, 2, 1, 3)


def attention_any(q, k, v, q_base, *, causal=True, window=None, scale=None,
                  block_threshold=1024) -> torch.Tensor:
    """Dense for short kv, blockwise for long kv."""
    Lkv = k.shape[1]
    if Lkv <= block_threshold:
        q_pos = q_base + torch.arange(q.shape[1], device=q.device)
        kv_pos = torch.arange(Lkv, device=q.device)
        return dense_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, scale=scale)
    return blockwise_attention(q, k, v, q_base, causal=causal, window=window,
                               scale=scale)


def gqa_defs(cfg: ModelConfig) -> PyTree:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # explicit fan-in scales: the projections contract over d_model (wq/wk/wv)
    # or heads*head_dim (wo), not over the ParamDef default dim
    s_in = float(D) ** -0.5
    s_out = float(H * hd) ** -0.5
    return {
        "wq": ParamDef((D, H, hd), ("embed", "q_heads", None), scale=s_in),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", None), scale=s_in),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", None), scale=s_in),
        "wo": ParamDef((H, hd, D), ("q_heads", None, "embed"), scale=s_out),
    }


def gqa_apply(params, cfg: ModelConfig, x) -> torch.Tensor:
    """Causal self-attention over whole (B, L, D) sequences from position 0
    (the reference's training branch: no cache, no memory)."""
    q = torch.einsum("bld,dhk->blhk", x, params["wq"])
    k = torch.einsum("bld,dhk->blhk", x, params["wk"])
    v = torch.einsum("bld,dhk->blhk", x, params["wv"])
    pos = torch.arange(x.shape[1], device=x.device)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)
    o = attention_any(q, k, v, 0, causal=True)
    return torch.einsum("blhk,hkd->bld", o, params["wo"])
