"""Plain reference of Granite's dense GQA decoder.

The embedding times ``embedding_multiplier``; pre-norm blocks:
x + residual_multiplier·attention(RMSNorm(x)), then
x + residual_multiplier·SwiGLU(RMSNorm(x)); grouped-query attention, causal,
rotary embeddings (halves layout) on q and k, scores scaled by
``attention_multiplier``, no dropout; a final RMSNorm; logits against the
tied embedding (or ``lm_head``) over ``logits_scaling``. Every multiplier is
read from the configuration file. Weights are read by the benchmark's names
(``portbench.weights.layout``) and upcast to float32 where used.
"""
from __future__ import annotations

import torch

from portbench.reference.plain import (causal_attention, cross_entropy, product, rmsnorm,
                                       rope, swiglu)


def hidden(W, c: dict, tokens: torch.Tensor, prec: str) -> torch.Tensor:
    """Final-norm hidden states (B, L, D) of (B, L) tokens."""
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    H, K = c["num_attention_heads"], c["num_key_value_heads"]
    res = float(c["residual_multiplier"])
    x = W["embed"][tokens.long()].float() * float(c["embedding_multiplier"])
    for i in range(c["num_hidden_layers"]):
        p = lambda n: W[f"layers.{i}.{n}"].float()
        h = rmsnorm(x, p("attn_norm"), eps)
        q = rope(product("bld,dhk->blhk", h, p("wq"), prec), theta)
        k = rope(product("bld,dhk->blhk", h, p("wk"), prec), theta)
        v = product("bld,dhk->blhk", h, p("wv"), prec)
        k, v = (t.repeat_interleave(H // K, dim=2) for t in (k, v))
        o = causal_attention(q, k, v, float(c["attention_multiplier"]), prec)
        x = x + res * product("blhk,hkd->bld", o, p("wo"), prec)
        h = rmsnorm(x, p("mlp_norm"), eps)
        x = x + res * swiglu(h, p("w_gate"), p("w_up"), p("w_down"), prec)
    return rmsnorm(x, W["final_norm"], eps)


def logits(W, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    if c["tie_word_embeddings"]:
        out = product("bld,vd->blv", h, W["embed"], prec)
    else:
        out = product("bld,dv->blv", h, W["lm_head"], prec)
    return out / float(c["logits_scaling"])


def loss(W, c: dict, tokens: torch.Tensor, prec: str) -> torch.Tensor:
    """Mean next-token cross entropy of (B, L + 1) tokens."""
    h = hidden(W, c, tokens[:, :-1], prec)
    return cross_entropy(logits(W, c, h, prec), tokens[:, 1:])
