"""Plain reference of the MLA decoder with routed and shared experts
(deepseek-v2-lite-16b as the port runs it).

Attention is multi-head latent attention in its expanded form: q from x
(no query compression), a latent c = RMSNorm(x·W_dkv[:, :r]) and one rope
key x·W_dkv[:, r:] shared by the heads; per-head keys c·W_uk beside the
roped shared key, values c·W_uv, scale 1/sqrt(nope + rope). The rotary
embedding is plain: ``rope_scaling`` null, or YaRN at factor 1, under which
YaRN's frequencies and mscale are the plain ones; other scalings are
refused. The first
``first_k_dense_replace`` layers have a SwiGLU MLP; the others route each
token to its top-k of the experts by softmax probability (ties to the lower
index), weights renormalized to sum 1, each expert taking at most
ceil(N·k/E·capacity_factor) of the call's N tokens in (token, rank) order
and dropping the rest, plus the shared experts as one SwiGLU of their
summed width; the layer adds the Switch-style load-balance loss
E·Σ_e mean_prob_e·share_e·router_aux_coef to the training loss.
"""
from __future__ import annotations

import math

import torch

from portbench.reference.plain import (causal_attention, cross_entropy, product, rmsnorm,
                                       rope, swiglu)


def _mla(p, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    B, L, _ = h.shape
    H, r = c["num_attention_heads"], c["kv_lora_rank"]
    dn, dr = c["qk_nope_head_dim"], c["qk_rope_head_dim"]
    theta, eps = float(c["rope_theta"]), float(c["rms_norm_eps"])
    scaling = c.get("rope_scaling")
    if scaling is not None and not (scaling.get("type") == "yarn" and scaling.get("factor") == 1):
        raise ValueError(f"the reference runs plain rotary embeddings, not {scaling}")
    q = product("bld,dhk->blhk", h, p("wq"), prec)
    q_nope, q_rope = q[..., :dn], rope(q[..., dn:], theta)
    dkv = product("bld,dr->blr", h, p("w_dkv"), prec)
    ckv = rmsnorm(dkv[..., :r], p("kv_norm"), eps)
    k_rope = rope(dkv[..., r:][:, :, None, :], theta).expand(B, L, H, dr)
    k = torch.cat([product("blr,rhk->blhk", ckv, p("w_uk"), prec), k_rope], dim=-1)
    v = product("blr,rhk->blhk", ckv, p("w_uv"), prec)
    o = causal_attention(torch.cat([q_nope, q_rope], dim=-1), k, v, (dn + dr) ** -0.5, prec)
    return product("blhk,hkd->bld", o, p("wo"), prec)


def _moe(p, c: dict, h: torch.Tensor, prec: str):
    B, L, D = h.shape
    E, K = c["n_routed_experts"], c["num_experts_per_tok"]
    x = h.reshape(B * L, D)
    N = x.shape[0]
    probs = torch.softmax(product("nd,de->ne", x, p("router"), prec), dim=-1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw, topi = topw[:, :K], topi[:, :K]
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = (topi.reshape(N * K)[:, None] == torch.arange(E, device=x.device)).long()
    place = ((torch.cumsum(onehot, 0) - onehot) * onehot).sum(-1).reshape(N, K)
    keep = place < math.ceil(N * K / E * float(c["capacity_factor"]))
    y = torch.zeros_like(x)
    for e in range(E):
        sel = (topi == e) & keep
        rows = torch.nonzero(sel.any(-1))[:, 0]
        if rows.numel() == 0:
            continue
        w = (topw * sel).sum(-1)[rows]
        out = swiglu(x[rows], p("experts.w_gate")[e], p("experts.w_up")[e],
                     p("experts.w_down")[e], prec)
        y = y.index_add(0, rows, out * w[:, None])
    if c.get("n_shared_experts"):
        y = y + swiglu(x, p("shared.w_gate"), p("shared.w_up"), p("shared.w_down"), prec)
    share = onehot.sum(0).float() / (N * K)
    aux = E * torch.sum(probs.mean(0) * share) * float(c["router_aux_coef"])
    return y.reshape(B, L, D), aux


def hidden_and_aux(W, c: dict, tokens: torch.Tensor, prec: str):
    eps = float(c["rms_norm_eps"])
    x = W["embed"][tokens.long()].float()
    aux = 0.0
    for i in range(c["num_hidden_layers"]):
        p = lambda n, i=i: W[f"layers.{i}.{n}"].float()
        x = x + _mla(p, c, rmsnorm(x, p("attn_norm"), eps), prec)
        h = rmsnorm(x, p("mlp_norm"), eps)
        if i >= c["first_k_dense_replace"]:
            y, a = _moe(p, c, h, prec)
            aux = aux + a
        else:
            y = swiglu(h, p("w_gate"), p("w_up"), p("w_down"), prec)
        x = x + y
    return rmsnorm(x, W["final_norm"], eps), aux


def logits(W, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    if c["tie_word_embeddings"]:
        return product("bld,vd->blv", h, W["embed"], prec)
    return product("bld,dv->blv", h, W["lm_head"], prec)


def loss(W, c: dict, tokens: torch.Tensor, prec: str) -> torch.Tensor:
    h, aux = hidden_and_aux(W, c, tokens[:, :-1], prec)
    return cross_entropy(logits(W, c, h, prec), tokens[:, 1:]) + aux
