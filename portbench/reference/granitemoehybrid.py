"""Plain reference of Granite 4.0-H's hybrid decoder (``model_type``
"granitemoehybrid", without experts).

The embedding times ``embedding_multiplier``; pre-norm blocks, each
x + r·mixer(RMSNorm(x)), then x + r·SwiGLU(RMSNorm(x)), with r the
``residual_multiplier``; the mixer is Mamba-2 where ``layer_types`` says
"mamba", else causal grouped-query attention without positional embeddings
(NoPE), scores times ``attention_multiplier``; a final RMSNorm; logits
against the tied embedding over ``logits_scaling``. Every multiplier and
width is read from the configuration file, weights by the benchmark's names
(``portbench.families.granitemoehybrid``), upcast to float32 where used;
every product goes through ``plain.product``.

The Mamba-2 mixer: [z, xBC, dt] = h·in_proj; xBC ← SiLU(causal depthwise
conv of width ``mamba_d_conv`` + bias); [x, B, C] = xBC; dt ←
softplus(dt + dt_bias); A = −exp(A_log); per head

    y_t = Σ_{s≤t} (C_t·B_s) · exp(Σ_{s<r≤t} dt_r·A) · dt_s·x_s + D·x_t,

B and C shared by the heads of their group; out = RMSNorm(y ⊙ SiLU(z)) over
the whole inner width (one group) times out_proj. The sum is taken in its
quadratic, masked-attention form ("SSD as attention", arXiv:2405.21060),
independently of the port's chunked algorithm: per block of query
positions, the decays exp(cs_t − cs_s) of the running sum cs of dt·A,
taken in float64 so that the difference of two long sums keeps its digits,
times C_t·B_s, times dt_s·x_s. Attention runs per block of queries too;
each layer, each block and each chunk of the cross entropy runs under
``torch.utils.checkpoint``, so that three steps of two replicas at
2 × 4,096 tokens fit one card.

Departures from the published model: none in these equations. Its experts
(``num_local_experts`` 0) are absent, so dropless routing, which the
published code would run, has nothing to route, here or in the port; dt's
clamp to the published ``time_step_limit`` (0, ∞) is the identity and is not
written.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.plain import cross_entropy, product, rmsnorm, swiglu

BLOCK = 256          # query positions per block of the scan and of attention
CE_CHUNK = 1024      # positions per chunk of the cross entropy


def _ckpt(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _causal(q0: int, q1: int, device) -> torch.Tensor:
    """(q1 − q0, q1) bool: query q0 + i may read key j ≤ q0 + i."""
    return (torch.arange(q0, q1, device=device)[:, None]
            >= torch.arange(q1, device=device)[None, :])


def _ssd_block(cs, xdt, B, C, q0: int, q1: int, prec: str) -> torch.Tensor:
    """y of queries q0..q1 − 1 over keys 0..q1 − 1: (b, q, h, p)."""
    seg = (cs[:, q0:q1, None, :] - cs[:, None, :q1, :]).float()          # (b, q, s, h)
    seg = seg.masked_fill(~_causal(q0, q1, cs.device)[None, :, :, None], float("-inf"))
    decay = torch.exp(seg).permute(0, 3, 1, 2)                           # (b, h, q, s)
    scores = product("bqgn,bsgn->bgqs", C[:, q0:q1], B[:, :q1], prec)
    scores = scores.repeat_interleave(decay.shape[1] // scores.shape[1], dim=1)
    return product("bhqs,bshp->bqhp", scores * decay, xdt[:, :q1], prec)


def ssd(x, dt, A, B, C, prec: str) -> torch.Tensor:
    """x: (b, l, h, p); dt: (b, l, h) > 0; A: (h,) < 0; B, C: (b, l, g, n)
    -> y (b, l, h, p) without the D term."""
    cs = torch.cumsum((dt * A).double(), dim=1)
    xdt = x * dt[..., None]
    L = x.shape[1]
    return torch.cat([_ckpt(_ssd_block, cs, xdt, B, C, q0, min(q0 + BLOCK, L), prec)
                      for q0 in range(0, L, BLOCK)], dim=1)


def mamba(p, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """The Mamba-2 mixer over (b, l, D) -> (b, l, D)."""
    b, L, _ = h.shape
    H, P, N, G, W = (c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"],
                     c["mamba_n_groups"], c["mamba_d_conv"])
    di = H * P
    z, xbc, dt = torch.split(product("bld,de->ble", h, p("in_proj"), prec),
                             [di, di + 2 * G * N, H], dim=-1)
    xp = F.pad(xbc, (0, 0, W - 1, 0))
    windows = torch.stack([xp[:, i:i + L] for i in range(W)], dim=2)    # (b, l, W, ch)
    xbc = F.silu(product("blkc,kc->blc", windows, p("conv_w"), prec) + p("conv_b"))
    x, Bm, Cm = torch.split(xbc, [di, G * N, G * N], dim=-1)
    x = x.reshape(b, L, H, P)
    dt = F.softplus(dt + p("dt_bias"))
    A = -torch.exp(p("A_log"))
    y = ssd(x, dt, A, Bm.reshape(b, L, G, N), Cm.reshape(b, L, G, N), prec) \
        + x * p("D")[:, None]
    y = rmsnorm(y.reshape(b, L, di) * F.silu(z), p("norm"), float(c["rms_norm_eps"]))
    return product("ble,ed->bld", y, p("out_proj"), prec)


def _attention_block(q, k, v, q0: int, q1: int, scale: float, prec: str) -> torch.Tensor:
    s = product("bqhd,bkhd->bhqk", q[:, q0:q1], k[:, :q1], prec) * scale
    s = s.masked_fill(~_causal(q0, q1, q.device), float("-inf"))
    return product("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v[:, :q1], prec)


def attention(p, c: dict, h: torch.Tensor, prec: str) -> torch.Tensor:
    """Causal NoPE grouped-query attention over (b, l, D) -> (b, l, D)."""
    H, K, L = c["num_attention_heads"], c["num_key_value_heads"], h.shape[1]
    q = product("bld,dhk->blhk", h, p("wq"), prec)
    k, v = (product("bld,dhk->blhk", h, p(w), prec).repeat_interleave(H // K, dim=2)
            for w in ("wk", "wv"))
    scale = float(c["attention_multiplier"])
    o = torch.cat([_ckpt(_attention_block, q, k, v, q0, min(q0 + BLOCK, L), scale, prec)
                   for q0 in range(0, L, BLOCK)], dim=1)
    return product("blhk,hkd->bld", o, p("wo"), prec)


def _layer(x, W, c: dict, i: int, prec: str) -> torch.Tensor:
    p = lambda n: W[f"layers.{i}.{n}"].float()
    eps, r = float(c["rms_norm_eps"]), float(c["residual_multiplier"])
    mixer = mamba if c["layer_types"][i] == "mamba" else attention
    x = x + r * mixer(p, c, rmsnorm(x, p("attn_norm"), eps), prec)
    h = rmsnorm(x, p("mlp_norm"), eps)
    return x + r * swiglu(h, p("w_gate"), p("w_up"), p("w_down"), prec)


def hidden(W, c: dict, tokens: torch.Tensor, prec: str) -> torch.Tensor:
    """Final-norm hidden states (b, l, D) of (b, l) tokens."""
    x = W["embed"][tokens.long()].float() * float(c["embedding_multiplier"])
    for i in range(c["num_hidden_layers"]):
        x = _ckpt(functools.partial(_layer, W=W, c=c, i=i, prec=prec), x)
    return rmsnorm(x, W["final_norm"], float(c["rms_norm_eps"]))


def _ce_sum(embed, h, labels, c: dict, prec: str) -> torch.Tensor:
    logits = product("bld,vd->blv", h, embed, prec) / float(c["logits_scaling"])
    return cross_entropy(logits, labels) * labels.numel()


def loss(W, c: dict, tokens: torch.Tensor, prec: str) -> torch.Tensor:
    """Mean next-token cross entropy of (b, l + 1) tokens."""
    if not c["tie_word_embeddings"]:
        raise ValueError("granite-4.0-h ties its embeddings")
    h = hidden(W, c, tokens[:, :-1], prec)
    labels = tokens[:, 1:]
    L = labels.shape[1]
    total = sum(_ckpt(_ce_sum, W["embed"], h[:, a:a + CE_CHUNK], labels[:, a:a + CE_CHUNK], c,
                      prec) for a in range(0, L, CE_CHUNK))
    return total / labels.numel()
