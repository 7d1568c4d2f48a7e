"""Model assembly: the dense GQA decoder.

The port of the training path of the reference's ``repro/models/model.py``
for the dense family (granite): ``model_defs``, ``init``, ``forward`` (no
caches), ``logits_from_hidden``, ``cross_entropy_chunked`` and ``loss_fn``,
all pure functions over a params tree.

Layers are grouped into segments as in the reference. A scanned segment
(``cfg.scan_layers``, what the full configs use) stacks its leaves on a
leading layer dim and runs as a Python loop over it; a list segment (what
``reduced()`` gives) is a list of per-layer trees. ``cfg.remat`` only trades
memory for recompute in the reference and is ignored here (ROADMAP).
Other layer kinds, MoE, MLA and encoder-decoder come with their families.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models.params import ParamDef, init_tree

PyTree = Any

__all__ = ["Segment", "plan_segments", "model_defs", "init", "forward",
           "logits_from_hidden", "cross_entropy_chunked", "loss_fn"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # attn
    moe: bool
    length: int
    scanned: bool


def _check_supported(cfg: ModelConfig) -> None:
    if (cfg.arch_type != "dense" or cfg.attention_type != "gqa" or cfg.n_experts
            or cfg.encoder_layers or cfg.layer_pattern is not None
            or cfg.parallel_block or cfg.window or cfg.qk_norm or cfg.emb_scale
            or cfg.mlp_type != "swiglu"):
        raise NotImplementedError(
            f"{cfg.name}: the port runs the dense GQA decoder only so far "
            "(other families: ROADMAP queue 1, item 12)")


def plan_segments(cfg: ModelConfig) -> list[Segment]:
    kinds = cfg.layer_kinds
    moes = cfg.moe_layer_flags
    segs: list[Segment] = []
    i = 0
    while i < cfg.n_layers:
        j = i
        while j < cfg.n_layers and kinds[j] == kinds[i] and moes[j] == moes[i]:
            j += 1
        n = j - i
        segs.append(Segment(kinds[i], moes[i], n, scanned=cfg.scan_layers and n > 1))
        i = j
    return segs


def _block_defs(cfg: ModelConfig) -> PyTree:
    return {
        "norm1": L.rmsnorm_defs(cfg.d_model),
        "mix": attn_lib.gqa_defs(cfg),
        "norm2": L.rmsnorm_defs(cfg.d_model),
        "mlp": L.mlp_defs(cfg),
    }


def _stack_defs(defs: PyTree, n: int) -> PyTree:
    return _tree.map(
        lambda p: ParamDef((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale),
        defs)


def model_defs(cfg: ModelConfig) -> PyTree:
    _check_supported(cfg)
    layer_defs = []
    for s in plan_segments(cfg):
        layer_defs.append(_stack_defs(_block_defs(cfg), s.length) if s.scanned
                          else [_block_defs(cfg) for _ in range(s.length)])
    d: PyTree = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), scale=0.02),
        "segments": layer_defs,
        "out_norm": L.rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02)
    return d


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device = "cuda") -> PyTree:
    dtype = getattr(torch, cfg.param_dtype)
    return init_tree(generator, model_defs(cfg), dtype, device)


def _block_apply(bp: PyTree, cfg: ModelConfig, x):
    """One residual block: x + attn(norm1(x)), then + mlp(norm2(x))."""
    x = x + attn_lib.gqa_apply(bp["mix"], cfg, L.rmsnorm_apply(bp["norm1"], x, cfg.norm_eps))
    h2 = L.rmsnorm_apply(bp["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(bp["mlp"], cfg, h2)


def _embed(params, cfg: ModelConfig, tokens):
    return params["embed"][tokens.long()].to(getattr(torch, cfg.compute_dtype))


def forward(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Decoder forward over (B, L) tokens → final-norm hidden (B, L, D)."""
    _check_supported(cfg)
    x = _embed(params, cfg, tokens)
    for seg, sp in zip(plan_segments(cfg), params["segments"]):
        for li in range(seg.length):
            bp = _tree.map(lambda a: a[li], sp) if seg.scanned else sp[li]
            x = _block_apply(bp, cfg, x)
    return L.rmsnorm_apply(params["out_norm"], x, cfg.norm_eps)


def _unembed(params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def logits_from_hidden(params, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    return attn_lib.f32_product("bld,dv->blv", h, _unembed(params, cfg).to(h.dtype))


def cross_entropy_chunked(params, cfg: ModelConfig, h, labels,
                          n_chunks: int = 8) -> torch.Tensor:
    """Mean next-token CE, a sequence chunk at a time (never (B, L, V) at once)."""
    B, Ltot, _ = h.shape
    n_chunks = min(n_chunks, Ltot)
    while Ltot % n_chunks:
        n_chunks -= 1
    ck = Ltot // n_chunks
    W = _unembed(params, cfg).to(h.dtype)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hs = h[:, i * ck:(i + 1) * ck]
        ls = labels[:, i * ck:(i + 1) * ck]
        logits = attn_lib.f32_product("bld,dv->blv", hs, W)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
        total = total + torch.sum(logz - gold)
    return total / (B * Ltot)


def loss_fn(params, cfg: ModelConfig, batch: PyTree) -> torch.Tensor:
    """Next-token CE. batch: {"tokens": (B, L) [, "labels": (B, L)]}; without
    labels the shift happens here (tokens[:-1] -> tokens[1:])."""
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        tokens, labels = tokens[:, :-1], tokens[:, 1:]
    h = forward(params, cfg, tokens)
    return cross_entropy_chunked(params, cfg, h, labels)
