"""Model assembly: decoders of every kind the reference runs but the
encoder-decoder, for training and serving.

The port of the reference's ``repro/models/model.py``: the GQA decoders,
dense and MoE (granite, deepseek-7b, gemma-2b, nemotron-4-340b,
chameleon-34b, mixtral-8x7b), the MLA decoder with MoE
(deepseek-v2-lite-16b), the attention-free Mamba-2 stack (mamba2-2.7b) and
the RG-LRU hybrid with local attention (recurrentgemma-2b): ``model_defs``,
``init``, ``forward`` (with or without caches), ``logits_from_hidden``,
``cross_entropy_chunked``, ``loss_fn`` (the MoE layers' aux loss added),
``init_cache``, ``prefill`` and ``decode_step``, all functions over a params
tree. Blocks take every MLP variant or capacity-routed MoE, optional
qk-norm, scaled embeddings, the opt-in parallel block, and sliding windows
(ring KV caches); a Mamba-2 block has no MLP. Caches are written in place
(``attention.KVCache``, ``attention.MLACache``, ``ssm.MambaCache``,
``rglru.RGLRUCache``, and for decode the continuous batcher's
``attention.PagedKVCache`` and ``attention.PagedMLACache``). The recurrent
kinds refuse ragged (right-padded) prompts, as the reference does: pad
tokens would pass through their state.

Layers are grouped into segments as in the reference. A scanned segment
(``cfg.scan_layers``, what the full configs use) stacks its leaves on a
leading layer dim and runs as a Python loop over it, its cache stacked the
same way; a list segment (what ``reduced()`` gives) is a list of per-layer
trees and caches. ``cfg.remat`` only trades memory for recompute in the
reference and is ignored here (ROADMAP). The encoder-decoder (``encode``,
cross-attention) is ROADMAP queue 1, item 2.7.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import ParamDef, init_tree

PyTree = Any

__all__ = ["Segment", "plan_segments", "model_defs", "init", "forward",
           "logits_from_hidden", "cross_entropy_chunked", "loss_fn",
           "init_cache", "prefill", "decode_step"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # attn | local | ssm | rglru
    moe: bool
    length: int
    scanned: bool


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the port runs decoder-only models so far; the "
            "encoder-decoder comes with ROADMAP queue 1, item 2.7")


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


def _self_window(cfg: ModelConfig, kind: str) -> int | None:
    if kind == "local":
        return cfg.window
    if cfg.window and cfg.arch_type != "hybrid":
        return cfg.window    # e.g. mixtral: a sliding window on every layer
    return None


def _block_defs(cfg: ModelConfig, kind: str, moe: bool) -> PyTree:
    d: PyTree = {"norm1": L.rmsnorm_defs(cfg.d_model)}
    if kind in ("attn", "local"):
        d["mix"] = attn_lib.mla_defs(cfg) if cfg.attention_type == "mla" \
            else attn_lib.gqa_defs(cfg)
    elif kind == "ssm":
        d["mix"] = ssm_lib.mamba2_defs(cfg)
    elif kind == "rglru":
        d["mix"] = rglru_lib.rglru_defs(cfg)
    else:
        raise ValueError(kind)
    if kind != "ssm":            # mamba2 stacks have no MLP (d_ff = 0)
        d["norm2"] = L.rmsnorm_defs(cfg.d_model)
        d["mlp"] = L.moe_defs(cfg) if moe else L.mlp_defs(cfg)
    return d


def _stack_defs(defs: PyTree, n: int) -> PyTree:
    return _tree.map(
        lambda p: ParamDef((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale),
        defs)


def model_defs(cfg: ModelConfig) -> PyTree:
    _check_supported(cfg)
    layer_defs = []
    for s in plan_segments(cfg):
        layer_defs.append(_stack_defs(_block_defs(cfg, s.kind, s.moe), s.length) if s.scanned
                          else [_block_defs(cfg, s.kind, s.moe) for _ in range(s.length)])
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


def _block_apply(bp: PyTree, cfg: ModelConfig, seg: Segment, x, cache=None,
                 lengths=None, prompt_len=None):
    """One residual block: x + mix(norm1(x)), then + mlp(norm2(x)) where the
    block has an MLP (an MoE layer's returns its aux loss); with
    ``cfg.parallel_block`` an attention block is x + attn(norm1(x)) +
    mlp(norm2(x)). The mix is GQA or MLA attention, Mamba-2 or RG-LRU by
    ``seg.kind``. Returns (x, new cache or None, aux); a dense layer's aux
    is 0.0, a Python float, so it launches nothing. Recurrent kinds refuse
    ragged ``lengths``: pad tokens would pass through their state."""
    aux = 0.0
    h = L.rmsnorm_apply(bp["norm1"], x, cfg.norm_eps)
    if seg.kind in ("attn", "local"):
        if cfg.attention_type == "mla":
            a, new_cache = attn_lib.mla_apply(bp["mix"], cfg, h, cache=cache,
                                              lengths=lengths, prompt_len=prompt_len)
        else:
            a, new_cache = attn_lib.gqa_apply(bp["mix"], cfg, h,
                                              window=_self_window(cfg, seg.kind),
                                              cache=cache, lengths=lengths,
                                              prompt_len=prompt_len)
    elif seg.kind == "ssm":
        if lengths is not None:
            raise NotImplementedError(
                "ragged prompts pollute mamba2 recurrent state; batch "
                "equal-length prompts instead")
        a, new_cache = ssm_lib.mamba2_apply(bp["mix"], cfg, h, cache=cache)
    elif seg.kind == "rglru":
        if lengths is not None:
            raise NotImplementedError(
                "ragged prompts pollute rglru recurrent state; batch "
                "equal-length prompts instead")
        a, new_cache = rglru_lib.rglru_apply(bp["mix"], cfg, h, cache=cache)
    else:
        raise ValueError(seg.kind)
    if "mlp" not in bp:
        return x + a, new_cache, aux
    parallel = cfg.parallel_block and seg.kind in ("attn", "local")
    if not parallel:
        x = x + a
    h2 = L.rmsnorm_apply(bp["norm2"], x, cfg.norm_eps)
    if seg.moe:
        y, aux = L.moe_apply(bp["mlp"], cfg, h2)
    else:
        y = L.mlp_apply(bp["mlp"], cfg, h2)
    if parallel:
        return x + a + y, new_cache, aux
    return x + y, new_cache, aux


def _embed(params, cfg: ModelConfig, tokens):
    dtype = getattr(torch, cfg.compute_dtype)
    x = params["embed"][tokens.long()].to(dtype)
    if cfg.emb_scale:
        # the reference multiplies by a weak-typed Python float, which JAX
        # rounds to the compute dtype first (45.25 for gemma's √2048 in bf16)
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=dtype)
    return x


_PAGED = (attn_lib.PagedKVCache, attn_lib.PagedMLACache)


def _layer_view(cache, li: int):
    """Layer ``li`` of a stacked cache: views into its storage (a paged
    cache stacks its tables and lengths too; the others share ``pos``)."""
    if isinstance(cache, _PAGED):
        return type(cache)(*(t[li] for t in cache))
    return type(cache)(*(t[li] for t in cache[:-1]), cache.pos)


def forward(params, cfg: ModelConfig, tokens, *, caches: list | None = None,
            lengths=None, prompt_len: int | None = None):
    """Decoder forward over (B, L) tokens → (final-norm hidden (B, L, D),
    new caches or None). ``caches`` (from :func:`init_cache`, or paged ones
    from ``serving.kvcache.init_paged_caches`` for decode) are written in
    place; lengths/prompt_len as in ``attention.gqa_apply``."""
    h, new_caches, _ = _forward(params, cfg, tokens, caches=caches, lengths=lengths,
                                prompt_len=prompt_len)
    return h, new_caches


def _forward(params, cfg: ModelConfig, tokens, *, caches=None, lengths=None,
             prompt_len=None):
    """:func:`forward` with the MoE aux loss summed over the layers:
    (hidden, new caches or None, aux); aux is 0.0 without MoE layers."""
    _check_supported(cfg)
    x = _embed(params, cfg, tokens)
    aux_total = 0.0
    new_caches: list = []
    for si, (seg, sp) in enumerate(zip(plan_segments(cfg), params["segments"])):
        cache_s = caches[si] if caches is not None else None
        seg_new = []
        for li in range(seg.length):
            bp = _tree.map(lambda a: a[li], sp) if seg.scanned else sp[li]
            c = None
            if cache_s is not None:   # a layer of a stacked cache is a view into it
                c = _layer_view(cache_s, li) if seg.scanned else cache_s[li]
            x, nc, aux = _block_apply(bp, cfg, seg, x, c, lengths, prompt_len)
            aux_total = aux_total + aux
            seg_new.append(nc)
        if cache_s is not None and seg.scanned:
            seg_new = (cache_s if isinstance(cache_s, _PAGED)
                       else cache_s._replace(pos=seg_new[-1].pos))
        new_caches.append(seg_new)
    h = L.rmsnorm_apply(params["out_norm"], x, cfg.norm_eps)
    return h, (new_caches if caches is not None else None), aux_total


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
    """Next-token CE plus the MoE layers' aux loss. batch: {"tokens": (B, L)
    [, "labels": (B, L)]}; without labels the shift happens here
    (tokens[:-1] -> tokens[1:])."""
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        tokens, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, aux = _forward(params, cfg, tokens)
    return cross_entropy_chunked(params, cfg, h, labels) + aux


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype: torch.dtype, dev: torch.device, layers: int | None = None):
    """An empty cache of one layer of ``kind`` (``layers`` stacks one per
    layer of a scanned segment, each layer its own storage)."""
    if kind in ("attn", "local"):
        if cfg.attention_type == "mla":
            return attn_lib.init_mla_cache(cfg, batch, max_len, dtype, dev, layers=layers)
        return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, dev, layers=layers,
                                      window=_self_window(cfg, kind))
    if kind == "ssm":
        return ssm_lib.init_mamba_cache(cfg, batch, dtype, dev, layers=layers)
    if kind == "rglru":
        return rglru_lib.init_rglru_cache(cfg, batch, dtype, dev, layers=layers)
    raise ValueError(kind)


def init_cache(params, cfg: ModelConfig, batch: int, max_len: int) -> list:
    """Empty per-layer caches on the params' device (one stacked cache for a
    scanned segment, a list of them for a list segment): a ``KVCache``
    (a ring buffer of ``min(window, max_len)`` slots for a windowed layer),
    an ``MLACache``, a ``MambaCache`` or an ``RGLRUCache`` by layer kind."""
    dtype = getattr(torch, cfg.compute_dtype)
    dev = params["embed"].device
    return [_layer_cache(cfg, seg.kind, batch, max_len, dtype, dev, seg.length)
            if seg.scanned else
            [_layer_cache(cfg, seg.kind, batch, max_len, dtype, dev)
             for _ in range(seg.length)]
            for seg in plan_segments(cfg)]


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None,
            lengths=None):
    """Run the prompt, building caches → (logits (B, 1, V) of the last
    position, caches).

    With ``lengths`` (B,), tokens are RIGHT-padded ragged prompts: pad keys
    are masked out of attention and the logits are taken at each row's last
    *real* position (column lengths[b]-1), not the pad tail.
    """
    B, Lp = tokens.shape
    max_len = max_len or Lp
    caches = init_cache(params, cfg, B, max_len)
    h, new_caches = forward(params, cfg, tokens, caches=caches, lengths=lengths,
                            prompt_len=Lp)
    if lengths is not None:
        h_last = h[torch.arange(B, device=h.device), lengths.long() - 1][:, None, :]
    else:
        h_last = h[:, -1:]
    return logits_from_hidden(params, cfg, h_last), new_caches


def decode_step(params, cfg: ModelConfig, caches, token, *, lengths=None,
                prompt_len: int | None = None):
    """One decode step. token: (B, 1) → (logits (B, 1, V), new caches).

    lengths/prompt_len continue a ragged prefill: rope positions per row run
    lengths[b], lengths[b]+1, ... and the original pad columns stay masked.
    Omit both when decoding against paged caches: per-slot positions come
    from the caches' own lengths.
    """
    h, new_caches = forward(params, cfg, token, caches=caches, lengths=lengths,
                            prompt_len=prompt_len)
    return logits_from_hidden(params, cfg, h), new_caches
