"""Model assembly: every kind of model the reference runs, for training
and serving.

The port of the reference's ``repro/models/model.py``: the GQA decoders,
dense and MoE (granite, deepseek-7b, gemma-2b, nemotron-4-340b,
chameleon-34b, mixtral-8x7b), the MLA decoder with MoE
(deepseek-v2-lite-16b), the attention-free Mamba-2 stack (mamba2-2.7b),
the RG-LRU hybrid with local attention (recurrentgemma-2b) and the
encoder-decoder (seamless-m4t-large-v2): ``model_defs``, ``init``,
``encode``, ``forward`` (with or without caches), ``logits_from_hidden``,
``cross_entropy_chunked``, ``loss_fn`` (the MoE layers' aux loss added),
``init_cache``, ``precompute_cross_kv``, ``prefill`` and ``decode_step``,
all functions over a params tree. Blocks take every MLP variant or
capacity-routed MoE, optional qk-norm, scaled embeddings, the opt-in
parallel block, and sliding windows (ring KV caches); a Mamba-2 block has
no MLP (mamba2-2.7b) but where ``cfg.ssm_mlp`` puts one beside the mixer
(granite-4.0-h's hybrid, whose attention runs without rotary
embeddings). Granite's multipliers, where a config sets them, scale the
embedding, every residual branch and the logits (and, through
``attention``, the scores). Caches are written in place
(``attention.KVCache``, ``attention.MLACache``, ``ssm.MambaCache``,
``rglru.RGLRUCache``, and for decode the continuous batcher's
``attention.PagedKVCache`` and ``attention.PagedMLACache``). The recurrent
kinds refuse ragged (right-padded) prompts, as the reference does: pad
tokens would pass through their state.

The encoder-decoder's encoder runs non-causal self-attention over
precomputed frame embeddings (the speech frontend is a stub, as in the
reference); each decoder block adds cross-attention over its output, the
``memory``, between the mix and the MLP. ``prefill`` encodes once, takes
the long encoder attention through the flash kernel, and precomputes each
decoder layer's cross K/V, which every decode step then reads.

Layers are grouped into segments as in the reference. A scanned segment
(``cfg.scan_layers``, what the full configs use) stacks its leaves on a
leading layer dim and runs as a Python loop over it, its cache stacked the
same way; a list segment (what ``reduced()`` gives) is a list of per-layer
trees and caches; the encoder's layers are stacked or listed by the same
rule. With ``cfg.remat`` a training forward recomputes each layer in the
backward pass, as the reference's ``jax.checkpoint`` does, at the same three
sites: every decoder layer, list or scanned, and every layer of a stacked
encoder; a list encoder's layers are not wrapped (:mod:`.remat`).

Inside ``launch.mesh.model_parallel`` (the train step on a mesh of model
factor k > 1, or serving on a mesh) every forward is tensor parallel, as
GSPMD computes the reference's from its specs: attention over the rank's
heads, self or over the encoder's memory, and MLA's over its heads
(``attention.gqa_apply``, ``attention.mla_apply``), the MLP over its
``ff`` columns (``layers.mlp_apply``), the MoE over its experts or their
``expert_ff`` columns (``layers.moe_apply``), Mamba-2 over its heads
(``ssm.mamba2_apply``), RG-LRU over its width's channels
(``rglru.rglru_apply``), the encoder's layers the same way, and, where the
vocab is cut over the model axis (k divides it), a masked lookup of the
rank's embedding rows, a vocab-parallel cross entropy and, for serving,
logits gathered over the model group (:func:`_embed`,
:func:`cross_entropy_chunked`, :func:`logits_from_hidden`). Caches hold
the rank's cut (:func:`init_cache`). Between blocks the activations stay
whole on every rank: the reference's ``shard_activations`` pin
(``_act_shard``), a layout with no numerical effect, has no counterpart;
nor has its ``moe_shard="capacity"`` pin.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import model_shard
from repro_torch.models import attention as attn_lib
from repro_torch.models import layers as L
from repro_torch.models import remat as remat_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.params import ParamDef, init_tree

PyTree = Any

__all__ = ["Segment", "plan_segments", "model_defs", "init", "encode", "forward",
           "logits_from_hidden", "cross_entropy_chunked", "loss_fn",
           "init_cache", "precompute_cross_kv", "prefill", "decode_step"]


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str          # attn | local | ssm | rglru
    moe: bool
    length: int
    scanned: bool


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


def _block_defs(cfg: ModelConfig, kind: str, moe: bool, cross: bool) -> PyTree:
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
    if cross:
        d["norm_cross"] = L.rmsnorm_defs(cfg.d_model)
        d["cross"] = attn_lib.gqa_defs(cfg)
    if kind != "ssm" or cfg.ssm_mlp:     # mamba2-2.7b's Mamba blocks have no MLP
        d["norm2"] = L.rmsnorm_defs(cfg.d_model)
        d["mlp"] = L.moe_defs(cfg) if moe else L.mlp_defs(cfg)
    return d


def _stack_defs(defs: PyTree, n: int) -> PyTree:
    return _tree.map(
        lambda p: ParamDef((n,) + p.shape, ("layers",) + p.axes, p.init, p.scale),
        defs)


def _encoder_block_defs(cfg: ModelConfig) -> PyTree:
    return {
        "norm1": L.rmsnorm_defs(cfg.d_model),
        "mix": attn_lib.gqa_defs(cfg),
        "norm2": L.rmsnorm_defs(cfg.d_model),
        "mlp": L.mlp_defs(cfg),
    }


def model_defs(cfg: ModelConfig) -> PyTree:
    cross = cfg.encoder_layers > 0
    layer_defs = []
    for s in plan_segments(cfg):
        layer_defs.append(_stack_defs(_block_defs(cfg, s.kind, s.moe, cross), s.length)
                          if s.scanned else
                          [_block_defs(cfg, s.kind, s.moe, cross) for _ in range(s.length)])
    d: PyTree = {
        "embed": ParamDef((cfg.vocab_size, cfg.d_model), ("vocab", "embed_table"), scale=0.02),
        "segments": layer_defs,
        "out_norm": L.rmsnorm_defs(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        d["lm_head"] = ParamDef((cfg.d_model, cfg.vocab_size), ("embed", "vocab"), scale=0.02)
    if cfg.encoder_layers:
        n = cfg.encoder_layers
        d["encoder"] = {
            "layers": _stack_defs(_encoder_block_defs(cfg), n)
                      if cfg.scan_layers and n > 1
                      else [_encoder_block_defs(cfg) for _ in range(n)],
            "out_norm": L.rmsnorm_defs(cfg.d_model),
        }
    return d


def init(generator: torch.Generator, cfg: ModelConfig,
         device: str | torch.device = "cuda") -> PyTree:
    dtype = getattr(torch, cfg.param_dtype)
    return init_tree(generator, model_defs(cfg), dtype, device)


def _block_apply(bp: PyTree, cfg: ModelConfig, seg: Segment, x, cache=None,
                 lengths=None, prompt_len=None, memory=None, cross_kv=None,
                 q_base: int = 0):
    """One residual block: x + mix(norm1(x)), then, in an encoder-decoder's
    decoder with ``memory`` given, + cross(norm_cross(x)), then +
    mlp(norm2(x)) where the block has an MLP (an MoE layer's returns its
    aux loss); with ``cfg.parallel_block`` an attention block without
    cross-attention is x + attn(norm1(x)) + mlp(norm2(x)). Each branch is
    added times ``cfg.residual_multiplier`` (:func:`_residual`). The mix is
    GQA or MLA attention, Mamba-2 or RG-LRU by ``seg.kind``. Cross-attention
    reads ``cross_kv`` (this layer's precomputed (k, v), serving) where
    given, else projects ``memory`` itself (training). Returns (x, new
    cache or None, aux); a dense layer's aux is 0.0, a Python float, so it
    launches nothing. Recurrent kinds refuse ragged ``lengths``: pad tokens
    would pass through their state."""
    aux = 0.0
    h = L.rmsnorm_apply(bp["norm1"], x, cfg.norm_eps)
    if seg.kind in ("attn", "local"):
        if cfg.attention_type == "mla":
            a, new_cache = attn_lib.mla_apply(bp["mix"], cfg, h, q_base=q_base, cache=cache,
                                              lengths=lengths, prompt_len=prompt_len)
        else:
            a, new_cache = attn_lib.gqa_apply(bp["mix"], cfg, h, q_base=q_base,
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
    parallel = cfg.parallel_block and "mlp" in bp and "cross" not in bp \
        and seg.kind in ("attn", "local")
    if not parallel:
        x = _residual(cfg, x, a)
        if "cross" in bp and memory is not None:
            x = _residual(cfg, x, _cross_apply(bp, cfg, x, memory, cross_kv))
        if "mlp" not in bp:
            return x, new_cache, aux
    h2 = L.rmsnorm_apply(bp["norm2"], x, cfg.norm_eps)
    if seg.moe:
        y, aux = L.moe_apply(bp["mlp"], cfg, h2)
    else:
        y = L.mlp_apply(bp["mlp"], cfg, h2)
    if parallel:
        return _residual(cfg, _residual(cfg, x, a), y), new_cache, aux
    return _residual(cfg, x, y), new_cache, aux


def _residual(cfg: ModelConfig, x, branch):
    """x + branch, or x + residual_multiplier·branch in one pass (Granite)."""
    if cfg.residual_multiplier == 1.0:
        return x + branch
    return torch.add(x, branch, alpha=cfg.residual_multiplier)


def _remat_block_apply(bp: PyTree, cfg: ModelConfig, seg: Segment, x, memory, q_base: int):
    """:func:`_block_apply` of a training forward through
    :func:`remat.checkpoint`: only ``x``, ``memory`` and the layer's leaves
    are kept for the backward pass. An MoE layer's aux loss is an output of
    the recomputed function; a dense layer's stays the float 0.0."""
    def body(x, memory, bp):
        y, _, aux = _block_apply(bp, cfg, seg, x, memory=memory, q_base=q_base)
        return (y, aux) if seg.moe else y

    out = remat_lib.checkpoint(body, x, memory, bp)
    return out if seg.moe else (out, 0.0)


def _cross_apply(bp: PyTree, cfg: ModelConfig, x, memory, cross_kv):
    """Cross-attention of a decoder block over the encoder's memory: over
    the precomputed ``cross_kv`` = (k, v) by dense attention where given,
    else through ``gqa_apply(memory=...)``, as the reference."""
    hc = L.rmsnorm_apply(bp["norm_cross"], x, cfg.norm_eps)
    if cross_kv is None:
        return attn_lib.gqa_apply(bp["cross"], cfg, hc, causal=False, memory=memory)[0]
    ck, cv = cross_kv
    wq = bp["cross"]["wq"]
    # on the model axis: the rank's q heads (and its kv heads where they shard)
    shard = model_shard() if wq.shape[-2] < cfg.n_heads else None
    if shard is not None:
        hc = tp.copy_to_model(hc)
        if ck.shape[2] == cfg.n_kv_heads:
            ck, cv = (attn_lib._local_kv_heads(t, cfg, shard.index, wq.shape[-2])
                      for t in (ck, cv))
    q = torch.einsum("bld,dhk->blhk", hc, wq)
    o = attn_lib.dense_attention(q, ck, cv, torch.arange(hc.shape[1], device=hc.device),
                                 torch.arange(ck.shape[1], device=hc.device), causal=False,
                                 scale=cfg.attention_multiplier)
    out = torch.einsum("blhk,hkd->bld", o, bp["cross"]["wo"])
    return out if shard is None else tp.reduce_from_model(out)


def _vocab_shard(table_rows: int, cfg: ModelConfig):
    """This rank's ModelShard where the vocab is cut over the model axis
    (a table of fewer rows than ``cfg.vocab_size`` inside
    ``launch.mesh.model_parallel``), else None."""
    return model_shard() if table_rows < cfg.vocab_size else None


def _local_ids(ids, shard, n: int):
    """(ids within this rank's ``n`` vocab rows, clamped; the mask of the
    ids it owns)."""
    t = ids.long() - shard.index * n
    ok = (t >= 0) & (t < n)
    return t.clamp(0, n - 1), ok


def _embed(params, cfg: ModelConfig, tokens):
    """The embedding lookup. With the vocab cut over the model axis each
    rank looks up the tokens in its rows, zeros elsewhere, and the rows
    meet in ``reduce_from_model`` (one rank's row plus zeros: exact)."""
    dtype = getattr(torch, cfg.compute_dtype)
    table = params["embed"]
    shard = _vocab_shard(table.shape[0], cfg)
    if shard is None:
        x = table[tokens.long()].to(dtype)
    else:
        ids, ok = _local_ids(tokens, shard, table.shape[0])
        x = tp.reduce_from_model(torch.where(ok[..., None], table[ids], 0.0)).to(dtype)
    if cfg.emb_scale:
        # the reference multiplies by a weak-typed Python float, which JAX
        # rounds to the compute dtype first (45.25 for gemma's √2048 in bf16)
        x = x * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=dtype)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    return x


_PAGED = (attn_lib.PagedKVCache, attn_lib.PagedMLACache)


def _layer_view(cache, li: int):
    """Layer ``li`` of a stacked cache: views into its storage (a paged
    cache stacks its tables and lengths too; the others share ``pos``)."""
    if isinstance(cache, _PAGED):
        return type(cache)(*(t[li] for t in cache))
    return type(cache)(*(t[li] for t in cache[:-1]), cache.pos)


def _layers(stack, n: int, scanned: bool):
    """The n per-layer trees of a segment: views into a stacked tree's
    leaves, or a list's items."""
    return (_tree.map(lambda a: a[li], stack) if scanned else stack[li] for li in range(n))


def encode(params, cfg: ModelConfig, enc_embeds: torch.Tensor, *,
           flash: bool = False) -> torch.Tensor:
    """The encoder over precomputed frontend embeddings (B, S, D) → the
    final-norm memory (B, S, D): pre-norm blocks of non-causal
    self-attention and an MLP.

    ``flash=True`` takes each layer's self-attention through the flash
    kernel when S > ``attention.BLOCK_THRESHOLD`` (what :func:`prefill`
    asks for); without it attention is dense or ``blockwise_attention``,
    as in the reference, which the training path needs: the kernel is
    forward only. With ``cfg.remat`` a stacked encoder's layers are
    recomputed in the backward pass of a training forward."""
    x = enc_embeds.to(getattr(torch, cfg.compute_dtype))
    enc = params["encoder"]
    scanned = not isinstance(enc["layers"], list)
    # the reference checkpoints a stacked encoder's layers, not a list's
    remat = cfg.remat and scanned and not flash and torch.is_grad_enabled()
    for bp in _layers(enc["layers"], cfg.encoder_layers, scanned):
        if remat:
            x = remat_lib.checkpoint(
                lambda x, bp: _encoder_block_apply(bp, cfg, x), x, bp)
        else:
            x = _encoder_block_apply(bp, cfg, x, flash)
    return L.rmsnorm_apply(enc["out_norm"], x, cfg.norm_eps)


def _encoder_block_apply(bp: PyTree, cfg: ModelConfig, x, flash: bool = False):
    """One encoder block: x + attn(norm1(x)) non-causal, then + mlp(norm2(x))."""
    h = L.rmsnorm_apply(bp["norm1"], x, cfg.norm_eps)
    x = x + attn_lib.gqa_apply(bp["mix"], cfg, h, causal=False, flash=flash)[0]
    h2 = L.rmsnorm_apply(bp["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(bp["mlp"], cfg, h2)


def forward(params, cfg: ModelConfig, tokens, *, q_base: int = 0,
            caches: list | None = None,
            memory: torch.Tensor | None = None, cross_kvs: list | None = None,
            lengths=None, prompt_len: int | None = None):
    """Decoder forward over (B, L) tokens → (final-norm hidden (B, L, D),
    new caches or None). ``q_base``: the position of the first token of a
    cache-free chunk (its rope positions and causal offset), as in the
    reference. ``caches`` (from :func:`init_cache`, or paged ones
    from ``serving.kvcache.init_paged_caches`` for decode) are written in
    place; an encoder-decoder's decoder attends over ``memory`` (from
    :func:`encode`), through ``cross_kvs`` (from
    :func:`precompute_cross_kv`) where given; lengths/prompt_len as in
    ``attention.gqa_apply``."""
    h, new_caches, _ = _forward(params, cfg, tokens, q_base=q_base, caches=caches,
                                memory=memory, cross_kvs=cross_kvs, lengths=lengths,
                                prompt_len=prompt_len)
    return h, new_caches


def _forward(params, cfg: ModelConfig, tokens, *, q_base=0, caches=None, memory=None,
             cross_kvs=None, lengths=None, prompt_len=None):
    """:func:`forward` with the MoE aux loss summed over the layers:
    (hidden, new caches or None, aux); aux is 0.0 without MoE layers.

    A training forward (no caches, grad enabled) with ``cfg.remat`` runs
    each layer through :func:`_remat_block_apply`. In a training forward,
    with or without remat, each decoder layer reads its own alias of
    ``memory``, so the gradient reaching ``memory`` is summed per layer
    first on both paths and they agree bit for bit."""
    x = _embed(params, cfg, tokens)
    aux_total = 0.0
    new_caches: list = []
    training = caches is None and torch.is_grad_enabled()
    remat = cfg.remat and training
    for si, (seg, sp) in enumerate(zip(plan_segments(cfg), params["segments"])):
        cache_s = caches[si] if caches is not None else None
        ckvs = (_layers(cross_kvs[si], seg.length, seg.scanned) if cross_kvs is not None
                else [None] * seg.length)
        seg_new = []
        for li, (bp, ckv) in enumerate(zip(_layers(sp, seg.length, seg.scanned), ckvs)):
            c = None
            if cache_s is not None:   # a layer of a stacked cache is a view into it
                c = _layer_view(cache_s, li) if seg.scanned else cache_s[li]
            mem = memory.view_as(memory) if training and memory is not None else memory
            if remat:
                (x, aux), nc = _remat_block_apply(bp, cfg, seg, x, mem, q_base), None
            else:
                x, nc, aux = _block_apply(bp, cfg, seg, x, c, lengths, prompt_len, mem, ckv,
                                          q_base)
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
    """(B, L, V) float32 logits; with the vocab cut over the model axis,
    the rank's columns all-gathered over the model group."""
    W = _unembed(params, cfg)
    if _vocab_shard(W.shape[-1], cfg) is None:
        return _scaled(cfg, attn_lib.f32_product("bld,dv->blv", h, W.to(h.dtype)))
    return tp.gather_from_model(_scaled(
        cfg, attn_lib.f32_product("bld,dv->blv", tp.copy_to_model(h), W.to(h.dtype))), -1)


def _scaled(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Float32 logits over ``cfg.logits_scaling`` (Granite), as they are at 1."""
    return logits if cfg.logits_scaling == 1.0 else logits / cfg.logits_scaling


def cross_entropy_chunked(params, cfg: ModelConfig, h, labels,
                          n_chunks: int = 8) -> torch.Tensor:
    """Mean next-token CE, a sequence chunk at a time (never (B, L, V) at once).

    With the vocab cut over the model axis the CE is vocab parallel: ``h``
    enters through ``copy_to_model``, each rank takes its vocab columns'
    logits, the max is all-reduced (no gradient), then Σexp and the gold
    logit (from the rank owning each label, a masked sum) in one
    all-reduce; no rank holds (B, L, V)."""
    B, Ltot, _ = h.shape
    n_chunks = min(n_chunks, Ltot)
    while Ltot % n_chunks:
        n_chunks -= 1
    ck = Ltot // n_chunks
    W = _unembed(params, cfg).to(h.dtype)
    shard = _vocab_shard(W.shape[-1], cfg)
    if shard is not None:
        h = tp.copy_to_model(h)
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        hs = h[:, i * ck:(i + 1) * ck]
        ls = labels[:, i * ck:(i + 1) * ck]
        logits = _scaled(cfg, attn_lib.f32_product("bld,dv->blv", hs, W))
        if shard is None:
            logz = torch.logsumexp(logits, dim=-1)
            gold = torch.gather(logits, -1, ls[..., None].long())[..., 0]
        else:
            m = tp.max_over_model(logits.amax(-1))
            ids, ok = _local_ids(ls, shard, W.shape[-1])
            mine = torch.gather(logits, -1, ids[..., None])[..., 0]
            sums = tp.reduce_from_model(torch.stack(
                [torch.exp(logits - m[..., None]).sum(-1), torch.where(ok, mine, 0.0)]))
            logz, gold = torch.log(sums[0]) + m, sums[1]
        total = total + torch.sum(logz - gold)
    return total / (B * Ltot)


def loss_fn(params, cfg: ModelConfig, batch: PyTree) -> torch.Tensor:
    """Next-token CE plus the MoE layers' aux loss. batch: {"tokens": (B, L)
    [, "labels": (B, L)] [, "enc_embeds": (B, S, D)]}; without labels the
    shift happens here (tokens[:-1] -> tokens[1:]). An encoder-decoder
    encodes ``enc_embeds`` (blockwise attention: the flash kernel has no
    backward)."""
    tokens = batch["tokens"]
    memory = encode(params, cfg, batch["enc_embeds"]) if cfg.encoder_layers else None
    labels = batch.get("labels")
    if labels is None:
        tokens, labels = tokens[:, :-1], tokens[:, 1:]
    h, _, aux = _forward(params, cfg, tokens, memory=memory)
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
    an ``MLACache``, a ``MambaCache`` or an ``RGLRUCache`` by layer kind.

    Inside ``launch.mesh.model_parallel`` each holds the rank's cut, as the
    reference's ``launch.shardings.cache_pspecs`` lays it out: the rank's
    kv heads where they divide the model factor, else its slots of every
    kv head (``attention.SeqCutKVCache``; MLA's latent always, as
    ``attention.SeqCutMLACache``), Mamba-2's heads and RG-LRU's channels
    (inside ``attention.whole_sequence_caches`` nothing is cut over the
    sequence)."""
    dtype = getattr(torch, cfg.compute_dtype)
    dev = params["embed"].device
    return [_layer_cache(cfg, seg.kind, batch, max_len, dtype, dev, seg.length)
            if seg.scanned else
            [_layer_cache(cfg, seg.kind, batch, max_len, dtype, dev)
             for _ in range(seg.length)]
            for seg in plan_segments(cfg)]


def precompute_cross_kv(params, cfg: ModelConfig, memory: torch.Tensor) -> list:
    """Each decoder layer's cross-attention (k, v), each (B, S, Kh, hd),
    computed once from the encoder's memory (enc-dec serving): per segment
    a (k, v) pair stacked on a leading layer dim for a scanned segment, a
    list of pairs for a list segment."""
    out = []
    for seg, sp in zip(plan_segments(cfg), params["segments"]):
        pairs = [(torch.einsum("bld,dhk->blhk", memory, bp["cross"]["wk"]),
                  torch.einsum("bld,dhk->blhk", memory, bp["cross"]["wv"]))
                 for bp in _layers(sp, seg.length, seg.scanned)]
        out.append((torch.stack([k for k, _ in pairs]), torch.stack([v for _, v in pairs]))
                   if seg.scanned else pairs)
    return out


def prefill(params, cfg: ModelConfig, tokens, max_len: int | None = None,
            enc_embeds=None, lengths=None):
    """Run the prompt, building caches → (logits (B, 1, V) of the last
    position, caches, cross_kvs, memory); the last two are None but for an
    encoder-decoder, which encodes ``enc_embeds`` (B, S, D) first (its long
    self-attention through the flash kernel) and precomputes each decoder
    layer's cross K/V for the decode steps.

    With ``lengths`` (B,), tokens are RIGHT-padded ragged prompts: pad keys
    are masked out of attention and the logits are taken at each row's last
    *real* position (column lengths[b]-1), not the pad tail.
    """
    B, Lp = tokens.shape
    max_len = max_len or Lp
    memory = cross_kvs = None
    if cfg.encoder_layers:
        if enc_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: prefill needs enc_embeds")
        memory = encode(params, cfg, enc_embeds, flash=True)
        cross_kvs = precompute_cross_kv(params, cfg, memory)
    caches = init_cache(params, cfg, B, max_len)
    h, new_caches = forward(params, cfg, tokens, caches=caches, memory=memory,
                            cross_kvs=cross_kvs, lengths=lengths, prompt_len=Lp)
    if lengths is not None:
        h_last = h[torch.arange(B, device=h.device), lengths.long() - 1][:, None, :]
    else:
        h_last = h[:, -1:]
    return logits_from_hidden(params, cfg, h_last), new_caches, cross_kvs, memory


def decode_step(params, cfg: ModelConfig, caches, token, *, memory=None, cross_kvs=None,
                lengths=None, prompt_len: int | None = None):
    """One decode step. token: (B, 1) → (logits (B, 1, V), new caches).
    An encoder-decoder passes the ``memory`` and ``cross_kvs`` its prefill
    returned.

    lengths/prompt_len continue a ragged prefill: rope positions per row run
    lengths[b], lengths[b]+1, ... and the original pad columns stay masked.
    Omit both when decoding against paged caches: per-slot positions come
    from the caches' own lengths.
    """
    h, new_caches = forward(params, cfg, token, caches=caches, memory=memory,
                            cross_kvs=cross_kvs, lengths=lengths, prompt_len=prompt_len)
    return logits_from_hidden(params, cfg, h), new_caches
