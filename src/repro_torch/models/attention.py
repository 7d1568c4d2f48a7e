"""Attention: dense and blockwise GQA/MQA/MHA, sliding windows, and the KV
caches for serving.

The port of the reference's ``repro/models/attention.py``:
``dense_attention`` (with ``kv_valid``), ``blockwise_attention`` (the
online-softmax algorithm in plain PyTorch), ``attention_any``,
``KVCache``/``init_kv_cache`` (a full cache, or a ring buffer of ``window``
slots for sliding-window attention, ``_is_ring``),
``slot_decode_attention``, ``_ragged_kv_valid``, the paged cache of the
continuous batcher (``PagedKVCache``, ``_paged_write``,
``paged_decode_attention``), ``gqa_defs``/``gqa_apply`` (with ``qk_norm``
and ``window``) with its cache-free (training), prefill, cached-decode
(full or ring) and paged-decode branches, non-causal self-attention (the
encoder's) and cross-attention over an encoder's ``memory``, and
DeepSeek-V2's multi-head latent attention: ``mla_defs``/``mla_apply`` with
its compressed cache (``MLACache``, and ``PagedMLACache`` for the
continuous batcher), expanded for training and prefill, absorbed for
decode. Tensors keep the reference's ``(B, L, H, hd)`` layout. On a
mesh's model axis (``launch.mesh.model_parallel``) every branch of
:func:`gqa_apply` and :func:`mla_apply` runs on the rank's heads, the
flash kernel included; a cache whose heads do not divide the model factor
is cut over the sequence instead (:class:`SeqCutKVCache`,
:class:`SeqCutMLACache`), and its decode combines the ranks' softmax
statistics (:func:`_seq_cut_attention`), as the reference's
``_seq_parallel_decode_attention`` does.

Paged decode keeps the reference's formulation: q is scored against the
whole page pool, the block table gathers each slot's (NB, page) scores, and
the probabilities scatter back into a pool-shaped buffer for the value
product. Every shape is static (the pool, not a slot's length, sets them),
so the decode step can be captured once as a CUDA graph; each pool is read
once per step, in place, with no per-slot context copy and no
``repeat_kv`` (q is grouped (Kh, G) instead). A block-table gather of each
slot's pages would copy the context before reading it again.

A long unmasked prefill goes through the hand-written flash kernel
(``repro_torch.kernels.flash_attention.ops.attention``), with the layer's
window where it has one, and so does a long cache-free call that asks for
it with ``flash=True`` (the encoder's non-causal self-attention when a
prefill runs it); MLA's, whose v head dim (128) is below its qk
head dim (192), passes v zero-padded to the qk width, since the kernel
takes one head dim (the zero columns add nothing to p·v), and keeps the
first ``v_head_dim`` columns of the output. Training keeps
``blockwise_attention``, as the reference's model does, because the kernel
is forward only.

Where the reference asks for a float32 product of low-precision operands
(``preferred_element_type=float32``), :func:`f32_product` multiplies in the
operands' dtype and casts the result: identical for float32, one bf16
rounding of the scores for bf16 (ROADMAP queue 3 records it).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import model_shard
from repro_torch.models.layers import rmsnorm_apply, rmsnorm_defs, rope
from repro_torch.models.params import ParamDef

PyTree = Any
NEG_INF = -1e30   # finite: a fully masked row recovers where -inf gives NaN

BLOCK_THRESHOLD = 1024   # kv length above which attention goes blockwise

__all__ = ["NEG_INF", "repeat_kv", "dense_attention", "blockwise_attention",
           "attention_any", "KVCache", "SeqCutKVCache", "init_kv_cache", "PagedKVCache",
           "paged_decode_attention", "slot_decode_attention", "gqa_defs",
           "gqa_apply", "f32_product", "mla_defs", "MLACache", "init_mla_cache",
           "SeqCutMLACache", "PagedMLACache", "mla_apply"]


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


def _valid_bias(kv_valid: torch.Tensor) -> torch.Tensor:
    """(B, Lkv) bool → (B, 1, 1, Lkv) additive float32 bias."""
    return torch.where(kv_valid, 0.0, NEG_INF).float()[:, None, None, :]


def dense_attention(q, k, v, q_pos, kv_pos, *, causal=True, window=None,
                    kv_valid=None, scale=None) -> torch.Tensor:
    """q: (B, Lq, H, hd); k/v: (B, Lkv, Kh, hd); GQA kv repeated to H heads.
    kv_valid: optional (B, Lkv) bool, e.g. cache slots not yet written."""
    H, hd = q.shape[2], q.shape[3]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    k = repeat_kv(k, H)
    v = repeat_kv(v, H)
    s = f32_product("bqhd,bshd->bhqs", q, k)
    s = s * scale + _mask_bias(q_pos, kv_pos, causal=causal, window=window)
    if kv_valid is not None:
        s = s + _valid_bias(kv_valid)
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


def attention_any(q, k, v, q_base, *, causal=True, window=None, kv_valid=None,
                  scale=None, block_threshold=BLOCK_THRESHOLD) -> torch.Tensor:
    """Dense for short kv or a kv_valid mask, blockwise for long kv."""
    Lkv = k.shape[1]
    if Lkv <= block_threshold or kv_valid is not None:
        q_pos = q_base + torch.arange(q.shape[1], device=q.device)
        kv_pos = torch.arange(Lkv, device=q.device)
        return dense_attention(q, k, v, q_pos, kv_pos, causal=causal,
                               window=window, kv_valid=kv_valid, scale=scale)
    return blockwise_attention(q, k, v, q_base, causal=causal, window=window,
                               scale=scale)


def gqa_defs(cfg: ModelConfig) -> PyTree:
    D, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # explicit fan-in scales: the projections contract over d_model (wq/wk/wv)
    # or heads*head_dim (wo), not over the ParamDef default dim
    s_in = float(D) ** -0.5
    s_out = float(H * hd) ** -0.5
    defs = {
        "wq": ParamDef((D, H, hd), ("embed", "q_heads", None), scale=s_in),
        "wk": ParamDef((D, K, hd), ("embed", "kv_heads", None), scale=s_in),
        "wv": ParamDef((D, K, hd), ("embed", "kv_heads", None), scale=s_in),
        "wo": ParamDef((H, hd, D), ("q_heads", None, "embed"), scale=s_out),
    }
    if cfg.qk_norm:
        defs["q_norm"] = rmsnorm_defs(hd, axis=None)
        defs["k_norm"] = rmsnorm_defs(hd, axis=None)
    return defs


class KVCache(NamedTuple):
    """A KV cache. ``k``/``v``: (B, S, Kh, hd), S = max_len, or the window
    for a ring buffer (with a leading layer dim for a scanned segment);
    ``pos``: tokens written so far. A ring buffer keeps position p in slot
    p % S.

    ``gqa_apply`` writes new keys and values into ``k``/``v`` in place (an
    eager copy would move the whole cache at every decode step) and returns
    a KVCache over the same storage with ``pos`` advanced: the cache passed
    in is stale afterwards. ``pos`` is a Python int, so no step waits on the
    device to learn where to write."""

    k: torch.Tensor
    v: torch.Tensor
    pos: int


class SeqCutKVCache(KVCache):
    """A :class:`KVCache` cut over the sequence on the model axis, as the
    reference's ``cache_pspecs`` cuts it where the kv heads do not divide
    k: model shard ``index`` holds every kv head's slots ``[index·S/k,
    (index+1)·S/k)`` of the whole cache's S (a ring's included)."""

    __slots__ = ()


# set by whole_sequence_caches: the caches built keep every slot
_WHOLE_SEQUENCE: contextvars.ContextVar = contextvars.ContextVar("whole_sequence",
                                                                 default=False)


@contextlib.contextmanager
def whole_sequence_caches():
    """Within it, a cache built inside ``launch.mesh.model_parallel`` keeps
    every slot on every rank where it would be cut over the sequence: the
    continuous batcher's admission, whose dense caches are scattered into
    paged pools that are whole (``serving.kvcache.paged_cache_pspecs``)."""
    token = _WHOLE_SEQUENCE.set(True)
    try:
        yield
    finally:
        _WHOLE_SEQUENCE.reset(token)


def _seq_cut(shard, kv_heads: int, S: int) -> bool:
    """Whether a cache of ``S`` slots is cut over the sequence on the model
    shard ``shard``: its heads do not divide k but S does (the reference's
    ``_seq_sharded_cache``), outside :func:`whole_sequence_caches`."""
    return (shard is not None and not _WHOLE_SEQUENCE.get()
            and kv_heads % shard.k != 0 and S % shard.k == 0)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                  device: torch.device, layers: int | None = None,
                  window: int | None = None) -> KVCache:
    """An empty cache of ``min(window, max_len)`` slots with a window (a ring
    buffer once max_len reaches it), else ``max_len``; ``layers`` stacks one
    per layer of a scanned segment (each layer its own storage, not a
    broadcast view). Inside ``launch.mesh.model_parallel`` it holds the
    rank's kv heads where they divide k, else the rank's slots (a
    :class:`SeqCutKVCache`; inside :func:`whole_sequence_caches`, or where k
    does not divide the slots either, every kv head whole)."""
    S = min(window, max_len) if window else max_len
    shard, Kh = model_shard(), cfg.n_kv_heads
    cut = _seq_cut(shard, Kh, S)
    if shard is not None and Kh % shard.k == 0:
        Kh //= shard.k
    shape = (batch, S // shard.k if cut else S, Kh, cfg.head_dim)
    if layers is not None:
        shape = (layers,) + shape
    return (SeqCutKVCache if cut else KVCache)(torch.zeros(shape, dtype=dtype, device=device),
                                               torch.zeros(shape, dtype=dtype, device=device), 0)


class PagedKVCache(NamedTuple):
    """Block-table paged KV cache: decode slots admit and retire independently.

    Every slot carries its own length, so the continuous batcher can refill
    a freed slot while the others keep decoding. Slot ``s``'s logical block
    ``b`` lives in page ``block_tables[s, b]`` of the pools; retired slots
    point their whole row at a reserved dump page, so their in-flight writes
    never touch a reassigned page. A scanned segment stacks all four on a
    leading layer dim.

    ``gqa_apply`` writes each new token into the pools in place and never
    advances ``lengths``: all layers share one position per slot, so the
    batcher bumps it once per decode step (``kvcache.bump_lengths``)."""

    k_pages: torch.Tensor       # (P, page, Kh, hd)
    v_pages: torch.Tensor       # (P, page, Kh, hd)
    block_tables: torch.Tensor  # (S, NB) int32: physical page per logical block
    lengths: torch.Tensor       # (S,) int32: tokens cached per slot


class PagedMLACache(NamedTuple):
    """:class:`PagedKVCache` for MLA: pages over the compressed latent and
    the shared rope key instead of per-head keys and values. Written and
    advanced as :class:`PagedKVCache` is."""

    ckv_pages: torch.Tensor     # (P, page, kv_lora)
    kr_pages: torch.Tensor      # (P, page, rope_dim)
    block_tables: torch.Tensor  # (S, NB) int32
    lengths: torch.Tensor       # (S,) int32


def _paged_write(pages: torch.Tensor, block_tables: torch.Tensor,
                 lengths: torch.Tensor, new: torch.Tensor) -> None:
    """Write one new token per slot at its logical position ``lengths[s]``,
    in place. new: (S, 1, ...). Live slots own distinct pages (the PagePool
    invariant), so the writes never collide; retired slots all land on the
    dump page, whose content is never read."""
    page = pages.shape[1]
    pos = lengths.long()
    pid = torch.gather(block_tables.long(), 1, (pos // page)[:, None])[:, 0]
    pages.index_put_((pid, pos % page), new[:, 0])


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                           scale=None) -> torch.Tensor:
    """Paged decode attention, GQA-grouped, without ``repeat_kv``.

    q: (S, 1, H, hd); pools (P, page, Kh, hd); block_tables (S, NB);
    lengths (S,). Scores go against the entire pool (one product per kv
    head); the block table gathers each slot's (NB, page) scores, the mask
    keeps positions ``<= lengths[s]`` (the token just written included),
    and the probabilities scatter back into a pool-shaped buffer for the
    value product. Pages outside a slot's table get exact zeros; masked
    probabilities that land on the shared dump page are zeros as well.
    """
    S, _, H, hd = q.shape
    Pn, page, Kh, _ = k_pages.shape
    NB = block_tables.shape[1]
    G = H // Kh
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    qg = q[:, 0].reshape(S, Kh, G, hd).transpose(0, 1)             # (Kh, S, G, hd)
    # f32_product of the module note, cast after the gather it commutes with
    s_all = torch.einsum("ksgd,cpkd->ksgcp", qg, k_pages)           # (Kh, S, G, P, page)
    idx = block_tables.long()[None, :, None, :, None].expand(Kh, S, G, NB, page)
    s = torch.gather(s_all, 3, idx).float().reshape(Kh, S, G, NB * page) * scale
    valid = torch.arange(NB * page, device=q.device)[None, :] <= lengths[:, None]
    s = s + torch.where(valid, 0.0, NEG_INF)[None, :, None, :]
    p = torch.softmax(s, dim=-1).to(v_pages.dtype).reshape(Kh, S, G, NB, page)
    p_pool = torch.zeros((Kh, S, G, Pn, page), dtype=v_pages.dtype, device=q.device)
    p_pool.scatter_(3, idx, p)
    o = torch.einsum("ksgcp,cpkd->ksgd", p_pool, v_pages)            # (Kh, S, G, hd)
    return o.transpose(0, 1).reshape(S, 1, H, hd)


def slot_decode_attention(q, k_ctx, v_ctx, kv_valid, scale=None) -> torch.Tensor:
    """One-token-per-slot decode attention with per-slot validity.

    q: (S, 1, H, hd); k_ctx/v_ctx: (S, Lkv, Kh, hd); kv_valid: (S, Lkv).
    Causality is entirely in kv_valid: each slot's query is its newest
    token, so every valid key is attendable (the ragged dense decode)."""
    H = q.shape[2]
    scale = float(scale if scale is not None else 1.0 / np.sqrt(q.shape[-1]))
    k_ctx = repeat_kv(k_ctx, H)
    v_ctx = repeat_kv(v_ctx, H)
    s = f32_product("bqhd,bshd->bhqs", q, k_ctx) * scale + _valid_bias(kv_valid)
    p = torch.softmax(s, dim=-1).to(v_ctx.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v_ctx)


def _ragged_kv_valid(S: int, lengths: torch.Tensor, prompt_len: int,
                     pos: int) -> torch.Tensor:
    """(B, S) cache-slot validity for right-padded ragged prompts: real
    prompt columns [0, len_b), decode columns [prompt_len, pos+1)."""
    idx = torch.arange(S, device=lengths.device)[None, :]
    return ((idx < lengths[:, None]) | (idx >= prompt_len)) & (idx < pos + 1)


def _slots(cache) -> tuple[int, int]:
    """(the whole cache's slots, the first of them this rank holds): a
    :class:`SeqCutKVCache` or :class:`SeqCutMLACache` holds the model
    shard's cut of them, any other cache all of them."""
    buf = cache[0]
    n = buf.shape[1]
    if isinstance(cache, (SeqCutKVCache, SeqCutMLACache)):
        shard = model_shard()
        return n * shard.k, n * shard.index
    return n, 0


def _is_ring(cache: KVCache, window: int | None) -> bool:
    """The cache is a ring buffer iff it is exactly window-sized."""
    return window is not None and _slots(cache)[0] == window


def _write_slots(buf: torch.Tensor, new: torch.Tensor, start: int, first: int) -> None:
    """Write ``new`` (B, n, ...) into the whole cache's slots ``[start,
    start + n)``, in place, where ``buf`` holds its slots ``[first, first +
    buf.shape[1])``: only their overlap is written."""
    lo, hi = max(start, first), min(start + new.shape[1], first + buf.shape[1])
    if hi > lo:
        buf[:, lo - first:hi - first] = new[:, lo - start:hi - start]


def _ring_ok(pos: int, W: int, window: int, qp: torch.Tensor) -> torch.Tensor:
    """(L, W) bool: which of a ring's W slots, holding the tokens up to
    ``pos`` (slot pos % W the newest), the queries at positions ``qp`` may
    attend: each slot's absolute position, causal, within the window, and
    written."""
    slot = pos % W
    idx = torch.arange(W, device=qp.device)
    slot_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot - W + idx)
    valid = (slot_pos >= 0) & (slot_pos > pos - window)
    return (slot_pos[None, :] <= qp[:, None]) & valid[None, :]


def _ring_decode_attention(q, ck, cv, pos: int, window: int, q_pos=None,
                           scale=None) -> torch.Tensor:
    """Decode attention over a ring cache that already holds the new token
    (q: (B, 1, H, hd), written at slot pos % W): each slot's absolute
    position, masked to the window and to positions written, scores scaled
    by 1/sqrt(hd) (or times ``scale``), GQA by repeated kv heads, as the
    reference's ring branch; the queries sit at ``q_pos`` (default
    ``pos + arange(L)``)."""
    B, L, H, hd = q.shape
    qp = q_pos if q_pos is not None else pos + torch.arange(L, device=q.device)
    s = f32_product("bqhd,bshd->bhqs", q, repeat_kv(ck, H))
    s = s / float(np.sqrt(hd)) if scale is None else s * float(scale)
    s = s + torch.where(_ring_ok(pos, ck.shape[1], window, qp), 0.0, NEG_INF)[None, None]
    p = torch.softmax(s, dim=-1).to(cv.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, repeat_kv(cv, H))


def _seq_cut_attention(s: torch.Tensor, pv) -> torch.Tensor:
    """Softmax attention over a cache cut over the sequence on the model
    axis, the reference's ``_seq_parallel_decode_attention``: ``s`` (B, H,
    L, S/k) are the float32 scores, scaled and masked, of every head over
    the rank's slots, ``pv(p)`` the product (B, L, H, dv) of unnormalized
    probabilities with the rank's values. The max is all-reduced over the
    model group, then the sums and the products in one all-reduce: (B, L,
    H, dv) float32 of the whole softmax. A rank with no slot to attend
    (all masked, finite ``NEG_INF``) adds zeros."""
    m = tp.max_over_model(s.amax(-1))                              # (B, H, L)
    p = torch.exp(s - m[..., None])
    both = tp.reduce_from_model(torch.cat(
        [pv(p).float(), p.sum(-1).transpose(1, 2)[..., None]], dim=-1))
    return both[..., :-1] / both[..., -1:]


def _own_heads(o: torch.Tensor, Hl: int) -> torch.Tensor:
    """This model shard's ``Hl`` heads of (B, L, H, ...) every head's."""
    return o.narrow(2, model_shard().index * Hl, Hl)


def _gqa_seq_cut_decode(q, ck, cv, ok: torch.Tensor, scale: float) -> torch.Tensor:
    """Decode attention of the rank's q heads (B, L, Hl, hd) over a
    :class:`SeqCutKVCache`'s slots ``ck``/``cv`` (B, S/k, Kh, hd), ``ok``
    (B or 1, L, S/k) their mask: q is all-gathered over the model group
    (one token), every head attends over the rank's slots
    (:func:`_seq_cut_attention`), and the rank keeps its heads."""
    Hl = q.shape[2]
    qa = tp.gather_from_model(q, 2)
    H = qa.shape[2]
    s = f32_product("bqhd,bshd->bhqs", qa, repeat_kv(ck, H)) * scale
    s = s + torch.where(ok, 0.0, NEG_INF)[:, None]
    o = _seq_cut_attention(s, lambda p: torch.einsum(
        "bhqs,bshd->bqhd", p.to(cv.dtype), repeat_kv(cv, H)))
    return _own_heads(o, Hl).to(q.dtype)


def _tree_copy_to_model(params: PyTree) -> PyTree:
    return {name: tp.copy_to_model(t) for name, t in params.items()}


def _local_kv_heads(t: torch.Tensor, cfg: ModelConfig, index: int, Hl: int) -> torch.Tensor:
    """The kv heads that model shard ``index``'s ``Hl`` q heads read, of a
    replicated (B, L, K, hd) k or v: local q head i is global head
    ``index·Hl + i``, which reads kv head ``(index·Hl + i) // (H/K)``.
    Where the rank's q heads span whole groups of H/K, or fall in one,
    those kv heads are a contiguous run that ``repeat_kv`` maps as the
    meshless layer does (every config's case)."""
    G = cfg.n_heads // cfg.n_kv_heads
    if Hl % G and G % Hl:
        raise NotImplementedError(f"{Hl} q heads per model shard over groups of {G}")
    return t.narrow(2, index * Hl // G, max(Hl // G, 1))


def gqa_apply(params, cfg: ModelConfig, x, *, positions=None, q_base: int = 0,
              causal: bool = True, window: int | None = None, cache: KVCache | PagedKVCache | None = None,
              memory: torch.Tensor | None = None, flash: bool = False,
              lengths: torch.Tensor | None = None, prompt_len: int | None = None):
    """Self-attention over (B, L, D) → (out, new cache or None), causal
    unless ``causal=False`` (an encoder's); ``window``: sliding-window
    attention (a key within ``window`` positions of the query, itself
    included). With ``memory`` (B, S, D): cross-attention, keys and values
    from the memory, no rope and no mask (cache-free only; decode takes
    the precomputed cross K/V, ``model.precompute_cross_kv``).

    ``positions`` overrides the rope positions of self-attention (and the
    query positions of a ring decode), as in the reference. Without a cache:
    a chunk whose first token sits at position ``q_base`` (its rope
    positions and causal offset; 0 for whole sequences: training, an
    encoder); ``flash=True`` sends attention over more than
    ``BLOCK_THRESHOLD`` keys through the flash kernel (forward only), as a
    prefill runs the encoder. With a cache and L > 1: prefill of an empty
    cache; a long unmasked prompt goes through the flash kernel; a ring
    cache keeps the prompt's last W positions. With a cache and L == 1:
    one cached decode step (a ring cache writes at pos % W; ragged
    ``lengths`` with a ring raise, as in the reference). lengths: (B,) true
    prompt lengths of RIGHT-padded ragged batches: in prefill pad keys are
    masked out; in decode (with ``prompt_len``, the padded prompt width)
    rope positions are per row (len_b + t) and the pad columns stay
    masked, so batched ragged decode matches unbatched. With a
    :class:`PagedKVCache` (decode only): one token per slot at the slot's
    own position ``cache.lengths[s]``. On every path the scores are scaled
    by ``cfg.attention_multiplier`` where it is set (Granite's), else by
    1/sqrt(head_dim); at ``cfg.position_embedding == "nope"`` no rotary
    embedding touches q or k (positions still set the causal mask).

    Inside ``launch.mesh.model_parallel``, with ``wq`` cut to this rank's
    q heads (``params`` are the rank's shards; ``cfg``'s head counts stay
    global), the layer is tensor parallel: ``x`` enters through
    ``copy_to_model``, the rank attends with its q heads (and its kv heads
    where they shard, projected from the memory entering through its own
    ``copy_to_model``; else the replicated kv heads those q heads read,
    entering through ``copy_to_model``), and the output projection's
    partial sum leaves through ``reduce_from_model``. So do its serving
    branches: the flash kernel runs on the rank's heads; a cache holds the
    rank's kv heads where they shard, else every kv head, the rank's slots
    of them in a :class:`SeqCutKVCache`, whose prefill stores the rank's
    range of positions, whose decode writes a new token on the rank owning
    its slot and attends over every rank's slots
    (:func:`_gqa_seq_cut_decode`); a paged cache's pools hold the rank's kv
    heads, or every kv head, of which the rank reads its q heads'.
    """
    B, L, _ = x.shape
    paged = isinstance(cache, PagedKVCache)
    kv_src = memory if memory is not None else x
    scale = cfg.attention_multiplier            # None: 1/sqrt(head_dim)
    # on the model axis: this rank's q heads, and its kv heads where they
    # shard too (else every kv head, replicated)
    shard = model_shard() if params["wq"].shape[-2] < cfg.n_heads else None
    kv_sharded = shard is not None and params["wk"].shape[-2] < cfg.n_kv_heads
    if shard is not None:
        x = tp.copy_to_model(x)
        if kv_sharded:
            # a memory enters each cross-attention through its own f
            kv_src = x if memory is None else tp.copy_to_model(memory)
    q = torch.einsum("bld,dhk->blhk", x, params["wq"])
    k = torch.einsum("bld,dhk->blhk", kv_src, params["wk"])
    v = torch.einsum("bld,dhk->blhk", kv_src, params["wv"])
    if cfg.qk_norm:
        q_norm = params["q_norm"]
        k_norm = params["k_norm"]
        if shard is not None:
            # a replicated scale over this rank's heads: a partial gradient
            q_norm = _tree_copy_to_model(q_norm)
            if kv_sharded:
                k_norm = _tree_copy_to_model(k_norm)
        q = rmsnorm_apply(q_norm, q, cfg.norm_eps)
        k = rmsnorm_apply(k_norm, k, cfg.norm_eps)
    if memory is None and cfg.position_embedding == "rope":   # rope: self-attention only
        if positions is not None:
            q_pos = positions
        elif paged:
            q_pos = cache.lengths[:, None]      # (S, 1) per-slot positions
        elif cache is not None and lengths is not None and L == 1:
            # token t of row b sits at column prompt_len + t, position len_b + t
            q_pos = (cache.pos - (prompt_len - lengths))[:, None]
        else:
            base = cache.pos if cache is not None else q_base
            q_pos = base + torch.arange(L, device=x.device)
        q = rope(q, q_pos, cfg.rope_theta)
        k = rope(k, q_pos, cfg.rope_theta)

    def own_kv(t):
        """The kv heads this rank's q heads read, of every kv head's ``t``."""
        if shard is None or kv_sharded:
            return t
        return _local_kv_heads(tp.copy_to_model(t), cfg, shard.index, q.shape[2])

    def out(o):
        # this rank's heads give a partial sum of the output projection
        o = torch.einsum("blhk,hkd->bld", o, params["wo"])
        return o if shard is None else tp.reduce_from_model(o)

    if cache is None:
        causal = causal and memory is None
        k, v = own_kv(k), own_kv(v)
        if flash and q_base == 0 and k.shape[1] > BLOCK_THRESHOLD:
            o = flash_ops.attention(q, k, v, causal=causal, window=window, scale=scale)
        else:
            o = attention_any(q, k, v, q_base, causal=causal, window=window, scale=scale)
        return out(o), None

    if paged:
        if L != 1:
            raise ValueError("a paged KV cache is decode-only (admission scatters "
                             "a dense prefill into it)")
        _paged_write(cache.k_pages, cache.block_tables, cache.lengths, k)
        _paged_write(cache.v_pages, cache.block_tables, cache.lengths, v)
        kp, vp = cache.k_pages, cache.v_pages
        if shard is not None and not kv_sharded:
            kp, vp = (_local_kv_heads(t, cfg, shard.index, q.shape[2]) for t in (kp, vp))
        o = paged_decode_attention(q, kp, vp, cache.block_tables, cache.lengths, scale=scale)
        return out(o), cache

    S, first = _slots(cache)
    ring = _is_ring(cache, window)
    if L > 1:
        # prefill: the cache is empty (pos 0); right-padded ragged prompts
        # mask their pad keys and take the dense path, as in the reference
        kv_valid = None
        if lengths is not None:
            kv_valid = torch.arange(L, device=x.device)[None, :] < lengths[:, None]
        if kv_valid is None and L > BLOCK_THRESHOLD:
            o = flash_ops.attention(q, own_kv(k), own_kv(v), causal=True, window=window,
                                    scale=scale)
        else:
            o = attention_any(q, own_kv(k), own_kv(v), 0, causal=True, window=window,
                              kv_valid=kv_valid, scale=scale)
        if ring and L >= S:
            # the last S positions, rolled so position p sits at slot p % S
            k, v = (torch.roll(t[:, -S:], L % S, dims=1) for t in (k, v))
        _write_slots(cache.k, k, 0, first)
        _write_slots(cache.v, v, 0, first)
        return out(o), cache._replace(pos=cache.pos + L)

    pos = cache.pos
    if ring and lengths is not None:
        raise NotImplementedError(
            "ragged prompt lengths with a sliding-window ring cache: "
            "batch equal-length prompts instead (WaveBatcher only "
            "passes lengths when a wave is actually ragged)")
    slot = pos % S if ring else pos
    _write_slots(cache.k, k, slot, first)
    _write_slots(cache.v, v, slot, first)
    new_cache = cache._replace(pos=pos + L)
    qp = pos + torch.arange(L, device=x.device)
    if isinstance(cache, SeqCutKVCache):
        # every head over this rank's slots, combined over the model group
        if ring:
            ok = _ring_ok(pos, S, window, positions if positions is not None else qp)[None]
        elif lengths is not None:
            ok = _ragged_kv_valid(S, lengths, prompt_len, pos)[:, None]
        else:
            kp = torch.arange(S, device=x.device)[None, :]
            ok = (kp <= qp[:, None]) & (kp < pos + L)
            if window is not None:
                ok = ok & (kp > qp[:, None] - window)
            ok = ok[None]
        o = _gqa_seq_cut_decode(q, cache.k, cache.v, ok.narrow(-1, first, cache.k.shape[1]),
                                float(1.0 / np.sqrt(q.shape[-1])) if scale is None
                                else scale)
        return out(o), new_cache
    ck, cv = own_kv(cache.k), own_kv(cache.v)
    if ring:
        o = _ring_decode_attention(q, ck, cv, pos, window, positions, scale)
    elif lengths is not None:
        kv_valid = _ragged_kv_valid(S, lengths, prompt_len, pos)
        o = slot_decode_attention(q, ck, cv, kv_valid, scale=scale)
    else:
        arange_s = torch.arange(S, device=x.device)
        kv_valid = (arange_s < pos + L)[None, :].expand(B, S)
        o = dense_attention(q, ck, cv, qp, arange_s, causal=True, window=window,
                            kv_valid=kv_valid, scale=scale)
    return out(o), new_cache


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------


def mla_defs(cfg: ModelConfig) -> PyTree:
    D, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    s_d = float(D) ** -0.5
    s_r = float(r) ** -0.5
    return {
        "wq": ParamDef((D, H, dn + dr), ("embed", "q_heads", None), scale=s_d),
        "w_dkv": ParamDef((D, r + dr), ("embed", "kv_lora")),
        "kv_norm": rmsnorm_defs(r, axis="kv_lora"),
        "w_uk": ParamDef((r, H, dn), ("kv_lora", "q_heads", None), scale=s_r),
        "w_uv": ParamDef((r, H, dv), ("kv_lora", "q_heads", None), scale=s_r),
        "wo": ParamDef((H, dv, D), ("q_heads", None, "embed"), scale=float(H * dv) ** -0.5),
    }


class MLACache(NamedTuple):
    """MLA's compressed cache: the normed latent ``ckv`` (B, S, kv_lora) and
    the roped shared key ``krope`` (B, S, rope_dim), with a leading layer
    dim for a scanned segment. Written in place as :class:`KVCache`."""

    ckv: torch.Tensor
    krope: torch.Tensor
    pos: int


class SeqCutMLACache(MLACache):
    """An :class:`MLACache` cut over the sequence on the model axis, as the
    reference's ``cache_pspecs`` cuts it (the latent has no head dim):
    model shard ``index`` holds slots ``[index·S/k, (index+1)·S/k)``."""

    __slots__ = ()


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device, layers: int | None = None) -> MLACache:
    """An empty cache of ``max_len`` slots; inside
    ``launch.mesh.model_parallel`` the rank's cut of them (a
    :class:`SeqCutMLACache`) where k divides them, else (or inside
    :func:`whole_sequence_caches`) whole."""
    cut = _seq_cut(model_shard(), 1, max_len)
    S = max_len // model_shard().k if cut else max_len
    lead = (batch, S) if layers is None else (layers, batch, S)
    return (SeqCutMLACache if cut else MLACache)(
        torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype, device=device),
        torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype, device=device), 0)


def _mla_absorbed_scores(params, q_nope, q_rope, ckv_all, kr_all, scale: float):
    """Absorbed-form decode scores in the compressed space: (B, H, L, S)."""
    q_abs = torch.einsum("blhk,rhk->blhr", q_nope, params["w_uk"])
    s = (f32_product("blhr,bsr->bhls", q_abs, ckv_all)
         + f32_product("blhk,bsk->bhls", q_rope, kr_all))
    return s * scale


def _mla_absorbed_values(params, p, ckv_all):
    """(B, L, H, v_head_dim): the probabilities' product with the latent,
    expanded through ``w_uv`` (absorbed)."""
    o_c = torch.einsum("bhls,bsr->blhr", p.to(ckv_all.dtype), ckv_all)
    return torch.einsum("blhr,rhk->blhk", o_c, params["w_uv"])


def _mla_paged_attention(params, q_nope, q_rope, ckv_pages, kr_pages, block_tables,
                         lengths, scale: float):
    """Absorbed MLA decode over the page pools, as
    :func:`paged_decode_attention` in the compressed (kv_lora) space:
    scores against the whole pool in place, the block table's gather of
    each slot's (NB, page) scores, and the probabilities scattered (out of
    place, static shapes) into a pool-shaped buffer for the value product."""
    S, _, H, _ = q_nope.shape
    Pn, page, _ = ckv_pages.shape
    NB = block_tables.shape[1]
    q_abs = torch.einsum("blhk,rhk->blhr", q_nope, params["w_uk"])[:, 0]
    idx = block_tables.long()[:, None, :, None].expand(S, H, NB, page)
    # f32_product of the module note, cast after the gather it commutes with
    s = (torch.gather(torch.einsum("shr,cpr->shcp", q_abs, ckv_pages), 2, idx).float()
         + torch.gather(torch.einsum("shk,cpk->shcp", q_rope[:, 0], kr_pages), 2, idx).float())
    s = s.reshape(S, H, NB * page) * scale
    valid = torch.arange(NB * page, device=q_nope.device)[None, :] <= lengths[:, None]
    s = s + torch.where(valid, 0.0, NEG_INF)[:, None, :]
    p = torch.softmax(s, dim=-1).to(ckv_pages.dtype).reshape(S, H, NB, page)
    p_pool = torch.zeros((S, H, Pn, page), dtype=ckv_pages.dtype,
                         device=q_nope.device).scatter(2, idx, p)
    o_c = torch.einsum("shcp,cpr->shr", p_pool, ckv_pages)
    o = torch.einsum("shr,rhk->shk", o_c, params["w_uv"])
    return torch.einsum("shk,hkd->sd", o, params["wo"])[:, None]


def _mla_flash(q, k, v, scale: float) -> torch.Tensor:
    """Causal flash attention with v's head dim below q's and k's: v goes in
    zero-padded to their width and the padding columns come off the output
    (ROADMAP queue 3 records the extra work)."""
    dv = v.shape[-1]
    v_pad = torch.cat([v, v.new_zeros(v.shape[:-1] + (q.shape[-1] - dv,))], dim=-1)
    return flash_ops.attention(q, k, v_pad, causal=True, scale=scale)[..., :dv]


def mla_apply(params, cfg: ModelConfig, x, *, q_base: int = 0,
              cache: MLACache | PagedMLACache | None = None,
              lengths: torch.Tensor | None = None, prompt_len: int | None = None):
    """Multi-head latent attention over (B, L, D) → (out, new cache or None).

    Without a cache (training) and in prefill (L > 1, an empty cache) it
    runs in the expanded form: per-head keys and values from the latent,
    the rope key broadcast over the heads; a long unmasked prefill goes
    through the flash kernel. Cached decode (L == 1) runs in the absorbed
    form, scoring q against the latent itself; ``lengths``/``prompt_len``
    as in :func:`gqa_apply`. A :class:`PagedMLACache` takes one token per
    slot at its own position. The scale is ``1/sqrt(qk_nope + qk_rope)``.
    ``q_base``: the position of the first token of the expanded form's chunk
    (rope positions and causal offset), as in the reference.

    Inside ``launch.mesh.model_parallel``, with the heads cut over the
    model axis (``wq``, ``w_uk``, ``w_uv`` and ``wo``; ``H`` is the local
    head count), the layer is tensor parallel: ``x`` enters the query
    product through ``copy_to_model``; the latent and the rope key come
    whole from ``x`` through the replicated ``w_dkv`` and ``kv_norm`` (so
    their gradients are whole) and enter the rank's heads through one
    ``copy_to_model``; the output projection's partial sum leaves through
    ``reduce_from_model``. The expanded form and its flash call run on the
    rank's heads. The wave cache is cut over the sequence
    (:class:`SeqCutMLACache`): prefill stores the rank's range of
    positions, and the absorbed decode gathers every head's absorbed query
    and attends over the rank's slots (:func:`_seq_cut_attention`); the
    paged cache is whole on every rank, as the reference's
    ``paged_cache_pspecs`` keeps it, and its decode runs on the rank's
    heads.
    """
    B, L, _ = x.shape
    H = params["wq"].shape[-2]
    shard = model_shard() if H < cfg.n_heads else None
    r, dn, dr = cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim
    scale = float(1.0 / np.sqrt(dn + dr))

    def out(o):
        o = torch.einsum("blhk,hkd->bld", o, params["wo"])
        return o if shard is None else tp.reduce_from_model(o)

    xq = x if shard is None else tp.copy_to_model(x)
    q = torch.einsum("bld,dhk->blhk", xq, params["wq"])           # (B, L, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    dkv = x @ params["w_dkv"]                                      # (B, L, r + dr)
    ckv = rmsnorm_apply(params["kv_norm"], dkv[..., :r], cfg.norm_eps)
    k_rope_in = dkv[..., r:][:, :, None, :]                        # (B, L, 1, dr)

    if isinstance(cache, PagedMLACache):
        if L != 1:
            raise ValueError("a paged MLA cache is decode-only (admission scatters "
                             "a dense prefill into it)")
        qp = cache.lengths[:, None]                                # (S, 1)
        q_rope = rope(q_rope, qp, cfg.rope_theta)
        k_rope_new = rope(k_rope_in, qp, cfg.rope_theta)[:, :, 0]
        _paged_write(cache.ckv_pages, cache.block_tables, cache.lengths, ckv)
        _paged_write(cache.kr_pages, cache.block_tables, cache.lengths, k_rope_new)
        o = _mla_paged_attention(params, q_nope, q_rope, cache.ckv_pages, cache.kr_pages,
                                 cache.block_tables, cache.lengths, scale)
        return (o if shard is None else tp.reduce_from_model(o)), cache

    if cache is None or L > 1:
        q_pos = q_base + torch.arange(L, device=x.device)
        q_rope = rope(q_rope, q_pos, cfg.rope_theta)
        k_rope = rope(k_rope_in, q_pos, cfg.rope_theta)[:, :, 0]   # (B, L, dr)
        ckv_h, k_rope_h = ckv, k_rope
        if shard is not None:     # whole latents into the rank's heads: one f
            lat = tp.copy_to_model(torch.cat([ckv, k_rope], dim=-1))
            ckv_h, k_rope_h = lat[..., :r], lat[..., r:]
        k_nope = torch.einsum("blr,rhk->blhk", ckv_h, params["w_uk"])
        v = torch.einsum("blr,rhk->blhk", ckv_h, params["w_uv"])
        k = torch.cat([k_nope, k_rope_h[:, :, None, :].expand(B, L, H, dr)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        kv_valid = None
        if lengths is not None:      # ragged right-padded prefill: mask the pad keys
            kv_valid = torch.arange(L, device=x.device)[None, :] < lengths[:, None]
        if cache is not None and kv_valid is None and q_base == 0 and L > BLOCK_THRESHOLD:
            o = _mla_flash(qq, k, v, scale)
        else:
            o = attention_any(qq, k, v, q_base, causal=True, scale=scale, kv_valid=kv_valid)
        new_cache = None
        if cache is not None:
            first = _slots(cache)[1]
            _write_slots(cache.ckv, ckv, 0, first)
            _write_slots(cache.krope, k_rope, 0, first)
            new_cache = cache._replace(pos=cache.pos + L)
        return out(o), new_cache

    # cached decode, absorbed form: scores in the compressed space
    pos = cache.pos
    if lengths is not None:
        qp = (pos - (prompt_len - lengths))[:, None]               # (B, 1)
    else:
        qp = pos + torch.arange(L, device=x.device)
    q_rope = rope(q_rope, qp, cfg.rope_theta)
    k_rope_new = rope(k_rope_in, qp, cfg.rope_theta)[:, :, 0]
    S, first = _slots(cache)
    _write_slots(cache.ckv, ckv, pos, first)
    _write_slots(cache.krope, k_rope_new, pos, first)
    new_cache = cache._replace(pos=pos + L)
    arange_s = torch.arange(S, device=x.device)
    if lengths is not None:
        # ragged decode: the original pad columns [len_b, prompt_len) stay masked
        ok = _ragged_kv_valid(S, lengths, prompt_len, pos)[:, None, None, :]
    else:
        ok = ((arange_s[None, :] <= qp[:, None])[None, None]
              & (arange_s < pos + L)[None, None, None, :])
    if isinstance(cache, SeqCutMLACache):
        # every head's absorbed query over this rank's slots, combined over
        # the model group; the rank keeps its heads
        Sl = cache.ckv.shape[1]
        qa = tp.gather_from_model(torch.cat(
            [torch.einsum("blhk,rhk->blhr", q_nope, params["w_uk"]), q_rope], -1), 2)
        sc = (f32_product("blhr,bsr->bhls", qa[..., :r], cache.ckv)
              + f32_product("blhk,bsk->bhls", qa[..., r:], cache.krope)) * scale
        sc = sc + torch.where(ok.narrow(-1, first, Sl), 0.0, NEG_INF)
        o_c = _seq_cut_attention(sc, lambda p: torch.einsum(
            "bhls,bsr->blhr", p.to(cache.ckv.dtype), cache.ckv))
        o = torch.einsum("blhr,rhk->blhk", _own_heads(o_c, H).to(cache.ckv.dtype),
                         params["w_uv"])
        return out(o), new_cache
    s = _mla_absorbed_scores(params, q_nope, q_rope, cache.ckv, cache.krope, scale)
    p = torch.softmax(s + torch.where(ok, 0.0, NEG_INF), dim=-1)
    return out(_mla_absorbed_values(params, p, cache.ckv)), new_cache
