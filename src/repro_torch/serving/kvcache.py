"""Block-table paged KV cache for the continuous batcher.

The port of the reference's ``repro/serving/kvcache.py``. Physical storage is one page pool per attention layer, ``(n_pages, page,
Kh, hd)`` tensors for keys and values, or for MLA ``(n_pages, page,
kv_lora)`` latents and ``(n_pages, page, rope_dim)`` rope keys (stacked on
a leading layer dim for a scanned segment, each layer its own storage).
Slot ``s``'s logical block ``b`` lives in page ``block_tables[s, b]``;
every layer shares the same mapping, so the host-side :class:`PagePool`
(numpy, as in the reference) tracks one table.

The last page of every pool is a reserved DUMP page: retired or
never-admitted slots point their whole table row at it, so the writes the
decode step still issues for them can never corrupt a page that has been
reassigned. Its contents are garbage by design and never read (per-slot
``lengths`` mask them out of attention).

Where the reference returns updated caches from donated buffers, these
functions write the caches in place (``index_put_``, ``fill_``, ``+=``), so
a CUDA graph captured over the decode step keeps reading the same storage.
Admission scatters a group's dense prefill caches into the slots' pages
with one ``index_put_`` per pool; prefill buckets are multiples of the page
size, so a bucket is a whole number of blocks.

On a mesh's model axis the pools hold the rank's kv heads where they
divide the model factor, else every kv head, and MLA's pools are whole on
every rank (:func:`paged_cache_pspecs`, the reference's rule).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import model_shard
from repro_torch.models import model as M
from repro_torch.models.attention import PagedKVCache, PagedMLACache

__all__ = ["paged_unsupported_reason", "supports_paged", "PagePool",
           "init_paged_caches", "paged_cache_pspecs", "clear_paged_caches", "map_layers",
           "scatter_prefill", "retire_slot", "bump_lengths"]


def paged_unsupported_reason(cfg: ModelConfig) -> str | None:
    """None if cfg can serve from a paged cache, else why not.

    Recurrent kinds (ssm/rglru) carry per-slot state that pad tokens would
    pollute, sliding-window attention wants a ring buffer (not a growing
    paged context), and encoder-decoder serving threads cross-KV the paged
    decode step doesn't carry. Those archs stay on the WaveBatcher.
    """
    if any(k not in ("attn",) for k in cfg.layer_kinds):
        return f"layer kinds {sorted(set(cfg.layer_kinds))} (paged needs pure attn)"
    if cfg.window:
        return "sliding-window attention (ring cache)"
    if cfg.encoder_layers:
        return "encoder-decoder cross attention"
    return None


def supports_paged(cfg: ModelConfig) -> bool:
    return paged_unsupported_reason(cfg) is None


class PagePool:
    """Host-side page allocator mirroring the device block tables.

    ``n_pages = slots * blocks_per_slot + 1``: enough for every slot to hold
    ``max_len`` tokens at once, plus the dump page, so admission can only
    fail on a caller bug (an over-long request), never on fragmentation.
    """

    def __init__(self, slots: int, max_len: int, page_size: int):
        self.page = int(page_size)
        self.nb = -(-int(max_len) // self.page)       # blocks per slot
        self.n_pages = slots * self.nb + 1
        self.dump = self.n_pages - 1
        self.slots = slots
        self.reset()

    def reset(self) -> None:
        self.free: list[int] = list(range(self.n_pages - 1))
        self.owned: dict[int, list[int]] = {}
        self.tables = np.full((self.slots, self.nb), self.dump, np.int32)

    def admit(self, slot: int, n_tokens: int) -> np.ndarray:
        """Allocate pages covering positions [0, n_tokens); returns the new
        (nb,) table row (unallocated tail entries = dump page)."""
        if slot in self.owned:
            raise RuntimeError(f"slot {slot} already admitted")
        need = -(-int(n_tokens) // self.page)
        if need > self.nb:
            raise ValueError(f"{n_tokens} tokens > max_len ({self.nb} blocks)")
        pages = [self.free.pop() for _ in range(need)]
        row = np.full((self.nb,), self.dump, np.int32)
        row[:need] = pages
        self.tables[slot] = row
        self.owned[slot] = pages
        return row

    def retire(self, slot: int) -> None:
        self.free.extend(self.owned.pop(slot, []))
        self.tables[slot] = self.dump


# ---------------------------------------------------------------------------
# Device-side caches (mirroring model.init_cache's segment structure)
# ---------------------------------------------------------------------------


def _one_layer(cfg: ModelConfig, pool: PagePool, dtype: torch.dtype,
               device: torch.device, layers: int | None = None):
    lead = () if layers is None else (layers,)
    tables = torch.full(lead + (pool.slots, pool.nb), pool.dump, dtype=torch.int32,
                        device=device)
    lengths = torch.zeros(lead + (pool.slots,), dtype=torch.int32, device=device)
    pages = lead + (pool.n_pages, pool.page)
    if cfg.attention_type == "mla":
        return PagedMLACache(
            torch.zeros(pages + (cfg.kv_lora_rank,), dtype=dtype, device=device),
            torch.zeros(pages + (cfg.qk_rope_dim,), dtype=dtype, device=device),
            tables, lengths)
    shard, Kh = model_shard(), cfg.n_kv_heads
    Kh = Kh // shard.k if shard is not None and Kh % shard.k == 0 else Kh
    shape = pages + (Kh, cfg.head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device), tables, lengths)


def init_paged_caches(cfg: ModelConfig, pool: PagePool,
                      device: str | torch.device) -> list:
    """Per-layer paged caches on ``device``: one stacked :class:`PagedKVCache`
    (:class:`PagedMLACache` for MLA) for a scanned segment (every layer its
    own storage, not a broadcast view), a list of them for a list segment;
    inside ``launch.mesh.model_parallel`` the rank's cut that
    :func:`paged_cache_pspecs` gives."""
    reason = paged_unsupported_reason(cfg)
    if reason is not None:
        raise ValueError(f"paged cache unsupported for this arch: {reason}")
    dtype = getattr(torch, cfg.compute_dtype)
    dev = torch.device(device)
    return [_one_layer(cfg, pool, dtype, dev, seg.length) if seg.scanned
            else [_one_layer(cfg, pool, dtype, dev) for _ in range(seg.length)]
            for seg in M.plan_segments(cfg)]


def paged_cache_pspecs(cfg: ModelConfig, mesh) -> list:
    """Specs mirroring :func:`init_paged_caches`' structure, the
    reference's: the kv heads over 'model' where they divide it (tables
    and lengths replicated); MLA's pages, with no head dim, replicated."""
    from repro_torch.launch.mesh import WorkerMesh
    from repro_torch.models.params import PartitionSpec as P

    shape = WorkerMesh.ensure(mesh).shape
    k = shape.get("model", 1)

    def one():
        if cfg.attention_type == "mla":
            return PagedMLACache(P(None, None, None), P(None, None, None), P(), P())
        h_ax = "model" if k > 1 and cfg.n_kv_heads % k == 0 else None
        return PagedKVCache(P(None, None, h_ax, None), P(None, None, h_ax, None), P(), P())

    def stacked(spec):
        return type(spec)(*(P(None, *p) for p in spec))

    return [stacked(one()) if seg.scanned else [one() for _ in range(seg.length)]
            for seg in M.plan_segments(cfg)]


def map_layers(cfg: ModelConfig, caches: list, fn: Callable) -> list:
    """Apply fn(layer_cache, stacked: bool) over the segment structure."""
    out = []
    for seg, pc in zip(M.plan_segments(cfg), caches):
        if seg.scanned:
            out.append(fn(pc, True))
        else:
            out.append([fn(p, False) for p in pc])
    return out


def clear_paged_caches(cfg: ModelConfig, caches: list, dump: int) -> None:
    """Zero the pools and lengths and point every table row at the dump
    page, in place: the empty state of :func:`init_paged_caches` on the
    same storage."""
    def one(c, _stacked):
        c[0].zero_()             # k or ckv pages
        c[1].zero_()             # v or rope-key pages
        c.block_tables.fill_(dump)
        c.lengths.zero_()
    map_layers(cfg, caches, one)


def _scatter_pages(pages: torch.Tensor, dense_seq: torch.Tensor,
                   ids: torch.Tensor, stacked: bool) -> None:
    """Write dense (A, Lb, ...) prefill sequences into pages[ids] in place.

    ids is (A, Lb // page) int64: ONE index_put_ covers the whole admission
    group. Duplicate dump ids (pad blocks of short prompts) are fine: the
    dump page takes whichever block lands last and is never read.
    """
    A, nids = ids.shape
    flat = ids.reshape(-1)
    if stacked:
        nseg, page = pages.shape[0], pages.shape[2]
        pages[:, flat] = dense_seq.reshape((nseg, A * nids, page) + dense_seq.shape[3:])
    else:
        page = pages.shape[1]
        pages[flat] = dense_seq.reshape((A * nids, page) + dense_seq.shape[2:])


def _set_meta(c: PagedKVCache | PagedMLACache, slot, row, length, stacked: bool) -> None:
    """Install table rows and lengths in place; slot may be an int (the
    retire path) or an (A,) group with row (A, nb) and length (A,)."""
    if stacked:
        c.block_tables[:, slot] = row
        c.lengths[:, slot] = length
    else:
        c.block_tables[slot] = row
        c.lengths[slot] = length


def scatter_prefill(cfg: ModelConfig, caches: list, dense: list, slots: torch.Tensor,
                    ids: torch.Tensor, rows: torch.Tensor, lengths: torch.Tensor) -> None:
    """Admit a group of A requests in place: scatter their dense prefill
    caches (``model.prefill``'s, max_len = the bucket) into the slots'
    pages and install each slot's table row and length.

    slots (A,) and ids (A, Lb // page) are int64 indices, rows (A, nb) and
    lengths (A,) int32, all on the caches' device.
    """
    def one(pc, dc, stacked):
        if isinstance(pc, PagedMLACache):
            _scatter_pages(pc.ckv_pages, dc.ckv, ids, stacked)
            _scatter_pages(pc.kr_pages, dc.krope, ids, stacked)
        else:
            _scatter_pages(pc.k_pages, dc.k, ids, stacked)
            _scatter_pages(pc.v_pages, dc.v, ids, stacked)
        _set_meta(pc, slots, rows, lengths, stacked)

    for seg, pc, dc in zip(M.plan_segments(cfg), caches, dense):
        if seg.scanned:
            one(pc, dc, True)
        else:
            for p, d in zip(pc, dc):
                one(p, d, False)


def retire_slot(cfg: ModelConfig, caches: list, slot: int, dump: int) -> None:
    """Point the slot's table row at the dump page and zero its length, in
    place: any write the inactive slot still issues lands in garbage, never
    in a page that may be reassigned."""
    map_layers(cfg, caches, lambda c, stacked: _set_meta(c, slot, dump, 0, stacked))


def bump_lengths(cfg: ModelConfig, caches: list, inc: torch.Tensor) -> None:
    """Advance per-slot lengths by inc (S,) int32 in place: once per decode
    step, masked to the active slots, AFTER the step's writes (the attention
    layers never advance lengths)."""
    def one(c, _stacked):
        c.lengths.add_(inc)
    map_layers(cfg, caches, one)
