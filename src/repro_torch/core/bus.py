"""Flat-buffer gossip bus: the parameter tree mixed as one buffer per dtype.

The port of the reference's ``repro/core/bus.py``. It

1. flattens the worker-stacked parameter tree (and, in the fused train step,
   the optimizer-update tree) into one contiguous ``(M, R, C)`` buffer per
   dtype group, with the reference's layout plan (``BusLayout``): rows one
   ``LANE`` wide, whole sublane tiles per group, leaves in the reference's
   leaf order (:mod:`repro_torch._tree`), so offsets and ``padded_bytes``
   match it exactly;
2. pulls one neighbour buffer per non-identity permutation of the
   topology's Birkhoff decomposition ``A = Σ_p w_p·P_p`` — with every worker
   on one device that is a gather on the worker dimension, ``x[perm]``, the
   reference's single-process emulation of its bulk collective; over a live
   worker mesh (``mesh=``) it is one ``batch_isend_irecv`` per permutation
   and chunk, the reference's bulk ``ppermute`` (:func:`_ppermute`);
3. runs mix, weighted self term and ``−η·update`` as one pass of the fused
   ``gossip_mix`` kernel over the flat buffer, and unpacks the result.

The compressed lane (:func:`mix_bus_compressed`) mixes the same way but
sends every float group wider than the wire dtype over the wire as a bf16
cast or as int8 with one float32 scale per row (the ``quant_pack`` kernel),
with an error-feedback residual carried from call to call.

Under ``time_varying='one_peer_exp'`` the train step's fused pass is
:func:`mix_and_update_time_varying`, one permutation per step.

On a mesh each rank holds the tensors of its own workers (a worker dim of
``M / n_workers``, 1 with a worker per rank) and, for a leaf sharded over
the model axis, its 1/k piece. With ``param_specs`` (and k > 1) every rank
packs exactly its 1/k of the replica (:func:`plan_layout` with ``shards``):
tensor-sharded leaves whole, every other leaf row-split, so the exchanges
move 1/k of the bytes; the row-split leaves come back through one
all-gather per dtype group over the model axis. A neighbour on the same
rank is a local copy, never a message. The results equal the one-device
path's bit for bit: the same kernel, the same summation order.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch import _tree, telemetry
from repro_torch.kernels.gossip_mix import gossip_mix_2d
from repro_torch.kernels.quant_pack import quantize_pack_2d
from repro_torch.launch import cost

PyTree = Any

__all__ = ["BusLayout", "plan_layout", "pack", "unpack", "mix_bus",
           "bulk_collectives_per_step", "sharded_leaf_flags",
           "mix_and_update_time_varying", "mix_bus_compressed",
           "wire_dtype_for", "quantize_wire", "dequantize_wire",
           "sublane_rows", "LANE", "DEFAULT_BLOCK_R", "WIRE_DTYPES"]

# Bus rows are exactly one 128-wide lane tile: padding granularity is one
# sublane tile (sublane(dtype) × 128 elements) per group.
LANE = 128
# Row-block height the reference tiles its kernel with; here it only sets
# the granularity of the nchunks split (the CUDA kernel is not tiled by rows).
DEFAULT_BLOCK_R = 256


def sublane_rows(dtype: torch.dtype) -> int:
    """Sublane tile height the layout pads each group to: 8 fp32, 16 bf16, 32 int8."""
    return max(8, 32 // max(dtype.itemsize, 1))


# Wire dtypes of the compressed lane: bf16 is a plain cast; int8 carries one
# float32 scale per 128-lane bus row.
WIRE_DTYPES = ("bfloat16", "int8")
_WIRE = {"bfloat16": torch.bfloat16, "int8": torch.int8}
_SCALE_BYTES_PER_ROW = 4


def _wire(wire_dtype) -> torch.dtype:
    name = str(wire_dtype).removeprefix("torch.")
    if name not in _WIRE:
        raise ValueError(f"unsupported wire dtype {wire_dtype!r}; expected one of "
                         f"{WIRE_DTYPES}")
    return _WIRE[name]


def wire_dtype_for(dtype: torch.dtype, wire_dtype) -> torch.dtype | None:
    """The dtype a ``dtype`` bus group ships at on a compressed lane.

    ``None`` → the group stays exact: the lane is off (``wire_dtype=None``),
    the group is not floating point (int/bool state never quantizes), or
    compression would not shrink it (bf16 → bf16). Raises on wire dtypes
    outside :data:`WIRE_DTYPES` (names or torch dtypes).
    """
    if wire_dtype is None:
        return None
    wt = _wire(wire_dtype)
    if not dtype.is_floating_point or dtype.itemsize <= wt.itemsize:
        return None
    return wt


def quantize_wire(x: torch.Tensor, wire_dtype) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Quantize one tensor for the lossy wire: ``(payload, scale-or-None)``.

    bf16 wire is a cast (``scale=None``); int8 wire uses a per-row absmax
    scale over the LAST axis (``scale = absmax/127``, float32, shape
    ``x.shape[:-1] + (1,)``), so ``|x − payload·scale| ≤ scale/2``
    elementwise and all-zero rows round-trip exactly. The generic (leaf)
    twin of the bus-buffer kernel :func:`repro_torch.kernels.quant_pack.quantize_pack_2d`;
    its ``absmax/127`` is a true division, as the reference computes it
    eagerly, where the kernel follows the reference kernel's compiled
    multiply by ``fl32(1/127)``.
    """
    if _wire(wire_dtype) == torch.bfloat16:
        return x.to(torch.bfloat16), None
    xf = x.float()
    squeeze = xf.dim() == 0
    if squeeze:
        xf = xf[None]
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / 127.0, 1.0)
    q = torch.round(xf / scale).to(torch.int8)
    if squeeze:
        return q[0], scale[0]
    return q, scale


def dequantize_wire(payload: torch.Tensor, scale: torch.Tensor | None,
                    dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_wire` up to the quantization error."""
    if scale is None:
        return payload.to(dtype)
    return (payload.float() * scale).to(dtype)


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    """Assignment of one leaf to an element range of the flat buffer."""

    leaf_id: int      # index into the flattened tree
    size: int         # element count of the leaf (per worker, as held locally)
    chunk: int        # elements the leaf takes in one model shard's buffer
    offset: int       # start offset in the flat payload
    sharded: bool     # True: packed whole; False: row-split over the shards


@dataclasses.dataclass(frozen=True)
class _Group:
    """Leaves of one dtype packed into one (M, R, C) buffer."""

    dtype: torch.dtype
    slots: tuple[_LeafSlot, ...]   # payload order (row-split first)
    n: int            # payload elements (un-padded)
    rows: int         # R per shard — multiple of sublane(dtype)
    cols: int         # C — one lane tile (LANE)
    block_r: int      # row-block height (granularity of the nchunks split)
    split_off: int = 0   # payload offset where the row-split slots begin
    split_end: int = 0   # … and end


@dataclasses.dataclass(frozen=True)
class BusLayout:
    """Flatten/unflatten plan for a parameter tree, per model shard:
    ``shards`` is the model factor k the buffer rows split over."""

    treedef: Any
    shapes: tuple[tuple[int, ...], ...]   # per-worker leaf shapes
    groups: tuple[_Group, ...]
    shards: int = 1

    @property
    def n_buffers(self) -> int:
        return len(self.groups)

    def padded_elements(self) -> int:
        return sum(g.rows * g.cols for g in self.groups)

    def payload_elements(self) -> int:
        return sum(g.n for g in self.groups)

    def padded_bytes(self, wire_dtype=None) -> int:
        """Per-worker buffer bytes (incl. tile padding): the payload one
        neighbour exchange moves.

        ``wire_dtype`` prices the compressed lane: float groups wider than
        the wire dtype ship at its width, int8 plus one float32 scale per
        row; every other group stays at its exact bytes.
        """
        total = 0
        for g in self.groups:
            wt = wire_dtype_for(g.dtype, wire_dtype)
            if wt is None:
                total += g.rows * g.cols * g.dtype.itemsize
            else:
                total += g.rows * g.cols * wt.itemsize
                if wt == torch.int8:
                    total += g.rows * _SCALE_BYTES_PER_ROW
        return total


def _pick_block_r(rows: int, block_r: int, sub: int) -> int:
    """Largest tile height ≤ block_r dividing rows (a multiple of sub)."""
    b = (min(block_r, rows) // sub) * sub
    while b > sub and rows % b:
        b -= sub
    return max(b, sub)  # rows % sub == 0 by construction


def sharded_leaf_flags(param_specs: PyTree, model_axis: str | None,
                       treedef=None) -> tuple[bool, ...]:
    """Per leaf: does its partition spec shard over ``model_axis``?

    True: the rank's local value is already the 1/k tensor shard (the bus
    packs it whole); False: the leaf is replicated over the model axis and
    the bus row-splits it. ``treedef`` (of the param tree) reads the specs at
    its leaf positions."""
    specs = (_tree.flatten_up_to(treedef, param_specs) if treedef is not None
             else _tree.leaves(param_specs))

    def on_model(sp) -> bool:
        if model_axis is None or sp is None:
            return False
        return any(model_axis in (e if isinstance(e, tuple) else (e,)) for e in sp)

    return tuple(on_model(sp) for sp in specs)


def plan_layout(tree: PyTree, *, lead_ndim: int = 1,
                block_r: int = DEFAULT_BLOCK_R, shards: int = 1,
                leaf_sharded: Sequence[bool] | None = None) -> BusLayout:
    """The bus plan for ``tree``; ``lead_ndim`` leading dims of every leaf
    (the worker dim) stay out of the flat row.

    Leaves are grouped by dtype in leaf order; each group's payload is
    padded to whole sublane tiles of ``LANE``-wide rows, per model shard.
    With ``shards`` = k > 1, ``leaf_sharded[i]`` marks leaves whose local
    value is already the 1/k tensor shard (packed whole); every other leaf
    is row-split: shard s packs elements ``[s·c, (s+1)·c)`` of the flat
    leaf, ``c = ⌈n/k⌉``, the last shard zero-padded. Row-split leaves come
    first in each group, so the span the all-gather re-assembles is a head
    span of the payload.
    """
    leaves, treedef = _tree.flatten(tree)
    shapes = tuple(tuple(x.shape[lead_ndim:]) for x in leaves)
    if shards <= 1:
        flags = (True,) * len(leaves)       # one shard: every leaf packs whole
    elif leaf_sharded is None:
        flags = (False,) * len(leaves)      # row-split everything
    else:
        flags = tuple(bool(f) for f in leaf_sharded)
        if len(flags) != len(leaves):
            raise ValueError(f"{len(flags)} flags for {len(leaves)} leaves")
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    groups = []
    for dt, ids in by_dtype.items():
        sub = sublane_rows(dt)
        slots, off, split_lo, split_hi = [], 0, None, None
        for i in sorted(ids, key=lambda i: flags[i]):
            size = int(np.prod(shapes[i], dtype=np.int64))
            whole = flags[i] or size == 0
            chunk = size if whole else -(-size // shards)
            if not whole:
                split_lo = off if split_lo is None else split_lo
                split_hi = off + chunk
            slots.append(_LeafSlot(leaf_id=i, size=size, chunk=chunk,
                                   offset=off, sharded=whole))
            off += chunk
        rows = -(-max(off, 1) // LANE)
        rows = -(-rows // sub) * sub
        groups.append(_Group(dtype=dt, slots=tuple(slots), n=off, rows=rows,
                             cols=LANE,
                             block_r=_pick_block_r(rows, block_r, sub),
                             split_off=0 if split_lo is None else split_lo,
                             split_end=0 if split_hi is None else split_hi))
    return BusLayout(treedef=treedef, shapes=shapes, groups=tuple(groups),
                     shards=shards)


def pack(tree: PyTree, layout: BusLayout, *, lead_ndim: int = 1,
         shard_index: int = 0) -> list[torch.Tensor]:
    """Flatten ``tree`` into one (lead..., R, C) buffer per dtype group.

    A group's buffer takes the promoted dtype of the leaves packed into it
    (an update tree may differ in dtype from the params the plan was made
    for), as the reference's concatenation does. Padding is zero. With
    ``layout.shards > 1``, ``shard_index`` picks the row range of each
    row-split leaf this shard packs.
    """
    leaves, treedef = _tree.flatten(tree)
    if treedef != layout.treedef:
        raise ValueError("tree does not match the bus layout")
    bufs = []
    for g in layout.groups:
        parts = [leaves[s.leaf_id] for s in g.slots]
        lead = tuple(parts[0].shape[:lead_ndim])
        dtype = functools.reduce(torch.promote_types, [x.dtype for x in parts])
        buf = torch.empty(lead + (g.rows * g.cols,), dtype=dtype,
                          device=parts[0].device)
        for s, x in zip(g.slots, parts):
            flat = x.reshape(lead + (-1,))
            if not s.sharded and layout.shards > 1:
                lo = min(shard_index * s.chunk, s.size)
                have = min(s.chunk, s.size - lo)
                buf[..., s.offset:s.offset + have].copy_(flat[..., lo:lo + have])
                buf[..., s.offset + have:s.offset + s.chunk].zero_()
            else:
                buf[..., s.offset:s.offset + s.size].copy_(flat)
        buf[..., g.n:].zero_()
        bufs.append(buf.view(lead + (g.rows, g.cols)))
    return bufs


def unpack(bufs: Sequence[torch.Tensor], layout: BusLayout, *,
           lead_ndim: int = 1,
           gather: Callable[[torch.Tensor], torch.Tensor] | None = None) -> PyTree:
    """Inverse of :func:`pack` (padding dropped). The leaves are views into
    the buffers, not copies, but for row-split ones.

    With ``layout.shards > 1`` a row-split leaf needs the other shards'
    pieces back: ``gather`` maps the (lead..., span) row-split span of this
    shard's payload to the (shards, lead..., span) stack in shard order (on
    a mesh, the all-gather over the model axis).
    """
    leaves: list = [None] * len(layout.shapes)
    for g, buf in zip(layout.groups, bufs):
        lead = tuple(buf.shape[:lead_ndim])
        flat = buf.reshape(lead + (-1,))
        gathered = None
        if layout.shards > 1 and g.split_off < g.split_end:
            if gather is None:
                raise ValueError("row-split leaves need a gather")
            gathered = gather(flat[..., g.split_off:g.split_end])
        for s in g.slots:
            if s.sharded or layout.shards == 1:
                leaves[s.leaf_id] = flat[..., s.offset:s.offset + s.chunk].reshape(
                    lead + layout.shapes[s.leaf_id])
            else:
                off = s.offset - g.split_off
                piece = gathered[..., off:off + s.chunk].movedim(0, lead_ndim)
                leaves[s.leaf_id] = piece.reshape(lead + (-1,))[..., :s.size].reshape(
                    lead + layout.shapes[s.leaf_id])
    return _tree.unflatten(layout.treedef, leaves)


# ---------------------------------------------------------------------------
# Consensus over packed buffers
# ---------------------------------------------------------------------------


def _split_perms(spec) -> tuple[float, list[tuple[float, np.ndarray]]]:
    """(identity weight, non-identity (weight, perm) list) of spec's A."""
    ident = np.arange(spec.topology.M)
    a0 = 0.0
    others = []
    for w, perm in spec.permutations:
        if np.array_equal(perm, ident):
            a0 += w
        else:
            others.append((w, perm))
    return a0, others


def bulk_collectives_per_step(spec, nchunks: int = 1) -> int:
    """Bulk neighbour exchanges one bus gossip step issues: one per
    non-identity permutation and chunk (one gather each on one device)."""
    _, others = _split_perms(spec)
    return len(others) * max(nchunks, 1)


def _chunk_starts(rows: int, block_r: int, nchunks: int) -> list[tuple[int, int]]:
    """Split ``rows`` into ≤ nchunks (start, size) tiles of whole blocks."""
    nblocks = rows // block_r
    nchunks = max(1, min(nchunks, nblocks))
    base, extra = divmod(nblocks, nchunks)
    out, start = [], 0
    for c in range(nchunks):
        size = (base + (1 if c < extra else 0)) * block_r
        out.append((start, size))
        start += size
    return out


def _device_index(perm: np.ndarray, device: torch.device) -> torch.Tensor:
    """``perm`` as an int64 index on ``device``, copied once per permutation
    and device and then reused, so a step pays no copy."""
    perm = np.asarray(perm, np.int64)
    return _index_on(perm.tobytes(), torch.device(device))


@functools.lru_cache(maxsize=256)
def _index_on(perm_bytes: bytes, device: torch.device) -> torch.Tensor:
    """A CUDA copy goes through pinned memory, asynchronously: a pageable
    copy would make the host wait for the device. On ``meta`` (a dry run)
    the index lives on the device too, as on the card."""
    ix = torch.from_numpy(np.frombuffer(perm_bytes, np.int64).copy())
    if device.type == "cuda":
        return ix.pin_memory().to(device, non_blocking=True)
    if device.type == "meta":
        return ix.to(device)
    return ix


def _mix_buffers_local(bufs, upd_bufs, weights, eta, perms, nchunks, groups):
    """Every worker on one device: permutation = row gather on the worker dim.

    Mirrors the reference's chunking, each chunk of rows through its own
    kernel call. The neighbour stack is written straight into one
    contiguous (k, M·size, C) tensor, one gather per permutation.
    """
    outs = []
    for gi, (x, g) in enumerate(zip(bufs, groups)):
        M = x.shape[0]
        idx = [_device_index(perm, x.device) for _, perm in perms]
        pieces = []
        for start, size in _chunk_starts(g.rows, min(g.block_r, g.rows), nchunks):
            x_c = x[:, start:start + size]
            w2 = x_c.reshape(M * size, g.cols)
            nbrs = torch.empty((len(perms), M, size, g.cols), dtype=x.dtype,
                               device=x.device)
            for d, ix in enumerate(idx):
                torch.index_select(x_c, 0, ix, out=nbrs[d])
            u2 = None
            if upd_bufs is not None:
                u2 = upd_bufs[gi][:, start:start + size].reshape(M * size, g.cols)
            pieces.append(gossip_mix_2d(
                w2, nbrs.view(len(perms), M * size, g.cols), weights, u2,
                eta).view(M, size, g.cols))
        outs.append(pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1))
    return outs


# ---------------------------------------------------------------------------
# Over a worker mesh: one rank's workers, point-to-point exchanges
# ---------------------------------------------------------------------------


def _perm_pairs(spec, perms) -> list[list[tuple[int, int]]]:
    """(source, destination) worker pairs of each permutation."""
    M = spec.topology.M
    return [[(int(perm[j]), j) for j in range(M)] for _, perm in perms]


def _local_workers(wm, x: torch.Tensor, M: int) -> tuple[int, int]:
    """(workers on this rank, index of its first): the rank at worker-grid
    index g holds workers ``[g·m, (g+1)·m)``, ``m = M / n_workers``."""
    m = M // wm.n_workers
    if m * wm.n_workers != M or x.shape[0] != m:
        raise ValueError(f"{M} workers over {wm.describe()}: a rank holds {M / wm.n_workers:g}, "
                         f"this one got a worker dim of {x.shape[0]}")
    return m, wm.worker_index * m


def _ppermute(xs: Sequence[torch.Tensor], pairs, wm, M: int, outs=None):
    """The reference's ``lax.ppermute`` over the worker axes, for this rank's
    workers: ``outs[t][i]`` ← worker ``src``'s ``xs[t]`` for every pair
    ``(src, j)`` with j the rank's i-th worker. A source on this rank is a
    copy; the rest is ONE ``batch_isend_irecv`` over the worker group, with
    the same model shard of each peer (messages between two ranks in
    destination order). Returns ``(outs, pending)``: :func:`_wait` on
    ``pending`` (which also holds the sent tensors) before reading ``outs``."""
    import torch.distributed as dist

    m, j0 = _local_workers(wm, xs[0], M)
    if outs is None:
        outs = [torch.empty_like(x) for x in xs]
    shard, group = wm.model_index, wm.p2p_group
    here = range(j0, j0 + m)
    ops, sent = [], []
    pairs = sorted(pairs, key=lambda pr: pr[1])             # destination order
    for src, j in pairs:
        if src in here and j in here:
            for x, o in zip(xs, outs):
                o[j - j0].copy_(x[src - j0])
        elif j in here:
            peer = wm.rank_of(src // m, shard)
            ops += [dist.P2POp(dist.irecv, o[j - j0], peer, group) for o in outs]
        elif src in here:
            peer = wm.rank_of(j // m, shard)
            sent += [x[src - j0].contiguous() for x in xs]
            ops += [dist.P2POp(dist.isend, t, peer, group) for t in sent[-len(xs):]]
    if not ops:
        return outs, ([], sent)
    reqs = dist.batch_isend_irecv(ops)
    cost.record_collective(
        "collective-permute", sum(o.numel() * o.element_size() for o in outs),
        pairs=[(wm.rank_of(src // m, shard), wm.rank_of(j // m, shard)) for src, j in pairs],
        c10d_ops=len(ops))
    return outs, (reqs, sent)


def _wait(pending) -> None:
    for reqs, _sent in pending:
        for r in reqs:
            r.wait()


def _mix_group_chunked(x, u, rows: int, block_r: int, weights, eta, pairs, wm,
                       M: int, nchunks: int, *, gather=None, span=None):
    """Mix one rank's (m, rows, C) buffer: per chunk of rows, one exchange
    per permutation, then the fused kernel over the (m·size, C) rows.

    Chunk c+1's exchanges start before chunk c's kernel, so on a card they
    overlap it. ``gather``/``span``: the row-split re-assembly (one
    all-gather over the model axis of the payload's head span) starts as
    soon as the chunks covering the span have run. Returns the mixed buffer,
    and with ``gather`` also the gathered (shards, m, span) stack.
    """
    m, C = x.shape[0], x.shape[-1]
    chunks = _chunk_starts(rows, min(block_r, rows), nchunks)

    def start(c):
        lo, size = chunks[c]
        nbrs = torch.empty((len(pairs), m, size, C), dtype=x.dtype, device=x.device)
        return nbrs, [_ppermute([x[:, lo:lo + size]], pr, wm, M, outs=[nbrs[d]])[1]
                      for d, pr in enumerate(pairs)]

    nxt = start(0)
    pieces, gathered, done = [], None, 0
    for c, (lo, size) in enumerate(chunks):
        (nbrs, pending), nxt = nxt, (start(c + 1) if c + 1 < len(chunks) else None)
        _wait(pending)
        u2 = None if u is None else u[:, lo:lo + size].reshape(m * size, C)
        pieces.append(gossip_mix_2d(x[:, lo:lo + size].reshape(m * size, C),
                                    nbrs.view(len(pairs), m * size, C), weights, u2,
                                    eta).view(m, size, C))
        done += size * C
        if gather is not None and gathered is None and done >= span[1]:
            head = torch.cat(pieces, 1).reshape(m, -1)
            gathered = gather(head[:, span[0]:span[1]])
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 1)
    return out if gather is None else (out, gathered)


def _all_gather(x: torch.Tensor, wm):
    """(m, span) → (k, m, span), the model shards' spans in shard order."""
    import torch.distributed as dist

    out = torch.empty((wm.model_factor,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=wm.model_group)
    cost.record_collective("all-gather", out.numel() * out.element_size(), wm.model_group)
    return out


def _mix_buffers_sharded(bufs, upd_bufs, spec, wm, weights, eta, perms, nchunks, groups):
    """Mesh path with whole replicas per rank: this rank's (m, R, C)
    buffers, one exchange per permutation and chunk."""
    pairs = _perm_pairs(spec, perms)
    M = spec.topology.M
    return [_mix_group_chunked(x, None if upd_bufs is None else upd_bufs[gi], g.rows,
                               g.block_r, weights, eta, pairs, wm, M, nchunks)
            for gi, (x, g) in enumerate(zip(bufs, groups))]


def _mix_pytree_model_sharded(params, updates, spec, wm, param_specs, weights, eta,
                              perms, nchunks, block_r):
    """Worker-group path: gossip composed with model-sharded replicas.

    This rank packs exactly its 1/k of its workers' replicas (tensor-sharded
    leaves as local shards, every other leaf row-split), exchanges it with
    the same model shard of each neighbour, and re-assembles the row-split
    leaves with one all-gather per dtype group over the model axis, started
    off the head chunks. Elementwise consensus on every shard is consensus
    on the whole replica.
    """
    pairs = _perm_pairs(spec, perms)
    M = spec.topology.M
    k = wm.model_factor if spec.model_axis else 1
    flags = sharded_leaf_flags(param_specs, spec.model_axis,
                               treedef=_tree.flatten(params)[1])
    layout = plan_layout(params, lead_ndim=1, block_r=block_r, shards=k,
                         leaf_sharded=flags)
    tel = telemetry.get()
    if tel.active:
        tel.gauge("bus.padded_bytes_shard", layout.padded_bytes())
        tel.counter("bus.all_gathers", sum(1 for g in layout.groups
                                           if k > 1 and g.split_off < g.split_end))
    s = wm.model_index if k > 1 else 0
    bufs = pack(params, layout, shard_index=s)
    upd_bufs = None if updates is None else pack(updates, layout, shard_index=s)
    outs, gathered = [], []
    for gi, g in enumerate(layout.groups):
        u = None if upd_bufs is None else upd_bufs[gi]
        if k > 1 and g.split_off < g.split_end:
            out, gat = _mix_group_chunked(bufs[gi], u, g.rows, g.block_r, weights, eta,
                                          pairs, wm, M, nchunks,
                                          gather=lambda x: _all_gather(x, wm),
                                          span=(g.split_off, g.split_end))
            gathered.append(gat)
        else:
            out = _mix_group_chunked(bufs[gi], u, g.rows, g.block_r, weights, eta,
                                     pairs, wm, M, nchunks)
        outs.append(out)
    gat_iter = iter(gathered)
    return unpack(outs, layout, gather=(lambda _span: next(gat_iter)) if gathered else None)


def _live(mesh):
    """The WorkerMesh of a live ``mesh`` argument (None passes through)."""
    from repro_torch.launch.mesh import WorkerMesh

    wm = WorkerMesh.ensure(mesh)
    if wm is not None and not wm.live:
        raise ValueError(f"{wm.describe()} is abstract; mixing needs a live mesh")
    return wm


def mix_bus(params: PyTree, spec, mesh=None, *, updates: PyTree | None = None,
            eta: float = 1.0, nchunks: int = 1, block_r: int = DEFAULT_BLOCK_R,
            param_specs: PyTree | None = None) -> PyTree:
    """Consensus (+ optional fused update) over the flat parameter bus.

    Computes ``P_j ← Σ_i A[i,j]·P_i − eta·U_j`` for every worker j in one
    fused pass per dtype group. The train step passes the optimizer deltas
    (which already include −lr) with ``eta=-1.0``, so the pass lands on
    ``mix(params) + update``. Leaves carry the leading worker dim M.

    With a live ``mesh`` (a ``launch.mesh.WorkerMesh`` or its DeviceMesh)
    the leaves are this rank's (worker dim ``M / n_workers``) and each
    non-identity permutation is one exchange per chunk; ``param_specs``
    (``launch.shardings.param_pspecs``) switches to the per-model-shard
    bus, which every rank runs on its 1/k of the replica.

    With a telemetry sink active, each call counts ``bus.mix_calls`` and
    ``bus.collectives``, gauges ``bus.padded_bytes`` (the per-worker payload
    one exchange moves) and runs its gathers and kernel launches inside a
    ``bus.fused_mix`` profiler range.
    """
    wm = _live(mesh)
    a0, others = _split_perms(spec)
    tel = telemetry.get()
    if tel.active:
        tel.counter("bus.mix_calls")
        tel.counter("bus.collectives", bulk_collectives_per_step(spec, nchunks))
    weights = np.asarray([a0] + [w for w, _ in others], np.float32)
    if not others:  # degenerate (M == 1): no communication at all
        if updates is None:
            return params
        w0, e = float(weights[0]), float(np.float32(eta))
        return _tree.map(lambda b, u: (b.float() * w0 - e * u.float()).to(b.dtype),
                         params, updates)
    eta = eta if updates is not None else None
    if wm is not None and param_specs is not None:
        with tel.annotate("bus.fused_mix"):
            return _mix_pytree_model_sharded(params, updates, spec, wm, param_specs,
                                             weights, eta, others, nchunks, block_r)
    layout = plan_layout(params, lead_ndim=1, block_r=block_r)
    if tel.active:
        tel.gauge("bus.padded_bytes", layout.padded_bytes())
    bufs = pack(params, layout)
    upd_bufs = pack(updates, layout) if updates is not None else None
    with tel.annotate("bus.fused_mix"):
        if wm is not None:
            mixed = _mix_buffers_sharded(bufs, upd_bufs, spec, wm, weights, eta, others,
                                         nchunks, layout.groups)
        else:
            mixed = _mix_buffers_local(bufs, upd_bufs, weights, eta, others, nchunks,
                                       layout.groups)
    return unpack(mixed, layout)


def mix_and_update_time_varying(params: PyTree, spec, updates: PyTree,
                                step: int, mesh=None, *, eta: float = -1.0,
                                **kw) -> PyTree:
    """Fused mix + update under ``time_varying='one_peer_exp'``: the fused
    bus pass of round ``step % log2(M)``, whose pairwise topology has one
    non-identity permutation, so each dtype group is one ``gossip_mix``
    launch with k = 1. ``kw`` (``param_specs`` among them) forwards to
    :func:`mix_bus`."""
    rounds = spec.one_peer_specs
    return mix_bus(params, rounds[step % len(rounds)], mesh, updates=updates,
                   eta=eta, **kw)


# ---------------------------------------------------------------------------
# Compressed (lossy) consensus lane — the cross-pod stage of hierarchical gossip
# ---------------------------------------------------------------------------


def _quantize_rows(xe: torch.Tensor, block_r: int) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 quantize-pack of a (lead..., R, C) float32 buffer → ``(values
    int8, scales float32 (lead..., R, 1))``, one scale per bus row, by the
    quant_pack kernel over the row-flattened view."""
    x2 = xe.reshape(-1, xe.shape[-1])
    q, s = quantize_pack_2d(x2, block_r=min(block_r, x2.shape[0]))
    return q.view(xe.shape), s.view(xe.shape[:-1] + (1,))


def _dequant_f32(v: torch.Tensor, s: torch.Tensor | None) -> torch.Tensor:
    return v.float() if s is None else v.float() * s


def _mix_buffers_local_compressed(bufs, res_bufs, weights, perms, groups, wire_dtype):
    """Every worker on one device: the permutation is a row gather of the
    dequantized buffer, which equals sending (values, scales) and
    dequantizing at the receiver. The reference's order of operations:
    ``acc = deq·w₀``, then ``+= deq[perm]·w`` per permutation, one cast, and
    the new residual ``xe − deq``. Products are formed in place on fresh
    temporaries, which rounds exactly as the out-of-place expressions."""
    outs, new_res = [], []
    for gi, (x, g) in enumerate(zip(bufs, groups)):
        wt = wire_dtype_for(g.dtype, wire_dtype)
        idx = [_device_index(perm, x.device) for _, perm in perms]
        if wt is None:   # exact group: int/bool state never quantizes
            acc = x.float() * weights[0]
            for i, ix in enumerate(idx):
                acc += x[ix].float().mul_(weights[i + 1])
            outs.append(acc.to(g.dtype))
            new_res.append(None)
            continue
        xe = torch.add(x, res_bufs[gi])          # x promoted to float32 exactly
        if wt == torch.bfloat16:
            v, s = xe.to(torch.bfloat16), None
        else:
            v, s = _quantize_rows(xe, g.block_r)
        deq = _dequant_f32(v, s)
        del v, s
        acc = deq * weights[0]
        for i, ix in enumerate(idx):
            acc += deq[ix].mul_(weights[i + 1])
        outs.append(acc.to(g.dtype))
        del acc
        new_res.append(xe.sub_(deq))
    return outs, new_res


def _mix_buffers_sharded_compressed(bufs, res_bufs, spec, wm, weights, perms, groups,
                                    wire_dtype):
    """The compressed lane over a mesh: each exchange carries the WIRE image
    (int8 values and their float32 row scales, or the bf16 cast), not the
    buffer, one ``batch_isend_irecv`` per permutation holding both. Every
    worker mixes dequantized values, its own included, in the one-device
    path's order, so the two agree bit for bit."""
    pairs = _perm_pairs(spec, perms)
    M = spec.topology.M

    def exchanged(ts, pr):
        got, pending = _ppermute(ts, pr, wm, M)
        _wait([pending])
        return got

    outs, new_res = [], []
    for gi, (x, g) in enumerate(zip(bufs, groups)):
        wt = wire_dtype_for(g.dtype, wire_dtype)
        if wt is None:   # exact group: int/bool state never quantizes
            acc = x.float() * weights[0]
            for i, pr in enumerate(pairs):
                acc += exchanged([x], pr)[0].float().mul_(weights[i + 1])
            outs.append(acc.to(g.dtype))
            new_res.append(None)
            continue
        xe = torch.add(x, res_bufs[gi])
        if wt == torch.bfloat16:
            v, s = xe.to(torch.bfloat16), None
        else:
            v, s = _quantize_rows(xe, g.block_r)
        deq = _dequant_f32(v, s)
        acc = deq * weights[0]
        for i, pr in enumerate(pairs):
            got = exchanged([v] if s is None else [v, s], pr)
            acc += _dequant_f32(got[0], None if s is None else got[1]).mul_(weights[i + 1])
        outs.append(acc.to(g.dtype))
        del acc
        new_res.append(xe.sub_(deq))
    return outs, new_res


def mix_bus_compressed(params: PyTree, spec, mesh=None, *, wire_dtype,
                       residual: list | None = None,
                       block_r: int = DEFAULT_BLOCK_R) -> tuple[PyTree, list | None]:
    """Lossy consensus with error feedback — the compressed cross-pod lane.

    The same ``P_j ← Σ_i A[i,j]·P_i`` as :func:`mix_bus`, but every float
    dtype group wider than ``wire_dtype`` rides the wire quantized (bf16
    cast, or int8 with one float32 scale per bus row). Error feedback: the
    residual ``r ← (x + r) − dequant(quant(x + r))`` is carried across calls
    and every worker, self term included, mixes dequantized values.

    Returns ``(mixed_params, new_residual)``. ``residual`` is an opaque
    per-dtype-group list (``None`` on the first call → zeros; ``None``
    entries for exact groups); thread it through successive calls.
    ``wire_dtype=None`` delegates to :func:`mix_bus` bit-identically and
    passes ``residual`` through untouched. With a telemetry sink active it
    counts ``bus.mix_calls`` and ``bus.collectives``, gauges
    ``bus.dci_padded_bytes`` and ``bus.dci_bytes_ratio`` and runs inside a
    ``bus.compressed_mix`` profiler range. With a live ``mesh`` the leaves
    and the residual are this rank's workers' (:func:`mix_bus`).
    """
    wm = _live(mesh)
    if wire_dtype is None:
        return mix_bus(params, spec, mesh, block_r=block_r), residual
    a0, others = _split_perms(spec)
    weights = [float(w) for w in np.asarray([a0] + [w for w, _ in others], np.float32)]
    layout = plan_layout(params, lead_ndim=1, block_r=block_r)
    wts = [wire_dtype_for(g.dtype, wire_dtype) for g in layout.groups]
    tel = telemetry.get()
    if tel.active:
        wire_b = layout.padded_bytes(wire_dtype)
        tel.counter("bus.mix_calls")
        # int8 groups ship values + scales: two exchanges per permutation
        tel.counter("bus.collectives", len(others) * sum(
            1 if wt is None else (2 if wt == torch.int8 else 1) for wt in wts))
        tel.gauge("bus.dci_padded_bytes", wire_b)
        tel.gauge("bus.dci_bytes_ratio", layout.padded_bytes() / max(wire_b, 1))
    if not others:   # degenerate (M == 1): nothing rides the wire
        return params, residual
    bufs = pack(params, layout)
    res_bufs = residual
    if res_bufs is None:
        res_bufs = [None if wt is None else torch.zeros(b.shape, dtype=torch.float32,
                                                        device=b.device)
                    for b, wt in zip(bufs, wts)]
    if len(res_bufs) != len(bufs):
        raise ValueError("residual does not match the bus layout")
    with tel.annotate("bus.compressed_mix"):
        if wm is not None:
            mixed, new_res = _mix_buffers_sharded_compressed(
                bufs, res_bufs, spec, wm, weights, others, layout.groups, wire_dtype)
        else:
            mixed, new_res = _mix_buffers_local_compressed(bufs, res_bufs, weights, others,
                                                           layout.groups, wire_dtype)
    return unpack(mixed, layout), new_res
