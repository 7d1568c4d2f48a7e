"""Flat-buffer gossip bus: the parameter tree mixed as one buffer per dtype.

The port of the reference's ``repro/core/bus.py``, exact lane, one process.
It

1. flattens the worker-stacked parameter tree (and, in the fused train step,
   the optimizer-update tree) into one contiguous ``(M, R, C)`` buffer per
   dtype group, with the reference's layout plan (``BusLayout``): rows one
   ``LANE`` wide, whole sublane tiles per group, leaves in the reference's
   leaf order (:mod:`repro_torch._tree`), so offsets and ``padded_bytes``
   match it exactly;
2. pulls one neighbour buffer per non-identity permutation of the
   topology's Birkhoff decomposition ``A = Σ_p w_p·P_p`` — with every worker
   on one device that is a gather on the worker dimension, ``x[perm]``, the
   reference's single-process emulation of its bulk collective;
3. runs mix, weighted self term and ``−η·update`` as one pass of the fused
   ``gossip_mix`` kernel over the flat buffer, and unpacks the result.

The model-sharded paths and the compressed (int8/bf16 wire) lane are later
slices (ROADMAP queue 1).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.kernels.gossip_mix import gossip_mix_2d

PyTree = Any

__all__ = ["BusLayout", "plan_layout", "pack", "unpack", "mix_bus",
           "sublane_rows", "LANE", "DEFAULT_BLOCK_R"]

# Bus rows are exactly one 128-wide lane tile: padding granularity is one
# sublane tile (sublane(dtype) × 128 elements) per group.
LANE = 128
# Row-block height the reference tiles its kernel with; here it only sets
# the granularity of the nchunks split (the CUDA kernel is not tiled by rows).
DEFAULT_BLOCK_R = 256


def sublane_rows(dtype: torch.dtype) -> int:
    """Sublane tile height the layout pads each group to: 8 fp32, 16 bf16, 32 int8."""
    return max(8, 32 // max(dtype.itemsize, 1))


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    """Assignment of one leaf to an element range of the flat buffer."""

    leaf_id: int      # index into the flattened tree
    size: int         # element count of the leaf (per worker)
    chunk: int        # elements the leaf takes in the buffer
    offset: int       # start offset in the flat payload
    sharded: bool     # True: packed whole (always, with one shard)


@dataclasses.dataclass(frozen=True)
class _Group:
    """Leaves of one dtype packed into one (M, R, C) buffer."""

    dtype: torch.dtype
    slots: tuple[_LeafSlot, ...]
    n: int            # payload elements (un-padded)
    rows: int         # R — multiple of sublane(dtype)
    cols: int         # C — one lane tile (LANE)
    block_r: int      # row-block height (granularity of the nchunks split)
    split_off: int = 0
    split_end: int = 0


@dataclasses.dataclass(frozen=True)
class BusLayout:
    """Flatten/unflatten plan for a parameter tree (one model shard)."""

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

    def padded_bytes(self) -> int:
        """Per-worker buffer bytes (incl. tile padding): the payload one
        neighbour exchange moves."""
        return sum(g.rows * g.cols * g.dtype.itemsize for g in self.groups)


def _pick_block_r(rows: int, block_r: int, sub: int) -> int:
    """Largest tile height ≤ block_r dividing rows (a multiple of sub)."""
    b = (min(block_r, rows) // sub) * sub
    while b > sub and rows % b:
        b -= sub
    return max(b, sub)  # rows % sub == 0 by construction


def plan_layout(tree: PyTree, *, lead_ndim: int = 1,
                block_r: int = DEFAULT_BLOCK_R) -> BusLayout:
    """The bus plan for ``tree``; ``lead_ndim`` leading dims of every leaf
    (the worker dim) stay out of the flat row.

    Leaves are grouped by dtype in leaf order; each group's payload is
    padded to whole sublane tiles of ``LANE``-wide rows.
    """
    leaves, treedef = _tree.flatten(tree)
    shapes = tuple(tuple(x.shape[lead_ndim:]) for x in leaves)
    by_dtype: dict[torch.dtype, list[int]] = {}
    for i, x in enumerate(leaves):
        by_dtype.setdefault(x.dtype, []).append(i)
    groups = []
    for dt, ids in by_dtype.items():
        sub = sublane_rows(dt)
        slots, off = [], 0
        for i in ids:
            size = int(np.prod(shapes[i], dtype=np.int64))
            slots.append(_LeafSlot(leaf_id=i, size=size, chunk=size,
                                   offset=off, sharded=True))
            off += size
        rows = -(-max(off, 1) // LANE)
        rows = -(-rows // sub) * sub
        groups.append(_Group(dtype=dt, slots=tuple(slots), n=off, rows=rows,
                             cols=LANE,
                             block_r=_pick_block_r(rows, block_r, sub)))
    return BusLayout(treedef=treedef, shapes=shapes, groups=tuple(groups))


def pack(tree: PyTree, layout: BusLayout, *, lead_ndim: int = 1) -> list[torch.Tensor]:
    """Flatten ``tree`` into one (lead..., R, C) buffer per dtype group.

    A group's buffer takes the promoted dtype of the leaves packed into it
    (an update tree may differ in dtype from the params the plan was made
    for), as the reference's concatenation does. Padding is zero.
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
            buf[..., s.offset:s.offset + s.size].copy_(x.reshape(lead + (-1,)))
        buf[..., g.n:].zero_()
        bufs.append(buf.view(lead + (g.rows, g.cols)))
    return bufs


def unpack(bufs: Sequence[torch.Tensor], layout: BusLayout, *,
           lead_ndim: int = 1) -> PyTree:
    """Inverse of :func:`pack` (padding dropped). The leaves are views into
    the buffers, not copies."""
    leaves: list = [None] * len(layout.shapes)
    for g, buf in zip(layout.groups, bufs):
        lead = tuple(buf.shape[:lead_ndim])
        flat = buf.reshape(lead + (-1,))
        for s in g.slots:
            leaves[s.leaf_id] = flat[..., s.offset:s.offset + s.chunk].reshape(
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
    """``perm`` as an int64 index on ``device``. A CUDA copy goes through
    pinned memory, asynchronously: a pageable copy would make the host wait
    for the device in the middle of every step."""
    ix = torch.from_numpy(np.asarray(perm, np.int64))
    if device.type == "cuda":
        return ix.pin_memory().to(device, non_blocking=True)
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


def mix_bus(params: PyTree, spec, *, updates: PyTree | None = None,
            eta: float = 1.0, nchunks: int = 1,
            block_r: int = DEFAULT_BLOCK_R) -> PyTree:
    """Consensus (+ optional fused update) over the flat parameter bus.

    Computes ``P_j ← Σ_i A[i,j]·P_i − eta·U_j`` for every worker j in one
    fused pass per dtype group. The train step passes the optimizer deltas
    (which already include −lr) with ``eta=-1.0``, so the pass lands on
    ``mix(params) + update``. Leaves carry the leading worker dim M.
    """
    a0, others = _split_perms(spec)
    weights = np.asarray([a0] + [w for w, _ in others], np.float32)
    if not others:  # degenerate (M == 1): no communication at all
        if updates is None:
            return params
        w0, e = float(weights[0]), float(np.float32(eta))
        return _tree.map(lambda b, u: (b.float() * w0 - e * u.float()).to(b.dtype),
                         params, updates)
    layout = plan_layout(params, lead_ndim=1, block_r=block_r)
    bufs = pack(params, layout)
    upd_bufs = pack(updates, layout) if updates is not None else None
    mixed = _mix_buffers_local(bufs, upd_bufs, weights,
                               eta if updates is not None else None,
                               others, nchunks, layout.groups)
    return unpack(mixed, layout)
