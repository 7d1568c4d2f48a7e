"""Wrapper of the consensus-statistics kernel (``csrc/consensus_stats.cu``).

:func:`plan` lays a step's gradient and new-param leaves out as the
kernel's table: one row per piece of a leaf (data pointer, worker stride,
elements of a run, slot, runs and their stride), a leaf cut into an
unaligned head, a body of 16-byte column tiles and a tail, one table per
dtype.
:func:`consensus_stats` runs a plan: one launch per dtype group (the
statistics kernel and its second pass), giving the (4, 2) float32 sums of
:func:`.ref.consensus_stats_reference`. It replaces no kernel of the TPU
package (the source says why it exists).

For CPU tensors it runs the plain version (:mod:`.ref`); for CUDA tensors
it launches the kernel, built at first call, or raises. There is no
fallback from one to the other: :func:`plan` refuses a CUDA leaf of a
dtype other than float32, bfloat16 and float16. A worker's copy may lie in
memory in any order and with gaps (a transposed gradient, a model axis's
shard of a wider dim): the table lists it as rows of adjacent runs. For ``meta``
tensors (a dry run) it takes the card's route as far as the launch: an
output of the kernel's shape and dtype, and no launch. Each launch is an
operator of PyTorch's dispatcher (``repro_torch::consensus_stats``), so a
profiler links the kernel to it and to the ranges around it; on ``meta``
the same operator runs and does nothing.
``consensus_stats.launches`` counts launches,
``consensus_stats.reread_columns`` the column tiles read twice (above
:data:`HELD_MAX_WORKERS` workers). Each launch, and each call on ``meta``,
reports its :func:`work` to a running ``launch.cost.measure``.

Forms, chosen from the inputs: the meshless step keeps the column sums in
registers (``HELD``); with the column sums given (a worker mesh, where they
are all-reduced first) the kernel reads them (``SUMS``). The allreduce
mode's gradient norm is ``HELD`` over one worker (x̄ = x, E = Σ x²).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.consensus_stats.ref import consensus_stats_reference
from repro_torch.launch import cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "consensus_stats.cu"
HELD_MAX_WORKERS = 8           # workers whose column tiles a thread holds in registers
THREADS = 256
HELD, SUMS = 0, 1              # forms
_PARAM, _SHARDED, _VECTOR = 1, 2, 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# table columns (int64): ptr, wstride, count, units, rot, sums, flags, first, rows, rstride
_UNITS, _ROT, _FIRST = 3, 4, 7


@functools.cache
def library() -> tuple[ctypes.CDLL, str]:
    """The built kernel library and its compiler log (built once per process)."""
    lib, log = _build.load("consensus_stats", SOURCE)
    lib.consensus_stats.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.consensus_stats.restype = ctypes.c_int
    lib.consensus_stats_blocks.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.consensus_stats_blocks.restype = ctypes.c_int
    lib.consensus_stats_held_max_workers.argtypes = []
    lib.consensus_stats_held_max_workers.restype = ctypes.c_int
    if lib.consensus_stats_held_max_workers() != HELD_MAX_WORKERS:
        raise RuntimeError("consensus_stats.cu and kernel.py disagree on HELD_MAX_WORKERS")
    return lib, log


@functools.cache
def _resident_blocks(device_index: int, dtype_code: int, workers: int, form: int) -> int:
    """Blocks of the kernel for (dtype, workers, form) the card holds at once."""
    lib, _ = library()
    with torch.cuda.device(device_index):
        n = lib.consensus_stats_blocks(dtype_code, workers, form)
    if n <= 0:
        raise RuntimeError(f"consensus_stats occupancy query failed: cudaError {-n}")
    return n


class Group(NamedTuple):
    """One launch: the pieces of one dtype's leaves."""
    dtype: torch.dtype
    rows: np.ndarray      # (pieces, 10) int64, ``rot`` still 0
    units: int            # column tiles over all pieces
    ops: int              # operations the launch does
    nbytes: int           # bytes it reads


class Plan(NamedTuple):
    """A step's statistics as the kernel and the plain version share them."""
    device: torch.device
    M: int                # the workers x̄ divides by
    workers: int          # the workers each leaf holds (its leading dim)
    form: int
    groups: tuple         # Group per dtype, in order of first appearance
    plain: dict | None    # CPU: keyword arguments of consensus_stats_reference
    plain_leaves: int     # leaves the plain version sums (CPU)
    keep: tuple           # the tensors the tables point into

    @property
    def nbytes(self) -> int:
        """Bytes the kernel reads."""
        return sum(g.nbytes for g in self.groups)

    @property
    def reread_columns(self) -> int:
        """Column tiles the kernel reads twice."""
        return sum(g.units for g in self.groups) if self.form == HELD and \
            self.workers > HELD_MAX_WORKERS else 0


def _same_order(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether ``a`` and ``b`` lay their elements out in the same order."""
    return [(n, st) for n, st in zip(a.shape, a.stride()) if n != 1] == \
        [(n, st) for n, st in zip(b.shape, b.stride()) if n != 1]


def _runs(shape, stride) -> tuple[int, int, int, list[int]]:
    """A worker's copy as runs of adjacent elements, its dims taken in the
    order of their strides: (elements of a run, runs a row of them at one
    stride, that stride, and the element offset at which each such row
    starts); one run and one offset for a copy that fills a block of its
    own size."""
    dims = sorted((st, n) for n, st in zip(shape, stride) if n != 1)
    run, rows, rstride = 1, 1, 0
    while dims and dims[0][0] == run:
        run *= dims.pop(0)[1]
    if dims:
        rstride, rows = dims.pop(0)
        while dims and dims[0][0] == rows * rstride:
            rows *= dims.pop(0)[1]
    offsets = [0]
    for st, n in dims:
        offsets = [o + i * st for o in offsets for i in range(n)]
    return run, rows, rstride, offsets


def _pieces(ptr: int, ws: int, n: int, esize: int, workers: int, sums_ptr: int,
            flags: int, rows: int = 1, rstride: int = 0) -> list[list[int]]:
    """The table rows of ``rows`` runs of ``n`` elements, ``rstride`` apart:
    an unaligned head and a tail element by element, the body in 16-byte
    column tiles (every worker's copy and every run must then start 16-byte
    aligned, which the strides decide)."""
    vec = 16 // esize
    aligned = not (workers > 1 and (ws * esize) % 16) and not (rows > 1 and (rstride * esize) % 16)
    head = min(n, (-ptr % 16) // esize) if aligned else n
    body = (n - head) // vec * vec
    out = []
    for start, count, v in ((0, head, 1), (head, body, vec), (head + body, n - head - body, 1)):
        if count:
            out.append([ptr + start * esize, ws, count, rows * (count // v), 0,
                        sums_ptr + 4 * start if sums_ptr else 0,
                        flags | (_VECTOR if v > 1 else 0), 0, rows, rstride])
    return out


def _leaf_work(n: int, esize: int, workers: int, form: int, grad: bool,
               sums: bool) -> tuple[int, int]:
    """(operations, bytes) of one leaf of ``n`` elements a worker: per
    element of each worker a square and an add for E (a gradient), an add
    for the column sum (none when the sums are given), a subtract, a square
    and an add for the deviation; per column a divide, and for a gradient
    the mean's square and add. Every element is read once (twice above
    :data:`HELD_MAX_WORKERS` workers without sums), and the sums where
    given."""
    per_elem = (2 if grad else 0) + (3 if sums else 4)
    reread = 2 if form == HELD and workers > HELD_MAX_WORKERS else 1
    return (n * (workers * per_elem + (3 if grad else 1)),
            workers * n * esize * reread + (4 * n if sums else 0))


def plan(grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor], M: int, *,
         grad_sharded: Sequence[bool] | None = None,
         param_sharded: Sequence[bool] | None = None,
         grad_sums: Sequence[torch.Tensor] | None = None,
         param_sums: Sequence[torch.Tensor] | None = None) -> Plan:
    """The plan of one call (module docstring). ``grads`` and ``params``
    carry a leading worker dim; ``*_sharded`` flag the leaves a model axis
    shards; ``*_sums`` are the leaves' float32 column sums over all M
    workers (a worker mesh's, all-reduced), which choose the ``SUMS``
    form."""
    grads, params = list(grads), list(params)
    leaves = grads + params
    if not leaves:
        raise ValueError("consensus_stats needs at least one leaf")
    device = leaves[0].device
    if any(x.device != device for x in leaves):
        raise ValueError(f"all leaves must be on {device}")
    form = SUMS if grad_sums is not None or param_sums is not None else HELD
    workers = leaves[0].shape[0] if leaves[0].dim() else 0
    if any(x.dim() < 1 or x.shape[0] != workers for x in leaves):
        raise ValueError("every leaf needs the same leading worker dim")
    if form == SUMS and ((grads and grad_sums is None) or (params and param_sums is None)):
        raise ValueError("give the column sums of both trees or of neither")
    if form == HELD and workers != M:
        raise ValueError(f"{workers} workers' leaves without column sums, but M = {M}")
    plain = {"grads": [], "params": [], "grad_sharded": [], "param_sharded": [],
             "grad_sums": [] if form == SUMS else None,
             "param_sums": [] if form == SUMS else None} if device.type == "cpu" else None
    by_dtype: dict[torch.dtype, list] = {}
    for kind, xs, flags, sums in (("grad", grads, grad_sharded, grad_sums),
                                  ("param", params, param_sharded, param_sums)):
        flags = [False] * len(xs) if flags is None else list(flags)
        sums = [None] * len(xs) if sums is None else list(sums)
        if len(flags) != len(xs) or len(sums) != len(xs):
            raise ValueError(f"one sharded flag and one sum (or none) per {kind} leaf")
        for x, sharded, s in zip(xs, flags, sums):
            n = x.numel() // max(workers, 1)
            if n == 0:
                continue
            if plain is not None:
                plain[kind + "s"].append(x)
                plain[kind + "_sharded"].append(sharded)
                if s is not None:
                    plain[kind + "_sums"].append(s)
                continue
            if x.dtype not in _DTYPE_CODE:
                raise ValueError(f"consensus_stats reads float32, bfloat16 and float16 "
                                 f"leaves, not a {kind} leaf of {x.dtype}")
            if s is not None and (s.dtype != torch.float32 or s.device != device
                                  or s.shape != x.shape[1:] or not _same_order(s, x[0])):
                raise ValueError(f"column sums must be float32 on {device}, shaped and "
                                 "laid out as a worker's copy (ref.column_sums)")
            esize = x.element_size()
            flag = (_PARAM if kind == "param" else 0) | (_SHARDED if sharded else 0)
            run, rows, rstride, offsets = _runs(x.shape[1:], x.stride()[1:])
            g = by_dtype.setdefault(x.dtype, [[], 0, 0])
            for o in offsets:
                g[0].extend(_pieces(x.data_ptr() + o * esize, x.stride(0), run, esize, workers,
                                    0 if s is None else s.data_ptr() + 4 * o, flag, rows,
                                    rstride))
            ops, nbytes = _leaf_work(n, esize, workers, form, kind == "grad", s is not None)
            g[1] += ops
            g[2] += nbytes
    groups = []
    for dt, (rows, ops, nbytes) in by_dtype.items():
        table = np.asarray(rows, dtype=np.int64)
        table[:, _FIRST] = np.cumsum(table[:, _UNITS]) - table[:, _UNITS]
        groups.append(Group(dt, table, int(table[:, _UNITS].sum()), ops, nbytes))
    return Plan(device, M, workers, form, tuple(groups), plain,
                len(plain["grads"]) + len(plain["params"]) if plain is not None else 0,
                (grads, params, grad_sums, param_sums))


def work(g: Group) -> tuple[int, int]:
    """(operations, bytes) of one launch: its leaves' :func:`_leaf_work`."""
    return g.ops, g.nbytes


def consensus_stats(p: Plan) -> torch.Tensor:
    """The (4, 2) float32 statistics of a :func:`plan`: rows E, E_sp,
    ||ḡ||² and the spread, columns (sharded, whole)."""
    if p.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"consensus_stats runs on CPU, CUDA or meta tensors, not {p.device}")
    if p.plain is not None:
        return consensus_stats_reference(**p.plain, M=p.M, device=p.device)
    out = (torch.empty if p.groups else torch.zeros)((4, 2), dtype=torch.float32,
                                                     device=p.device)
    for i, g in enumerate(p.groups):
        code = _DTYPE_CODE[g.dtype]
        rows, blocks = g.rows, 0
        if p.device.type == "cuda":
            workers = min(p.workers, HELD_MAX_WORKERS + 1)    # above 8, one kernel for all
            blocks = max(1, min(_resident_blocks(p.device.index, code, workers, p.form),
                                -(-g.units // THREADS)))
            rows = rows.copy()
            rows[:, _ROT] = rows[:, _FIRST] % (blocks * THREADS)
            consensus_stats.launches += 1
            if p.form == HELD and p.workers > HELD_MAX_WORKERS:
                consensus_stats.reread_columns += g.units
        _kernel_op(torch.from_numpy(rows), blocks, code, p.workers, p.M, p.form, out, i > 0)
        cost.record_kernel("consensus_stats", lambda g=g: work(g))
    return out


@torch.library.custom_op("repro_torch::consensus_stats", mutates_args=("out",))
def _kernel_op(table: torch.Tensor, blocks: int, dtype_code: int, workers: int, M: int,
               form: int, out: torch.Tensor, accumulate: bool) -> None:
    """One launch of the kernel and its second pass on the current stream,
    over ``table`` (the host's rows), into ``out``, as one operator of the
    dispatcher: a profiler links the kernels to it, and a dispatch mode
    (``launch.cost``) sees it alone, the same on the card and on ``meta``,
    where it does nothing."""
    if out.device.type == "meta":
        return
    lib, _ = library()
    # a pinned copy, so that the copy to the card does not wait for it
    table = table.pin_memory().to(out.device, non_blocking=True)
    partials = torch.empty(blocks * 8, dtype=torch.float64, device=out.device)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.consensus_stats(table.data_ptr(), table.shape[0], blocks, dtype_code,
                                  workers, M, form, partials.data_ptr(), out.data_ptr(),
                                  int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"consensus_stats kernel launch failed: cudaError {err}")


consensus_stats.launches = 0
consensus_stats.reread_columns = 0
