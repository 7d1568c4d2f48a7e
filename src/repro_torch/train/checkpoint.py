"""Parameter-tree checkpoints in the reference's npz format.

The port of the reference's ``repro/train/checkpoint.py``: one
``.npz`` whose keys are the leaves' tree paths (``"segments/0/mix/wq"``) in
JAX's leaf order, bf16 leaves stored as their raw 16 bits (a ``uint16``
view) under the key suffix ``::bf16``, and an optional
``<path>.meta.json`` holding the step. A checkpoint written by either
package restores in the other bit for bit.

:func:`save_sharded` writes a worker-stacked tree as one npz per worker
(``{base}.shard-w{j}.npz``) plus a ``{base}.meta.json`` that lists the
shards; :func:`restore`, :func:`export_consensus` and
:func:`consensus_from_sharded` read it. ``consensus_params`` collapses a
worker-stacked tree (the leading M dim the decentralized trainer keeps) to
the paper's output model w̄ = (1/M) Σ_j w_j, averaging in float32 and
casting back. :class:`AsyncCheckpointWriter` snapshots into pinned host
memory and moves the disk write off the training loop's thread.

On a live worker mesh (``wmesh=``) each rank passes its own workers' part
of the tree (``launch.shardings.local_tree``):
:func:`save_sharded` has every rank write its own workers' files, keyed by
the reference's ``WorkerMesh`` coordinates (:func:`worker_coords`, e.g.
``shard-pod1-data3``; ``w{j}`` for a bare ``DeviceMesh``), and the mesh's
first rank the meta once every rank's files are written; :func:`save`
streams every worker's leaves to the mesh's first rank, one worker's leaf
at a time, which writes the monolithic file, the reference's format byte
for byte; the asynchronous writer snapshots the rank's own workers. With a
model axis (model factor k > 1, ``param_specs`` required) each leaf that
the specs shard over it is first all-gathered over the model group, one
leaf at a time, and the group's model rank 0 writes (or sends) the
worker's whole leaves, in the meshless format: the files equal a meshless
save of the gathered tree. :func:`restore` cuts a checkpoint to the rank
(a sharded one: reading only its workers' files) and
:func:`consensus_from_sharded` lands w̄ as the rank's piece.
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
import io
import json
import mmap
import os
import threading
import time
import zipfile
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import _tree
from repro_torch.convert import resolve_device
from repro_torch.launch.mesh import WorkerMesh, report_group
from repro_torch.launch.tensor_parallel import model_cut, whole_leaves, whole_shape

PyTree = Any

__all__ = ["save", "restore", "consensus_params", "export_consensus", "latest_step",
           "worker_coords", "save_sharded", "restore_sharded",
           "consensus_from_sharded", "AsyncCheckpointWriter"]

# Suffix marking a bf16 leaf stored as its raw 16-bit pattern (numpy .npz
# cannot store bfloat16; a uint16 view keeps the exact bits).
_BF16_TAG = "::bf16"


def _path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    """{path key: numpy array} in leaf order; bf16 leaves as tagged uint16.

    A CUDA leaf is copied into pinned host memory without blocking, all of
    them on the current stream, which is then synchronized once: a pure DMA,
    where a pageable copy stages through the driver on the calling thread.
    """
    host, pending = [], set()
    for path, leaf in _tree.flatten_with_path(tree):
        t = torch.as_tensor(leaf).detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            t = h.copy_(t, non_blocking=True)
            pending.add(torch.cuda.current_stream(leaf.device))
        host.append((_path_key(path), t.cpu().contiguous()))
    for stream in pending:
        stream.synchronize()
    return {_stored_key(key, t.dtype): _host_array(t) for key, t in host}


def _stored_key(key: str, dtype: torch.dtype) -> str:
    return key + _BF16_TAG if dtype == torch.bfloat16 else key


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the array stored for it: bf16 as its uint16 bits."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _write_npz_members(path: str, members) -> None:
    """``np.savez``'s file (a stored zip of ``.npy`` members, ``.npz``
    appended when missing) from ``(name, shape, numpy dtype, chunks)``
    members, each member's data the concatenation of its ``chunks``
    (C-contiguous arrays, written from their buffers). The file is written
    beside ``path`` and renamed onto it, so a file already there is
    replaced whole and never rewritten in place: a reader of the old file
    (:func:`_load_npz`'s memory map) keeps its bytes."""
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for name, shape, dtype, chunks in members:
                with zf.open(name + ".npy", "w", force_zip64=True) as f:
                    np.lib.format.write_array_header_1_0(f, {
                        "descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
                        "fortran_order": False, "shape": tuple(shape)})
                    for chunk in chunks:
                        f.write(np.ascontiguousarray(chunk).reshape(-1).view(np.uint8).data)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _write_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``'s file, each array written from its own
    buffer in one call. np.savez copies every array through Python in
    16 MiB chunks with the GIL held, which stalls a training loop's kernel
    launches on another thread; a buffer write and the zip's CRC release
    it."""
    _write_npz_members(path, ((name, arr.shape, arr.dtype, [arr])
                              for name, arr in arrays.items()))


def _load_npz(path: str) -> dict[str, np.ndarray]:
    """Every array of an npz by member name, as ``np.load`` gives them and
    with the zip's CRC-32 of each member checked as ``np.load`` checks it,
    but read from one copy-on-write memory map of the file: a member is a
    view of its pages, which are read once for the check and once more
    where :func:`_stored_tensor` copies the leaf out, with no copy on the
    host in between. Members are stored, as ``np.savez`` and
    :func:`_write_npz` write them; a compressed one is refused."""
    fmt = np.lib.format
    out: dict[str, np.ndarray] = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        infos = zf.infolist()
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if infos else None
        for info in infos:
            if info.compress_type != zipfile.ZIP_STORED:
                raise ValueError(f"{path}: {info.filename} is compressed; checkpoints "
                                 "store their members (np.savez)")
            # the local header: 30 bytes, then the name and the extra field
            head = mm[info.header_offset:info.header_offset + 30]
            start = info.header_offset + 30 + int.from_bytes(head[26:28], "little") \
                + int.from_bytes(head[28:30], "little")
            with memoryview(mm)[start:start + info.compress_size] as member:
                if zlib.crc32(member) != info.CRC:
                    raise zipfile.BadZipFile(f"{path}: bad CRC-32 for {info.filename}")
                npy = io.BytesIO(member[:1 << 17].tobytes())
            read = (fmt.read_array_header_1_0 if fmt.read_magic(npy) == (1, 0)
                    else fmt.read_array_header_2_0)
            shape, fortran, dtype = read(npy)
            n = int(np.prod(shape, dtype=np.int64))
            arr = np.frombuffer(mm, dtype=dtype, count=n, offset=start + npy.tell())
            out[info.filename[:-len(".npy")]] = arr.reshape(shape, order="F" if fortran else "C")
    return out


def _base_key(stored: str) -> str:
    return stored[:-len(_BF16_TAG)] if stored.endswith(_BF16_TAG) else stored


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _is_sharded(path: str) -> bool:
    """No monolithic file at ``path`` but a sharded ``.meta.json``."""
    return not os.path.exists(_npz_path(path)) and _sharded_meta(path) is not None


def _stored_tensor(raw: np.ndarray, stored: str, device: torch.device) -> torch.Tensor:
    """A stored array as a tensor on ``device``, tagged leaves as bf16, in
    memory of its own (on the CPU too: ``raw`` may be a view of
    :func:`_load_npz`'s map)."""
    if stored.endswith(_BF16_TAG):
        bits = np.ascontiguousarray(raw).view(np.int16)
        return torch.from_numpy(bits).to(device, copy=True).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device, copy=True)


def save(path: str, tree: PyTree, step: int | None = None, *, wmesh=None,
         param_specs: PyTree | None = None) -> None:
    """Write ``tree`` as one npz (and the step's ``.meta.json``). With a live
    ``wmesh`` (a WorkerMesh or its DeviceMesh) ``tree`` is this rank's
    workers' part of a worker-stacked tree, cut by ``param_specs`` over a
    model axis of k > 1, and every rank calls this: the mesh's first rank
    writes the whole file, each leaf's workers in order, receiving each
    other worker group's workers one leaf at a time
    (:func:`_stream_to_first_rank`), so neither host nor device holds more
    than one (gathered) leaf beyond the rank's own tree."""
    if wmesh is not None:
        wm = _live_mesh(wmesh)
        return _stream_to_first_rank(path, tree, step, wm, _cut(tree, param_specs, wm))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_npz(path, _flatten_with_paths(tree))
    _write_step(path, step)


def _write_step(path: str, step: int | None) -> None:
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": int(step)}, f)


def _live_mesh(wmesh):
    """The live WorkerMesh of ``wmesh``."""
    wm = WorkerMesh.ensure(wmesh)
    wm._require_live()
    return wm


def _cut(tree: PyTree, param_specs: PyTree | None, wm):
    """The ``launch.tensor_parallel.ModelCut`` of the rank's ``tree`` (None
    at model factor 1); a model axis needs the ``param_specs``."""
    if wm.model_factor > 1 and param_specs is None:
        raise ValueError(f"a save over {wm.describe()} needs the param_specs that cut "
                         "each replica over the model axis")
    return model_cut(param_specs, _tree.flatten(tree)[1], wm)


def _rank_workers(wm, m: int) -> range:
    """The global indices of the ``m`` workers this rank holds."""
    return range(wm.worker_index * m, (wm.worker_index + 1) * m)


def _stream_to_first_rank(path: str, tree: PyTree, step: int | None, wm, cut) -> None:
    """:func:`save` over a mesh: per leaf, gathered whole over the model
    group (``cut``, k > 1), worker by worker, each worker's slice sent by
    the model rank 0 of the worker group holding it (``dist.send``) to the
    mesh's first rank, which copies it to the host and appends it to the
    leaf's member."""
    paths = [p for p, _ in _tree.flatten_with_path(tree)]
    whole = whole_leaves(_tree.leaves(tree), cut)
    m = int(_tree.leaves(tree)[0].shape[0])
    M = m * wm.n_workers
    first, me = wm.rank_of(0), dist.get_rank()
    if me != first:
        for x in whole:
            if wm.model_index == 0:
                for i in range(m):
                    dist.send(x[i].contiguous(), dst=first)
        return
    mine = _rank_workers(wm, m)

    def slices(x):
        buf = torch.empty_like(x[0])
        for j in range(M):
            if j in mine:
                yield _host_array(x[j - mine.start].cpu())
            else:
                dist.recv(buf, src=wm.rank_of(j // m))
                yield _host_array(buf.cpu())

    def members():
        for p, x in zip(paths, whole):
            dtype = _host_array(torch.empty((0,), dtype=x.dtype)).dtype
            yield (_stored_key(_path_key(p), x.dtype), (M,) + tuple(x.shape[1:]), dtype,
                   slices(x))

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_npz_members(path, members())
    _write_step(path, step)


def _check_keys(path: str, stored_by_key: dict, paths: list) -> None:
    like_keys = {_path_key(p) for p, _ in paths}
    if set(stored_by_key) != like_keys:
        raise ValueError(f"{path}: stored leaves differ from the template's: "
                         f"{sorted(set(stored_by_key) ^ like_keys)[:5]}")


def _check_shape(path: str, key: str, t, leaf) -> None:
    if tuple(t.shape) != tuple(leaf.shape):
        raise ValueError(f"{path}: {key} has shape {tuple(t.shape)}, want "
                         f"{tuple(leaf.shape)}")


def restore(path: str, like: PyTree, device: str | torch.device = "cuda", *,
            wmesh=None, param_specs: PyTree | None = None) -> PyTree:
    """Restore into the structure of ``like`` (shapes and dtypes kept).

    A leaf may be stored tagged (bf16 bits) or plain, whatever the dtype of
    ``like``: only the set of leaves must match. ``like``'s leaves need only
    ``.shape`` and ``.dtype``, so tensors on the ``meta`` device will do. A
    worker-sharded checkpoint (:func:`save_sharded`) is found by its meta
    and reassembled by :func:`restore_sharded`.

    With a live ``wmesh`` (a WorkerMesh or its DeviceMesh) ``like`` is the
    global worker-stacked template and this rank's part comes back, cut by
    ``param_specs`` (default: the worker dim over the worker axes) as
    ``launch.shardings.local_tree`` cuts: of a sharded checkpoint the rank
    reads only its own workers' files.
    """
    if wmesh is not None:
        return _restore_on_mesh(path, like, resolve_device(device), wmesh, param_specs)
    if _is_sharded(path):
        return restore_sharded(path, like, device)
    dev = resolve_device(device)
    data = _load_npz(_npz_path(path))
    stored_by_key = {_base_key(f): f for f in data}
    paths = _tree.flatten_with_path(like)
    _check_keys(path, stored_by_key, paths)
    out = []
    for p, leaf in paths:
        key = _path_key(p)
        t = _stored_tensor(data[stored_by_key[key]], stored_by_key[key], dev).to(leaf.dtype)
        _check_shape(path, key, t, leaf)
        out.append(t)
    return _tree.unflatten(_tree.flatten(like)[1], out)


def _restore_on_mesh(path: str, like: PyTree, dev: torch.device, wmesh,
                     param_specs: PyTree | None) -> PyTree:
    """:func:`restore` with ``wmesh``: the rank's cut of the checkpoint."""
    from repro_torch.launch.shardings import local_tree
    from repro_torch.models.params import PartitionSpec

    wm = WorkerMesh.ensure(wmesh)
    paths = _tree.flatten_with_path(like)
    treedef = _tree.flatten(like)[1]
    specs = (_tree.flatten_up_to(treedef, param_specs) if param_specs is not None
             else [wm.worker_spec()] * len(paths))
    if not _is_sharded(path):
        full = restore(path, like, device=dev)
        return local_tree(full, _tree.unflatten(treedef, specs), wm)
    _, files, _ = _shard_files(path)
    m = len(files) // wm.n_workers
    if m * wm.n_workers != len(files):
        raise ValueError(f"{path}: {len(files)} worker shards do not split over "
                         f"{wm.describe()}")
    mine = [files[j] for j in _rank_workers(wm, m)]
    like_mine = _tree.map(lambda x: torch.empty((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                                                device="meta"), like)
    stacked = _restore_stacked(path, mine, like_mine, dev)
    rest = [PartitionSpec(None, *tuple(s)[1:]) for s in specs]
    return local_tree(stacked, _tree.unflatten(treedef, rest), wm)


# ---------------------------------------------------------------------------
# Worker-sharded checkpoints: one worker's replica on the host at a time
# ---------------------------------------------------------------------------


def _strip_npz(path: str) -> str:
    return path[:-len(".npz")] if path.endswith(".npz") else path


def worker_coords(wmesh, M: int) -> list[str]:
    """Shard keys in worker-index order: the WorkerMesh coordinates along
    the worker axes (row-major, e.g. ``'pod1-data3'`` on a pod×data mesh),
    or plain ``'w{j}'`` when no mesh is given (meshless stacked state)."""
    if wmesh is None:
        return [f"w{j}" for j in range(M)]
    axes = list(wmesh.worker_axes)
    sizes = [int(wmesh.shape[a]) for a in axes]
    if int(np.prod(sizes)) != M:
        raise ValueError(f"mesh hosts {int(np.prod(sizes))} workers, "
                         f"tree is stacked over {M}")
    out = []
    for j in range(M):
        rem, parts = j, []
        for a, s in zip(reversed(axes), reversed(sizes)):
            parts.append(f"{a}{rem % s}")
            rem //= s
        out.append("-".join(reversed(parts)))
    return out


def save_sharded(path: str, tree: PyTree, step: int | None = None, *,
                 wmesh=None, param_specs: PyTree | None = None) -> None:
    """Write one npz per worker (``{base}.shard-{coord}.npz``, keys from
    :func:`worker_coords`) and a ``{base}.meta.json`` listing the shards:
    each worker's slice is copied to the host and written on its own, so at
    most one replica is resident there at a time. A monolithic checkpoint
    at the same base is removed, so :func:`restore` cannot prefer the older
    file.

    ``wmesh``: a WorkerMesh names the shards by its coordinates. On a live
    mesh (a WorkerMesh, or a bare DeviceMesh, whose shards keep the
    ``w{j}`` names as the reference's train loop gives a raw mesh) ``tree``
    is this rank's workers' part and every rank calls this: each writes its
    own workers' files, then the ranks report them written to each other
    (``launch.mesh.report_group``), and only then does the mesh's first rank write
    the meta, so a meta never lists a shard that is not yet on disk. Over a
    model axis (k > 1) ``tree`` is cut by ``param_specs``: the worker
    group's model rank 0 writes its workers' files from the leaves gathered
    over the group, the other model ranks none."""
    wm = WorkerMesh.ensure(wmesh)
    if wm is not None and wm.live:
        cut = _cut(tree, param_specs, _live_mesh(wm))
        if cut is not None:
            leaves, treedef = _tree.flatten(tree)
            whole = list(whole_leaves(leaves, cut))
            tree = _tree.unflatten(treedef, whole) if wm.model_index == 0 else None
    for write, _ in _sharded_writes(path, tree, step, wmesh):
        write()


def _sharded_writes(path: str, tree: PyTree, step: int | None, wmesh) -> list:
    """:func:`save_sharded`'s writes in order, as ``(write, retry)``: this
    process's shard files; on a live mesh of several ranks the report that
    they are on disk (``retry`` False: every rank makes it exactly once per
    save); then, on the first rank, the meta and the stale files' removal.
    The report's group is made here, on the calling thread. ``tree`` is
    None on a model rank that writes no shard (past the first of its
    worker group): it only reports."""
    wm = WorkerMesh.ensure(wmesh)
    if tree is None:
        group = report_group(_live_mesh(wm).mesh)
        return [(lambda: dist.barrier(group=group), False)]
    leaves = _tree.leaves(tree)
    if not leaves:
        raise ValueError("cannot shard an empty tree")
    m = int(leaves[0].shape[0])
    if any(tuple(x.shape[:1]) != (m,) for x in leaves):
        raise ValueError("sharded save needs a stacked tree (leading M dim)")
    named = wmesh if isinstance(wmesh, WorkerMesh) else None
    M, mine, writes_meta, group = m, range(m), True, None
    if wm is not None and wm.live:
        wm = _live_mesh(wm)
        M, mine = m * wm.n_workers, _rank_workers(wm, m)
        writes_meta = dist.get_rank() == wm.rank_of(0)
        group = report_group(wm.mesh)
    base = _strip_npz(path)
    coords = worker_coords(named, M)

    def shards():
        os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
        for i, j in enumerate(mine):
            slice_j = _tree.map(lambda x: x[i], tree)
            _write_npz(f"{base}.shard-{coords[j]}.npz", _flatten_with_paths(slice_j))

    def meta():
        d: dict[str, Any] = {"sharded": {"shards": coords}}
        if step is not None:
            d["step"] = int(step)
        with open(base + ".meta.json", "w") as f:
            json.dump(d, f)
        for stale in (base + ".npz", base + ".npz.meta.json"):
            if os.path.exists(stale):
                os.remove(stale)

    writes = [(shards, True)]
    if group is not None:
        writes.append((lambda: dist.barrier(group=group), False))
    if writes_meta:
        writes.append((meta, True))
    return writes


def _sharded_meta(path: str) -> dict | None:
    meta = _strip_npz(path) + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            d = json.load(f)
        if "sharded" in d:
            return d
    return None


def _shard_files(path: str) -> tuple[str, list[str], dict]:
    base = _strip_npz(path)
    meta = _sharded_meta(path)
    if meta is None:
        raise FileNotFoundError(f"{base}.meta.json has no shard list")
    return base, [f"{base}.shard-{c}.npz" for c in meta["sharded"]["shards"]], meta


def restore_sharded(path: str, like: PyTree,
                    device: str | torch.device = "cuda") -> PyTree:
    """Reassemble a :func:`save_sharded` checkpoint into ``like``'s
    structure (a stacked tree with leading M dim; ``meta`` tensors will do)
    by stacking the per-worker bit patterns in shard order: bit-exact, bf16
    tags included."""
    _, files, _ = _shard_files(path)
    return _restore_stacked(path, files, like, resolve_device(device))


def _restore_stacked(path: str, files: list[str], like: PyTree, dev: torch.device) -> PyTree:
    """The shard ``files``' trees stacked on a leading dim, in their order."""
    shards = [_load_npz(f) for f in files]
    stored_by_key = {_base_key(f): f for f in shards[0]}
    paths = _tree.flatten_with_path(like)
    _check_keys(path, stored_by_key, paths)
    out = []
    for p, leaf in paths:
        key = _path_key(p)
        stored = stored_by_key[key]
        raw = np.stack([s[stored] for s in shards])
        t = _stored_tensor(raw, stored, dev).to(leaf.dtype)
        _check_shape(path, key, t, leaf)
        out.append(t)
    return _tree.unflatten(_tree.flatten(like)[1], out)


def consensus_from_sharded(path: str, like: PyTree,
                           device: str | torch.device = "cuda", *,
                           shardings: tuple[PyTree, Any] | None = None) -> PyTree:
    """w̄ = (1/M) Σ_j w_j straight from a worker-sharded checkpoint, with at
    most one worker replica on the host at a time.

    ``like`` is the single-replica template. Each shard's leaves go to
    ``device`` as float32 and add into a running sum in shard order; the sum
    is divided by float32(M) once at the end, a true division as in the
    reference (not :func:`consensus_params`' product with fl32(1/M); the two
    agree when M is a power of two), then cast back to ``like``'s dtypes.

    ``shardings=(param_specs, mesh)`` (a live WorkerMesh or DeviceMesh, any
    model factor) lands w̄ as this rank's piece of it: each shard's leaves
    are cut by ``param_specs`` (``launch.shardings.local_tree``) as they
    arrive."""
    dev = resolve_device(device)
    _, files, _ = _shard_files(path)
    paths = _tree.flatten_with_path(like)
    cut = lambda xs: xs
    if shardings is not None:
        from repro_torch.launch.shardings import local_tree

        specs, wm = shardings[0], WorkerMesh.ensure(shardings[1])
        spec_leaves = _tree.flatten_up_to(_tree.flatten(like)[1], specs)
        cut = lambda xs: _tree.leaves(local_tree(xs, spec_leaves, wm))
    acc: list | None = None
    stored_by_key: dict[str, str] | None = None
    for f in files:
        z = _load_npz(f)
        if stored_by_key is None:
            stored_by_key = {_base_key(s): s for s in z}
            _check_keys(path, stored_by_key, paths)
        cur = []
        for p, leaf in paths:
            key = _path_key(p)
            stored = stored_by_key[key]
            t = _stored_tensor(z[stored], stored, dev)
            _check_shape(path, key, t, leaf)
            cur.append(t)
        del z
        cur = [t.float() for t in cut(cur)]
        acc = cur if acc is None else [a.add_(b) for a, b in zip(acc, cur)]
    Mw = torch.full((), float(len(files)), dtype=torch.float32, device=dev)
    out = [(a / Mw).to(leaf.dtype) for a, (_, leaf) in zip(acc, paths)]
    return _tree.unflatten(_tree.flatten(like)[1], out)


class AsyncCheckpointWriter:
    """Background checkpoint writer: snapshot on call, the npz write off-thread.

    ``save()`` snapshots the tree into pinned host memory and returns
    without waiting on the device: that stall is what the writer exists to
    avoid. Each CUDA leaf is copied without blocking on the caller's
    current stream, so the copy comes after the step that produced the
    params and before whatever the caller launches next, an in-place update
    of the params included: the stream spends the copy's time at the host
    link's rate, and no device memory, so a save in flight does not raise
    the device peak. A single background thread waits on an event behind
    the copies, then writes. A tree on the CPU is cloned.

    The pinned buffers return to the writer after each write and serve the
    next snapshot of the same shapes. :meth:`_reserve` pins them ahead, on
    the writer's thread (``train()`` calls it before its first step), so
    the first saves do not pin memory on the caller's.

    At most ``max_pending`` snapshots are in flight; a further ``save()``
    first waits on the oldest (bounded snapshot memory). ``wait()`` drains
    the queue and re-raises any writer-thread exception.

    ``OSError``s are retried up to ``io_retries`` times with exponential
    backoff from ``io_backoff`` seconds, each write of a sharded save on
    its own (the ranks' report that their shards are written is made once).
    A write that exhausts its retries puts the writer in terminal failure:
    the next ``save()`` raises (as do ``wait()``/``close()``), so training
    cannot run on while every checkpoint is lost. ``sharded=True`` (or a
    ``wmesh``, as in the reference) writes through :func:`save_sharded`; on
    a live mesh (``wmesh``) the tree is the rank's own workers', and over a
    model axis (k > 1) it is cut by ``param_specs``: ``save()`` gathers each
    sharded leaf over the model group on the caller's thread, one leaf at a
    time, and the group's model rank 0 snapshots the whole leaves (the
    other model ranks snapshot nothing and only report).
    ``write_seconds`` holds each finished write's time on the thread.
    """

    def __init__(self, max_pending: int = 2, *, io_retries: int = 3,
                 io_backoff: float = 0.05):
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ckpt-writer")
        self._pending: collections.deque = collections.deque()
        self._max_pending = max(1, max_pending)
        self._io_retries = max(1, int(io_retries))
        self._io_backoff = io_backoff
        self._terminal: BaseException | None = None
        # pinned host buffers free for a snapshot, by leaf shapes and dtypes
        # (appended on the writer's thread, taken by save()), and the
        # reservations still pinning them
        self._pinned: dict = collections.defaultdict(list)
        self._reserving: dict = {}
        self.write_seconds: list[float] = []

    @staticmethod
    def _cuda_device(leaves):
        cuda = {x.device for x in leaves if torch.is_tensor(x) and x.device.type == "cuda"}
        if len(cuda) > 1:
            raise ValueError(f"a snapshot spans several devices: {sorted(map(str, cuda))}")
        return cuda.pop() if cuda else None

    @staticmethod
    def _key(leaves, cut) -> tuple:
        """The snapshot's leaf shapes and dtypes: whole over a model axis."""
        dims = cut.dims if cut is not None else ((),) * len(leaves)
        k = cut.k if cut is not None else 1
        return tuple((whole_shape(tuple(x.shape), d, k), x.dtype) for x, d in zip(leaves, dims))

    def _reserve(self, tree: PyTree, cut=None) -> None:
        """Pin ``max_pending`` snapshots' host buffers for trees of
        ``tree``'s shapes and dtypes (whole over ``cut``'s model axis), on
        the writer's thread (nothing for a tree on the CPU, or on a model
        rank that snapshots nothing)."""
        leaves = _tree.leaves(tree)
        if self._cuda_device(leaves) is None or (cut is not None and cut.index):
            return
        key = self._key(leaves, cut)
        free = self._pinned[key]

        def pin():
            for _ in range(self._max_pending):
                free.append([torch.empty(shape, dtype=dtype, pin_memory=True)
                             for shape, dtype in key])

        self._reserving[key] = self._pool.submit(pin)

    def _snapshot(self, tree: PyTree, cut=None):
        """(snapshot, event behind its copies or None, release) of ``tree``,
        its leaves gathered whole over ``cut``'s model axis (class
        docstring); a snapshot of None on a model rank past the first."""
        leaves, treedef = _tree.flatten(tree)
        dev = self._cuda_device(leaves)
        key = self._key(leaves, cut)
        if cut is not None:
            leaves = whole_leaves(leaves, cut)
            if cut.index:
                for _ in leaves:    # the gather's other ends
                    pass
                return None, None, None
        if dev is None:
            return _tree.unflatten(treedef, [
                x.detach().clone() if torch.is_tensor(x) else x for x in leaves]), None, None
        free = self._pinned[key]
        if not free and key in self._reserving:
            self._reserving.pop(key).result()
        bufs = free.pop() if free else [torch.empty(shape, dtype=dtype, pin_memory=True)
                                        for shape, dtype in key]
        for b, x in zip(bufs, leaves):
            b.copy_(x, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
        return _tree.unflatten(treedef, bufs), done, lambda: free.append(bufs)

    def _write(self, done, writes, release):
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        for fn, retry in writes:
            delay = self._io_backoff
            for attempt in range(self._io_retries if retry else 1):
                try:
                    fn()
                    break
                except OSError as e:
                    if attempt == self._io_retries - 1 or not retry:
                        self._terminal = e
                        raise
                    time.sleep(delay)
                    delay *= 2
        self.write_seconds.append(time.perf_counter() - t0)
        if release is not None:
            release()

    def save(self, path: str, tree: PyTree, step: int | None = None, *,
             wmesh=None, sharded: bool = False, param_specs: PyTree | None = None) -> None:
        if self._terminal is not None:
            raise RuntimeError(
                f"checkpoint writer failed terminally after "
                f"{self._io_retries} attempts: {self._terminal}"
            ) from self._terminal
        cut = None
        if wmesh is not None and WorkerMesh.ensure(wmesh).live:
            cut = _cut(tree, param_specs, _live_mesh(wmesh))    # before any snapshot
        while len(self._pending) >= self._max_pending:
            self._pending.popleft().result()
        snap, done, release = self._snapshot(tree, cut)
        if sharded or wmesh is not None:
            # the ranks' report group is made here, on the caller's thread
            writes = _sharded_writes(path, snap, step, wmesh)
        else:
            writes = [(functools.partial(save, path, snap, step), True)]
        self._pending.append(self._pool.submit(self._write, done, writes, release))

    def wait(self) -> None:
        while self._pending:
            self._pending.popleft().result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self) -> "AsyncCheckpointWriter":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def consensus_params(params_M: PyTree) -> PyTree:
    """Average the leading worker dim away: one serving replica.

    A gossip-trained tree stacks every worker's w_j on a leading M dim; the
    paper's output model is w̄ = (1/M) Σ_j w_j. The sum happens in float32
    and the result is cast back, so a bf16 tree loses nothing beyond the
    final cast. The sum is multiplied by fl32(1/M), not divided by M: that
    is what XLA compiles the reference's ``jnp.mean`` into (a true division
    is one ulp off it for some values when M is not a power of two)."""
    return _tree.map(lambda x: (x.float().sum(0) * float(np.float32(1.0 / x.shape[0])))
                     .to(x.dtype), params_M)


def export_consensus(src: str | PyTree, dst: str | None = None,
                     step: int | None = None,
                     device: str | torch.device = "cuda") -> PyTree:
    """Collapse a gossip checkpoint (leading worker dim) to a serving one.

    ``src`` is a checkpoint path (monolithic or worker-sharded), loaded as
    stored onto ``device``, or an in-memory worker-stacked tree. The averaged tree is returned and, when
    ``dst`` is given, saved as a normal checkpoint that
    ``serving.engine.load_consensus_params`` (or :func:`restore`) reads."""
    if isinstance(src, str) and _is_sharded(src):
        # stack the per-shard bit patterns in shard order (the
        # restore_sharded inverse), then average as for a monolithic file
        dev = resolve_device(device)
        _, files, meta = _shard_files(src)
        shards = [_load_npz(f) for f in files]
        tree = _unflatten_keys({
            _base_key(f): _stored_tensor(np.stack([s[f] for s in shards]), f, dev)
            for f in shards[0]})
        if step is None:
            step = meta.get("step")
    elif isinstance(src, str):
        dev = resolve_device(device)
        path = _npz_path(src)
        data = _load_npz(path)
        tree = _unflatten_keys({_base_key(f): _stored_tensor(data[f], f, dev)
                                for f in data})
        if step is None:
            # save() keys the .meta.json on the caller's spelling, which may
            # or may not include the .npz suffix: probe both
            step = latest_step(path)
            if step is None and path != src:
                step = latest_step(src)
    else:
        tree = src
    mean = consensus_params(tree)
    if dst is not None:
        save(dst, mean, step=step)
    return mean


def _unflatten_keys(flat: dict[str, Any]) -> PyTree:
    """'a/b/0' keyed dict → nested dict tree (lists stay string-keyed dicts:
    averaging and re-saving need only the leaves and stable keys)."""
    out: dict[str, Any] = {}
    for key, leaf in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def latest_step(path: str) -> int | None:
    meta = path + ".meta.json"
    if os.path.exists(meta):
        with open(meta) as f:
            return json.load(f).get("step")
    return None
