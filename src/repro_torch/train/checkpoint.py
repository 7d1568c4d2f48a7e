"""Parameter-tree checkpoints in the reference's npz format.

The port of the reference's ``repro/train/checkpoint.py``, meshless: one
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
casting back. :class:`AsyncCheckpointWriter` moves the device-to-host copy
and the disk write off the training loop's thread.

The reference's ``WorkerMesh`` shard coordinates come with the mesh's
checkpoints (ROADMAP queue 1, item 3, step 5).
"""
from __future__ import annotations

import collections
import concurrent.futures
import json
import os
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device

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
    flat = {}
    for key, t in host:
        if t.dtype == torch.bfloat16:
            key, arr = key + _BF16_TAG, t.view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        flat[key] = arr
    return flat


def _write_npz(path: str, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez(path, **arrays)``'s file (a stored zip of ``.npy``
    members, ``.npz`` appended when missing), each array written from its
    own buffer in one call. np.savez copies every array through Python in
    16 MiB chunks with the GIL held, which stalls a training loop's kernel
    launches on another thread; a buffer write and the zip's CRC release
    it."""
    if not path.endswith(".npz"):
        path += ".npz"
    with zipfile.ZipFile(path, "w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, arr in arrays.items():
            arr = np.ascontiguousarray(arr)
            with zf.open(name + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(
                    f, np.lib.format.header_data_from_array_1_0(arr))
                f.write(arr.reshape(-1).view(np.uint8).data)


def _base_key(stored: str) -> str:
    return stored[:-len(_BF16_TAG)] if stored.endswith(_BF16_TAG) else stored


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _is_sharded(path: str) -> bool:
    """No monolithic file at ``path`` but a sharded ``.meta.json``."""
    return not os.path.exists(_npz_path(path)) and _sharded_meta(path) is not None


def _stored_tensor(raw: np.ndarray, stored: str, device: torch.device) -> torch.Tensor:
    """A stored array as a tensor on ``device``, tagged leaves as bf16."""
    if stored.endswith(_BF16_TAG):
        bits = np.ascontiguousarray(raw).view(np.int16)
        return torch.from_numpy(bits).to(device).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device)


def save(path: str, tree: PyTree, step: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    _write_npz(path, _flatten_with_paths(tree))
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": int(step)}, f)


def _check_keys(path: str, stored_by_key: dict, paths: list) -> None:
    like_keys = {_path_key(p) for p, _ in paths}
    if set(stored_by_key) != like_keys:
        raise ValueError(f"{path}: stored leaves differ from the template's: "
                         f"{sorted(set(stored_by_key) ^ like_keys)[:5]}")


def _check_shape(path: str, key: str, t, leaf) -> None:
    if tuple(t.shape) != tuple(leaf.shape):
        raise ValueError(f"{path}: {key} has shape {tuple(t.shape)}, want "
                         f"{tuple(leaf.shape)}")


def restore(path: str, like: PyTree, device: str | torch.device = "cuda") -> PyTree:
    """Restore into the structure of ``like`` (shapes and dtypes kept).

    A leaf may be stored tagged (bf16 bits) or plain, whatever the dtype of
    ``like``: only the set of leaves must match. ``like``'s leaves need only
    ``.shape`` and ``.dtype``, so tensors on the ``meta`` device will do. A
    worker-sharded checkpoint (:func:`save_sharded`) is found by its meta
    and reassembled by :func:`restore_sharded`.
    """
    if _is_sharded(path):
        return restore_sharded(path, like, device)
    dev = resolve_device(device)
    data = np.load(_npz_path(path))
    stored_by_key = {_base_key(f): f for f in data.files}
    paths = _tree.flatten_with_path(like)
    _check_keys(path, stored_by_key, paths)
    out = []
    for p, leaf in paths:
        key = _path_key(p)
        t = _stored_tensor(data[stored_by_key[key]], stored_by_key[key], dev).to(leaf.dtype)
        _check_shape(path, key, t, leaf)
        out.append(t)
    return _tree.unflatten(_tree.flatten(like)[1], out)


# ---------------------------------------------------------------------------
# Worker-sharded checkpoints: one worker's replica on the host at a time
# ---------------------------------------------------------------------------


_NO_MESH = ("WorkerMesh shard coordinates come with the mesh's checkpoints "
            "(ROADMAP queue 1, item 3, step 5)")


def _strip_npz(path: str) -> str:
    return path[:-len(".npz")] if path.endswith(".npz") else path


def worker_coords(wmesh, M: int) -> list[str]:
    """Shard keys in worker-index order: ``'w{j}'`` for meshless stacked
    state (the reference's names with no mesh)."""
    if wmesh is not None:
        raise NotImplementedError(_NO_MESH)
    return [f"w{j}" for j in range(M)]


def save_sharded(path: str, tree: PyTree, step: int | None = None, *,
                 wmesh=None) -> None:
    """Write one npz per worker (``{base}.shard-w{j}.npz``) and a
    ``{base}.meta.json`` listing the shards: each worker's slice is copied
    to the host and written on its own, so at most one replica is resident
    there at a time. A monolithic checkpoint at the same base is removed, so
    :func:`restore` cannot prefer the older file."""
    leaves = _tree.leaves(tree)
    if not leaves:
        raise ValueError("cannot shard an empty tree")
    M = int(leaves[0].shape[0])
    if any(tuple(x.shape[:1]) != (M,) for x in leaves):
        raise ValueError("sharded save needs a stacked tree (leading M dim)")
    base = _strip_npz(path)
    os.makedirs(os.path.dirname(base) or ".", exist_ok=True)
    coords = worker_coords(wmesh, M)
    for j, coord in enumerate(coords):
        slice_j = _tree.map(lambda x: x[j], tree)
        _write_npz(f"{base}.shard-{coord}.npz", _flatten_with_paths(slice_j))
    meta: dict[str, Any] = {"sharded": {"shards": coords}}
    if step is not None:
        meta["step"] = int(step)
    with open(base + ".meta.json", "w") as f:
        json.dump(meta, f)
    for stale in (base + ".npz", base + ".npz.meta.json"):
        if os.path.exists(stale):
            os.remove(stale)


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
    dev = resolve_device(device)
    _, files, _ = _shard_files(path)
    shards = [np.load(f) for f in files]
    stored_by_key = {_base_key(f): f for f in shards[0].files}
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
                           device: str | torch.device = "cuda") -> PyTree:
    """w̄ = (1/M) Σ_j w_j straight from a worker-sharded checkpoint, with at
    most one worker replica on the host at a time.

    ``like`` is the single-replica template. Each shard's leaves go to
    ``device`` as float32 and add into a running sum in shard order; the sum
    is divided by float32(M) once at the end, a true division as in the
    reference (not :func:`consensus_params`' product with fl32(1/M); the two
    agree when M is a power of two), then cast back to ``like``'s dtypes."""
    dev = resolve_device(device)
    _, files, _ = _shard_files(path)
    paths = _tree.flatten_with_path(like)
    acc: list | None = None
    stored_by_key: dict[str, str] | None = None
    for f in files:
        with np.load(f) as z:
            if stored_by_key is None:
                stored_by_key = {_base_key(s): s for s in z.files}
                _check_keys(path, stored_by_key, paths)
            cur = []
            for p, leaf in paths:
                key = _path_key(p)
                stored = stored_by_key[key]
                t = _stored_tensor(z[stored], stored, dev)
                _check_shape(path, key, t, leaf)
                cur.append(t.float())
        acc = cur if acc is None else [a.add_(b) for a, b in zip(acc, cur)]
    Mw = torch.full((), float(len(files)), dtype=torch.float32, device=dev)
    out = [(a / Mw).to(leaf.dtype) for a, (_, leaf) in zip(acc, paths)]
    return _tree.unflatten(_tree.flatten(like)[1], out)


class AsyncCheckpointWriter:
    """Background checkpoint writer: snapshot on call, the npz write off-thread.

    ``save()`` clones every leaf on the caller's current CUDA stream, so the
    snapshot is ordered after the step that produced the params and is safe
    from whatever the loop does to them afterwards, and records an event
    behind the clones. It never waits on the device: that stall is what the
    writer exists to avoid. A single background thread makes its
    device-to-host copies (into pinned memory, :func:`_flatten_with_paths`)
    on a side stream that first waits on that event,
    so they start only once the clones have finished and do not queue behind
    (or hold up) the steps the loop launches meanwhile; then it writes.

    At most ``max_pending`` snapshots are in flight; a further ``save()``
    first waits on the oldest (bounded snapshot memory). ``wait()`` drains
    the queue and re-raises any writer-thread exception.

    ``OSError``s are retried up to ``io_retries`` times with exponential
    backoff from ``io_backoff`` seconds. A write that exhausts its retries
    puts the writer in terminal failure: the next ``save()`` raises (as do
    ``wait()``/``close()``), so training cannot run on while every
    checkpoint is lost. ``sharded=True`` writes through :func:`save_sharded`.
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
        self._streams: dict = {}
        self.write_seconds: list[float] = []

    def _write(self, ready, fn, *args):
        t0 = time.perf_counter()
        delay = self._io_backoff
        for attempt in range(self._io_retries):
            try:
                if ready is None:
                    fn(*args)
                else:
                    event, stream = ready
                    with torch.cuda.stream(stream):
                        stream.wait_event(event)
                        fn(*args)
                self.write_seconds.append(time.perf_counter() - t0)
                return
            except OSError as e:
                if attempt == self._io_retries - 1:
                    self._terminal = e
                    raise
                time.sleep(delay)
                delay *= 2

    def save(self, path: str, tree: PyTree, step: int | None = None, *,
             wmesh=None, sharded: bool = False) -> None:
        if self._terminal is not None:
            raise RuntimeError(
                f"checkpoint writer failed terminally after "
                f"{self._io_retries} attempts: {self._terminal}"
            ) from self._terminal
        if wmesh is not None:
            raise NotImplementedError(_NO_MESH)
        snap = _tree.map(lambda x: x.detach().clone() if torch.is_tensor(x) else x,
                         tree)
        cuda = {x.device for x in _tree.leaves(snap)
                if torch.is_tensor(x) and x.device.type == "cuda"}
        if len(cuda) > 1:
            raise ValueError(f"a snapshot spans several devices: {sorted(map(str, cuda))}")
        ready = None
        if cuda:
            dev = cuda.pop()
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            if dev not in self._streams:
                self._streams[dev] = torch.cuda.Stream(dev)
            ready = (event, self._streams[dev])
        while len(self._pending) >= self._max_pending:
            self._pending.popleft().result()
        fn = save_sharded if sharded else save
        self._pending.append(self._pool.submit(self._write, ready, fn, path, snap, step))

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
        shards = [np.load(f) for f in files]
        tree = _unflatten_keys({
            _base_key(f): _stored_tensor(np.stack([s[f] for s in shards]), f, dev)
            for f in shards[0].files})
        if step is None:
            step = meta.get("step")
    elif isinstance(src, str):
        dev = resolve_device(device)
        path = _npz_path(src)
        data = np.load(path)
        tree = _unflatten_keys({_base_key(f): _stored_tensor(data[f], f, dev)
                                for f in data.files})
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
