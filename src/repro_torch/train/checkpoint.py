"""Parameter-tree checkpoints in the reference's npz format.

The port of the monolithic part of the reference's
``repro/train/checkpoint.py``: one ``.npz`` whose keys are the leaves' tree
paths (``"segments/0/mix/wq"``) in JAX's leaf order, bf16 leaves stored as
their raw 16 bits (a ``uint16`` view) under the key suffix ``::bf16``, and
an optional ``<path>.meta.json`` holding the step. A checkpoint written by
either package restores in the other bit for bit.

``consensus_params`` collapses a worker-stacked tree (the leading M dim the
decentralized trainer keeps) to the paper's output model w̄ = (1/M) Σ_j w_j,
averaging in float32 and casting back. The asynchronous writer and the
worker-sharded layout (``save_sharded``/``restore_sharded``) are not ported
yet (ROADMAP queue 1, item 8).
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import resolve_device

PyTree = Any

__all__ = ["save", "restore", "consensus_params", "export_consensus", "latest_step"]

# Suffix marking a bf16 leaf stored as its raw 16-bit pattern (numpy .npz
# cannot store bfloat16; a uint16 view keeps the exact bits).
_BF16_TAG = "::bf16"


def _path_key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    """{path key: numpy array} in leaf order; bf16 leaves as tagged uint16."""
    flat = {}
    for path, leaf in _tree.flatten_with_path(tree):
        key = _path_key(path)
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            key, arr = key + _BF16_TAG, t.contiguous().view(torch.int16).numpy().view(np.uint16)
        else:
            arr = t.numpy()
        flat[key] = arr
    return flat


def _base_key(stored: str) -> str:
    return stored[:-len(_BF16_TAG)] if stored.endswith(_BF16_TAG) else stored


def _npz_path(path: str) -> str:
    """``path`` with its ``.npz`` suffix; raises for a worker-sharded
    checkpoint, whose layout is not ported yet."""
    p = path if path.endswith(".npz") else path + ".npz"
    meta = p[:-len(".npz")] + ".meta.json"
    if not os.path.exists(p) and os.path.exists(meta):
        with open(meta) as f:
            if "sharded" in json.load(f):
                raise NotImplementedError(
                    f"{path} is a worker-sharded checkpoint; restoring those is not "
                    "ported yet (ROADMAP queue 1, item 8)")
    return p


def _stored_tensor(raw: np.ndarray, stored: str, device: torch.device) -> torch.Tensor:
    """A stored array as a tensor on ``device``, tagged leaves as bf16."""
    if stored.endswith(_BF16_TAG):
        bits = np.ascontiguousarray(raw).view(np.int16)
        return torch.from_numpy(bits).to(device).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(raw)).to(device)


def save(path: str, tree: PyTree, step: int | None = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **_flatten_with_paths(tree))
    if step is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump({"step": int(step)}, f)


def restore(path: str, like: PyTree, device: str | torch.device = "cuda") -> PyTree:
    """Restore into the structure of ``like`` (shapes and dtypes kept).

    A leaf may be stored tagged (bf16 bits) or plain, whatever the dtype of
    ``like``: only the set of leaves must match. ``like``'s leaves need only
    ``.shape`` and ``.dtype``, so tensors on the ``meta`` device will do.
    """
    dev = resolve_device(device)
    data = np.load(_npz_path(path))
    stored_by_key = {_base_key(f): f for f in data.files}
    paths = _tree.flatten_with_path(like)
    like_keys = {_path_key(p) for p, _ in paths}
    if set(stored_by_key) != like_keys:
        raise ValueError(f"{path}: stored leaves differ from the template's: "
                         f"{sorted(set(stored_by_key) ^ like_keys)[:5]}")
    out = []
    for p, leaf in paths:
        key = _path_key(p)
        t = _stored_tensor(data[stored_by_key[key]], stored_by_key[key], dev).to(leaf.dtype)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(f"{path}: {key} has shape {tuple(t.shape)}, want "
                             f"{tuple(leaf.shape)}")
        out.append(t)
    return _tree.unflatten(_tree.flatten(like)[1], out)


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

    ``src`` is a checkpoint path, loaded as stored onto ``device``, or an
    in-memory worker-stacked tree. The averaged tree is returned and, when
    ``dst`` is given, saved as a normal checkpoint that
    ``serving.engine.load_consensus_params`` (or :func:`restore`) reads."""
    if isinstance(src, str):
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
