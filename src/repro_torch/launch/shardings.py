"""Sharding rules: params, batches and caches → partition specs, and the cut
of a global tree into a rank's local tree.

The port of the reference's ``repro/launch/shardings.py``. Every function
takes a :class:`~repro_torch.launch.mesh.WorkerMesh` (raw meshes are
factorized on entry): worker axes host the gossip workers, the model axis
shards each worker's replica. Specs are
:class:`~repro_torch.models.params.PartitionSpec` trees equal, spec for
spec, to the reference's.

Param-spec modes:
  gossip    — a leading worker dim over the worker axes; within a worker the
              model axis shards heads / ff / vocab. These double as the bus's
              ``param_specs``; a leaf whose axes do not divide k is stored
              replicated and row-split by the bus (:func:`bus_row_split_flags`).
  allreduce — params replicated over the worker axes (the centralized
              baseline).
  fsdp      — serving's layout for huge checkpoints: no worker dim, d_model
              also sharded over the worker axes.

:func:`local_tree` places a global tree on the mesh: each rank keeps the
part its coordinate owns under the specs, the port's counterpart of
placing an array with a ``NamedSharding``.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import WorkerMesh
from repro_torch.models import model as M
from repro_torch.models.params import DEFAULT_RULES
from repro_torch.models.params import PartitionSpec as P
from repro_torch.models.params import tree_specs

PyTree = Any

__all__ = ["param_pspecs", "bus_row_split_flags", "state_pspecs", "batch_pspecs",
           "cache_pspecs", "cross_kv_pspecs", "local_tree"]


def param_pspecs(cfg: ModelConfig, mesh, mode: str | None = None,
                 worker_internal: str = "tp") -> PyTree:
    """worker_internal (gossip mode only): 'tp' — each worker shards its
    replica over 'model' (default); 'dp' — each worker replicates its params
    over 'model' and splits its local batch instead."""
    wm = WorkerMesh.ensure(mesh)
    mode = mode or cfg.dp_mode
    defs = M.model_defs(cfg)
    if mode == "gossip":
        if worker_internal == "dp":
            rules = {k: None for k in DEFAULT_RULES}
            return tree_specs(defs, rules=rules, mesh=wm, prefix_axes=(wm.wa,))
        return tree_specs(defs, mesh=wm, prefix_axes=(wm.wa,))
    if mode == "allreduce":
        rules = None
        if cfg.moe_shard == "capacity":
            rules = dict(DEFAULT_RULES)
            rules["experts"] = None
            rules["expert_ff"] = None   # replicate expert weights
        return tree_specs(defs, rules=rules, mesh=wm)
    if mode == "fsdp":
        rules = dict(DEFAULT_RULES)
        rules["embed"] = wm.wa              # shard d_model over the worker axes
        return tree_specs(defs, rules=rules, mesh=wm)
    raise ValueError(mode)


def bus_row_split_flags(param_specs: PyTree, mesh) -> PyTree:
    """Which leaves the gossip bus row-splits over the model axis: a bool
    tree mirroring ``param_specs``, True where the spec does NOT shard over
    the WorkerMesh's model axis (all False when k = 1: every leaf packs
    whole). The bus derives the same flags itself from ``param_specs``."""
    from repro_torch.core.bus import sharded_leaf_flags

    wm = WorkerMesh.ensure(mesh)
    leaves, treedef = _tree.flatten(param_specs)
    if wm is None or wm.model_factor <= 1:
        return _tree.unflatten(treedef, [False] * len(leaves))
    flags = sharded_leaf_flags(leaves, wm.model_axis)
    return _tree.unflatten(treedef, [not f for f in flags])


def state_pspecs(cfg: ModelConfig, mesh, opt_state_like: PyTree,
                 params_spec: PyTree) -> PyTree:
    """TrainState(step, params, opt_state) specs; momentum mirrors params,
    Adam's state is ``{"m": params, "v": params}``."""
    from repro_torch.core.decentralized import TrainState

    if isinstance(opt_state_like, dict) and set(opt_state_like) == {"m", "v"}:
        opt_spec_tree = {"m": params_spec, "v": params_spec}
    elif opt_state_like == ():
        opt_spec_tree = ()
    else:
        opt_spec_tree = params_spec
    return TrainState(P(), params_spec, opt_spec_tree)


def batch_pspecs(cfg: ModelConfig, mesh, kind: str, mode: str,
                 worker_internal: str = "tp") -> PyTree:
    wa = WorkerMesh.ensure(mesh).wa
    specs = {}
    if mode == "gossip" and kind == "train":
        # worker_internal 'dp'/'fsdp': split the per-worker batch over 'model'
        b_ax = "model" if worker_internal in ("dp", "fsdp") else None
        specs["tokens"] = P(wa, b_ax, None)      # (M, b, L)
        specs["labels"] = P(wa, b_ax, None)
        if cfg.encoder_layers:
            specs["enc_embeds"] = P(wa, b_ax, None, None)
    else:
        specs["tokens"] = P(wa, None)            # (B, L)
        if kind == "train":
            specs["labels"] = P(wa, None)
        if cfg.encoder_layers:
            specs["enc_embeds"] = P(wa, None, None)
    return specs


def _div(n: int, mesh, axis) -> Any:
    """``axis`` if n divides the mesh axis size (tuple axes: the product)."""
    shape = WorkerMesh.ensure(mesh).shape
    names = axis if isinstance(axis, tuple) else (axis,)
    total = int(np.prod([shape[a] for a in names]))
    return axis if (total > 1 and n % total == 0) else None


def _stacked(spec: PyTree) -> PyTree:
    """A scanned segment's specs: a leading (unsharded) layer dim."""
    return _tree.map(lambda p: P(None, *p), spec)


def cache_pspecs(cfg: ModelConfig, mesh, batch: int) -> PyTree:
    """Specs mirroring the reference's ``model.init_cache`` structure (a
    scanned segment's stacked, its ``pos`` included)."""
    from repro_torch.models.attention import KVCache, MLACache
    from repro_torch.models.rglru import RGLRUCache
    from repro_torch.models.ssm import MambaCache

    wm = WorkerMesh.ensure(mesh)
    b_ax = _div(batch, wm, wm.wa)

    def kv_spec():
        # kv heads over 'model' where they divide it, else the sequence dim
        h_ax = _div(cfg.n_kv_heads, wm, "model")
        s_ax = "model" if h_ax is None else None
        return KVCache(P(b_ax, s_ax, h_ax, None), P(b_ax, s_ax, h_ax, None), P())

    def mla_spec():
        # the compressed cache has no head dim: shard the sequence dim
        return MLACache(P(b_ax, "model", None), P(b_ax, "model", None), P())

    def mamba_spec():
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        return MambaCache(P(b_ax, None, _div(conv_dim, wm, "model")),
                          P(b_ax, _div(cfg.ssm_nheads, wm, "model"), None, None), P())

    def rglru_spec():
        w_ax = _div(cfg.lru_width or cfg.d_model, wm, "model")
        return RGLRUCache(P(b_ax, None, w_ax), P(b_ax, w_ax), P())

    def one(kind: str):
        if kind in ("attn", "local"):
            return mla_spec() if cfg.attention_type == "mla" else kv_spec()
        if kind == "ssm":
            return mamba_spec()
        if kind == "rglru":
            return rglru_spec()
        raise ValueError(kind)

    return [_stacked(one(seg.kind)) if seg.scanned else [one(seg.kind)
                                                         for _ in range(seg.length)]
            for seg in M.plan_segments(cfg)]


def cross_kv_pspecs(cfg: ModelConfig, mesh, batch: int) -> PyTree:
    wm = WorkerMesh.ensure(mesh)
    b_ax = _div(batch, wm, wm.wa)
    h_ax = _div(cfg.n_kv_heads, wm, "model")
    out = []
    for seg in M.plan_segments(cfg):
        pair = (P(b_ax, None, h_ax, None), P(b_ax, None, h_ax, None))
        out.append(_stacked(pair) if seg.scanned else [pair for _ in range(seg.length)])
    return out


def _piece(x, spec, shape: dict[str, int], coord: dict[str, int]):
    """The part of ``x`` that the rank at ``coord`` owns under ``spec``: each
    sharded dim cut into equal pieces over its axes' product, the first axis
    of an entry major."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        names = entry if isinstance(entry, tuple) else (entry,)
        sizes = tuple(shape[a] for a in names)
        n = int(np.prod(sizes))
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        idx = int(np.ravel_multi_index(tuple(coord[a] for a in names), sizes))
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def local_tree(tree: PyTree, specs: PyTree, mesh, coordinate: dict[str, int] | None = None
               ) -> PyTree:
    """Cut a global tree into one rank's local tree by ``specs`` (a spec per
    leaf, e.g. :func:`param_pspecs`): views, not copies. ``coordinate``
    defaults to this rank's on a live mesh; give one to cut any rank's part
    (an abstract mesh needs it)."""
    wm = WorkerMesh.ensure(mesh)
    coord = wm.coordinate if coordinate is None else coordinate
    shape = wm.shape
    spec_leaves = _tree.flatten_up_to(_tree.flatten(tree)[1], specs)
    leaves, treedef = _tree.flatten(tree)
    return _tree.unflatten(treedef, [_piece(x, s, shape, coord)
                                     for x, s in zip(leaves, spec_leaves)])
