"""Shared layers: RMSNorm, rotary embeddings, the MLP variants and
Mixture-of-Experts.

The port of the reference's ``repro/models/layers.py``: ``rmsnorm``,
``rope``, ``mlp_defs``/``mlp_apply`` (SwiGLU, GeGLU, squared ReLU, GELU) and
the capacity-routed MoE (``moe_defs``, ``moe_apply`` and its helpers) with
shared experts. Modules expose ``<name>_defs(cfg, ...)`` returning a ParamDef
tree and ``<name>_apply(params, cfg, x, ...)``.

MoE keeps the reference's dispatch: top-k routing over float32 router
probabilities (ties to the lower expert index, as ``jax.lax.top_k``), a
place in each expert's queue from a one-hot cumulative sum, a capacity of
``ceil(N·K/E·capacity_factor)`` tokens per expert (the rest dropped), an
index-only scatter into the slot table, a value gather into the (E, C, D)
buffer, the expert FFNs batched over E, and the weighted gather back, one
top-k rank at a time. The reference runs all of it in XLA, outside any
Pallas kernel, so the port runs it in PyTorch.
"""
from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import model_shard, rows_cut
from repro_torch.models.params import ParamDef

PyTree = Any

__all__ = ["rmsnorm_defs", "rmsnorm_apply", "rope", "mlp_defs", "mlp_apply", "moe_defs",
           "moe_apply"]


def rmsnorm_defs(dim: int, axis: str = "embed") -> PyTree:
    return {"scale": ParamDef((dim,), (axis,), init="ones")}


def rmsnorm_apply(params: PyTree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm computed in float32, cast back to ``x``'s dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * params["scale"].float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_freqs(hd: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's float32 frequencies, computed by numpy as it does,
    moved to ``device`` once: a host→device copy at every call would make
    the host wait for the device twice per layer (decode is host-bound)."""
    freqs = 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))
    return torch.from_numpy(np.asarray(freqs, np.float32)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, split-halves layout (not interleaved), in float32.

    x: (..., L, H, hd); positions: (..., L).
    """
    freqs = _rope_freqs(x.shape[-1], float(theta), x.device)
    angles = positions[..., :, None].float() * freqs        # (..., L, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_defs(cfg: ModelConfig) -> PyTree:
    D, Fd = cfg.d_model, cfg.d_ff
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": ParamDef((D, Fd), ("embed", "ff")),
            "w_up": ParamDef((D, Fd), ("embed", "ff")),
            "w_down": ParamDef((Fd, D), ("ff", "embed")),
        }
    if cfg.mlp_type in ("relu2", "gelu"):   # nemotron's squared ReLU, plain GELU
        return {
            "w_up": ParamDef((D, Fd), ("embed", "ff")),
            "w_down": ParamDef((Fd, D), ("ff", "embed")),
        }
    raise ValueError(cfg.mlp_type)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form: ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """The MLP over (B, L, D). Inside ``launch.mesh.model_parallel``, with
    the ``ff`` dim cut to this rank's columns (``w_up``'s last dim below
    ``cfg.d_ff``), it is tensor parallel: ``x`` enters through
    ``copy_to_model``, the rank's ``ff`` columns go through the activation
    and its rows of ``w_down``, and the partial sum leaves through
    ``reduce_from_model``."""
    sharded = params["w_up"].shape[-1] < cfg.d_ff and model_shard() is not None
    if sharded:
        x = tp.copy_to_model(x)
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif cfg.mlp_type == "geglu":
        h = _gelu(x @ params["w_gate"]) * (x @ params["w_up"])
    elif cfg.mlp_type == "relu2":
        h = torch.square(F.relu(x @ params["w_up"]))
    elif cfg.mlp_type == "gelu":
        h = _gelu(x @ params["w_up"])
    else:
        raise ValueError(cfg.mlp_type)
    out = h @ params["w_down"]
    return tp.reduce_from_model(out) if sharded else out


def moe_defs(cfg: ModelConfig) -> PyTree:
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    defs: PyTree = {
        "router": ParamDef((D, E), ("embed", "experts"), scale=0.02),
        "w_gate": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "w_up": ParamDef((E, D, Fe), ("experts", "embed", "expert_ff")),
        "w_down": ParamDef((E, Fe, D), ("experts", "expert_ff", "embed")),
    }
    if cfg.mlp_type not in ("swiglu", "geglu"):
        defs.pop("w_gate")
    if cfg.n_shared_experts:
        Fs = cfg.d_ff_expert * cfg.n_shared_experts
        defs["shared"] = {
            "w_gate": ParamDef((D, Fs), ("embed", "ff")),
            "w_up": ParamDef((D, Fs), ("embed", "ff")),
            "w_down": ParamDef((Fs, D), ("ff", "embed")),
        }
    return defs


def _expert_ffn(params: PyTree, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe: (E, C, D) -> (E, C, D), one batched product per weight over E."""
    if "w_gate" in params:
        act = F.silu if cfg.mlp_type == "swiglu" else _gelu
        h = act(torch.bmm(xe, params["w_gate"])) * torch.bmm(xe, params["w_up"])
    else:
        h = torch.square(F.relu(torch.bmm(xe, params["w_up"])))
    return torch.bmm(h, params["w_down"])


def _shared_expert(params: PyTree, x: torch.Tensor) -> torch.Tensor:
    """The shared experts, one SwiGLU MLP whatever ``mlp_type`` (the reference's)."""
    sh = params["shared"]
    return (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, equal values in
    index order. ``torch.topk`` leaves the order of ties unspecified (on the
    card it varies), and bf16 router logits tie often; a stable descending
    sort keeps the lower index first."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_logits(cfg: ModelConfig, logits: torch.Tensor, rows=None):
    """Routing from the float32 router logits (N, E) of a flat token
    matrix → (top-k weights (N, K) float32, expert indices (N, K), keep
    (N, K), slots (N, K), capacity, aux loss). A kept (token, k) sits in
    slot ``expert·C' + place``, a dropped one in the overflow slot E·C',
    where C' is the buffer's capacity per expert.

    ``rows``: a live WorkerMesh whose worker groups each hold a cut of the
    call's rows, in worker order (allreduce mode on a mesh): the routing is
    the whole call's. The capacity C comes from the global token count; a
    (token, k)'s place in its expert's queue is its place among this
    rank's tokens plus the counts of the ranks before it (all-gathered,
    exact integers), and it is kept while that global place is below C;
    the aux loss takes the mean probability over all tokens (a sum over the
    worker groups whose gradient carries the factor that the step's mean
    over ranks takes off) and the global count share, so every rank's
    equals the whole call's. The rank's buffer holds only its tokens, at
    their local places: C' = min(C, N), as a token picks an expert once.
    Without ``rows`` C' = C."""
    N = logits.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, K)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # one-hot by comparison: F.one_hot and bincount check or count on the
    # host, which the train step's vmap over workers cannot batch
    flat_oh = (topi.reshape(N * K)[:, None]
               == torch.arange(E, device=logits.device)).to(torch.int32)   # (N*K, E)
    counts = flat_oh.sum(0)
    # place of each (token, k) in its expert's queue, in (token, k) order;
    # the sum runs along the contiguous dim of the (E, N*K) transpose: on
    # the card a scan down the N*K rows of 8 columns is serial (4.4 ms per
    # mixtral layer at 12,288 tokens, PERF.md)
    pos_in_e = torch.cumsum(flat_oh.T.contiguous(), dim=1).T - flat_oh
    place = (pos_in_e * flat_oh).sum(-1).reshape(N, K)

    # load-balance aux loss (Switch-style)
    if rows is None:
        capacity = int(np.ceil(N * K / E * cfg.capacity_factor))
        me = probs.mean(0)
        ce = counts.float() / (N * K)
        keep, held = place < capacity, capacity
    else:
        total = N * rows.n_workers
        capacity = int(np.ceil(total * K / E * cfg.capacity_factor))
        every = tp.gather_over_rows(counts, rows)                  # (n, E)
        before = every[:rows.worker_index].sum(0)
        me = tp.sum_over_rows(probs.sum(0), rows) / total
        ce = every.sum(0).float() / (total * K)
        offset = (before[None, :] * flat_oh).sum(-1).reshape(N, K)
        keep, held = place + offset < capacity, min(capacity, N)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef
    slot = torch.where(keep, topi * held + place, E * held)
    return topw, topi, keep, slot, held, aux


def _dispatch(params: PyTree, cfg: ModelConfig, xf: torch.Tensor, topw, keep, slot,
              capacity: int, first: int = 0) -> torch.Tensor:
    """The routed experts' output over a flat token matrix xf (N, D) from
    its routing (:func:`_route_logits`), for the experts this rank holds
    (``params``'s leading dim, from expert ``first``): their slots
    ``[first·C, (first + E_local)·C)`` are filled and run, the other
    experts' contributions are left out (a partial sum over expert
    shards). Token indices are scattered into the slot table (N marks an
    empty slot), then one gather of the values; the overflow slot, the only
    one written twice, is cut off."""
    N, D = xf.shape
    K = cfg.top_k
    n = params["w_up"].shape[0] * capacity
    local = slot - first * capacity
    mine = keep & (local >= 0) & (local < n)
    local = torch.where(mine, local, n)
    inv = torch.full((n + 1,), N, dtype=torch.long, device=xf.device)
    arange_n = torch.arange(N, device=xf.device)
    for k in range(K):
        inv = inv.scatter(0, local[:, k], arange_n)
    xf_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    buf = xf_pad[inv[:-1]].reshape(-1, capacity, D)
    # moe_shard="capacity" pins the capacity dim to a mesh axis in the
    # reference (_cap_shard), a layout with no numerical effect
    out_e = _expert_ffn(params, cfg, buf)
    out_flat = torch.cat([out_e.reshape(n, D), xf.new_zeros((1, D))], dim=0)
    y = xf.new_zeros((N, D))
    for k in range(K):
        w = (topw[:, k] * mine[:, k].float())[:, None].to(xf.dtype)
        y = y + out_flat[local[:, k]] * w
    return y


def moe_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routed experts with capacity over x (B, L, D) → (out, aux loss).

    ``moe_dispatch="global"`` routes the B·L tokens together;
    ``"per_sequence"`` routes each sequence on its own (capacity per
    sequence) and averages the aux losses; ``"per_sequence_smap"`` is
    ``"per_sequence"`` without a mesh, as in the reference's fallback.
    Global routing over a call whose rows are cut over the worker groups of
    a mesh (allreduce mode, ``launch.mesh.rows_cut``) routes the whole call
    (:func:`_route_logits`).

    Inside ``launch.mesh.model_parallel``, with the experts cut over the
    model axis (``w_*``'s leading dim, the router's columns: the sharding
    read from the local shapes, ``cfg.n_experts`` global), ``x`` enters
    through ``copy_to_model``, the rank's router logits are all-gathered
    (``gather_from_model``; one collective per layer, per-sequence routing
    included), the routing is computed identically on every rank, and each
    rank fills and runs only its experts' slots. Where the experts do not
    divide k their ``expert_ff`` columns are cut instead: the router is
    replicated and reads ``x`` itself, the buffer is whole and each expert
    runs on the rank's columns. Either way the routing weights enter the
    combine through ``copy_to_model``, so their cotangent (and the logits')
    is whole on every rank, and the partial output, with the shared
    experts' over their ``ff`` columns, leaves through one
    ``reduce_from_model``. A part replicated over the model axis (the
    routed experts under the reference's ``moe_shard="capacity"`` specs,
    the shared experts where ``ff`` does not divide k) reads ``x`` itself
    and adds its output whole.
    """
    B, L, D = x.shape
    shard = model_shard()
    n_local = params["w_up"].shape[0]
    experts_cut = shard is not None and n_local < cfg.n_experts
    routed_cut = experts_cut or (shard is not None
                                 and params["w_up"].shape[-1] < cfg.d_ff_expert)
    shared_cut = (shard is not None and bool(cfg.n_shared_experts) and
                  params["shared"]["w_up"].shape[-1] < cfg.d_ff_expert * cfg.n_shared_experts)
    xs = tp.copy_to_model(x) if routed_cut or shared_cut else x
    # a cut part reads the f'd x and its partial output leaves through g; a
    # replicated one reads x and computes its output whole
    xr = xs if routed_cut else x
    # the rank's router columns read the f'd x; a replicated router reads x
    logits = ((xs if experts_cut else x) @ params["router"]).float()
    if experts_cut:
        logits = tp.gather_from_model(logits, -1)
    first = shard.index * n_local if experts_cut else 0
    if cfg.moe_dispatch in ("per_sequence", "per_sequence_smap"):
        routes = [_route_logits(cfg, logits[b]) for b in range(B)]
        topw = torch.stack([r[0] for r in routes])
        aux = torch.stack([r[5] for r in routes]).mean()
        if routed_cut:
            topw = tp.copy_to_model(topw)
        y = torch.stack([_dispatch(params, cfg, xr[b], topw[b], r[2], r[3], r[4], first)
                         for b, r in enumerate(routes)])
    else:
        rows = rows_cut("an MoE layer routing the whole call (moe_dispatch='global')")
        topw, _, keep, slot, capacity, aux = _route_logits(cfg, logits.reshape(B * L, -1),
                                                           rows)
        if routed_cut:
            topw = tp.copy_to_model(topw)
        y = _dispatch(params, cfg, xr.reshape(B * L, D), topw, keep, slot, capacity,
                      first).reshape(B, L, D)
    parts = [(y, routed_cut)]
    if cfg.n_shared_experts:
        parts.append((_shared_expert(params, xs if shared_cut else x), shared_cut))
    whole = [p for p, cut in parts if not cut]
    partial = [p for p, cut in parts if cut]
    if partial:
        whole.append(tp.reduce_from_model(sum(partial[1:], partial[0])))
    return sum(whole[1:], whole[0]), aux
