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
from repro_torch.launch.mesh import model_shard, require_dense_model, require_whole_call
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


def _route(params: PyTree, cfg: ModelConfig, xf: torch.Tensor):
    """Routing of a flat token matrix xf (N, D) → (top-k weights (N, K)
    float32, expert indices (N, K), keep (N, K), slots (N, K), capacity,
    aux loss). A kept (token, k) sits in slot ``expert·C + place``; a
    dropped one in the overflow slot E·C."""
    N = xf.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    logits = (xf @ params["router"]).float()                  # (N, E)
    probs = torch.softmax(logits, dim=-1)
    topw, topi = _top_k(probs, K)
    topw = topw / torch.clamp_min(topw.sum(-1, keepdim=True), 1e-9)

    # one-hot by comparison: F.one_hot and bincount check or count on the
    # host, which the train step's vmap over workers cannot batch
    flat_oh = (topi.reshape(N * K)[:, None]
               == torch.arange(E, device=xf.device)).to(torch.int32)   # (N*K, E)

    # load-balance aux loss (Switch-style)
    me = probs.mean(0)
    ce = flat_oh.sum(0).float() / (N * K)
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    capacity = int(np.ceil(N * K / E * cfg.capacity_factor))
    # place of each (token, k) in its expert's queue, in (token, k) order;
    # the sum runs along the contiguous dim of the (E, N*K) transpose: on
    # the card a scan down the N*K rows of 8 columns is serial (4.4 ms per
    # mixtral layer at 12,288 tokens, PERF.md)
    pos_in_e = torch.cumsum(flat_oh.T.contiguous(), dim=1).T - flat_oh
    pos = (pos_in_e * flat_oh).sum(-1).reshape(N, K)
    keep = pos < capacity
    slot = torch.where(keep, topi * capacity + pos, E * capacity)
    return topw, topi, keep, slot, capacity, aux


def _moe_tokens(params: PyTree, cfg: ModelConfig, xf: torch.Tensor):
    """Routed-expert compute over a flat token matrix xf: (N, D) → (y, aux)."""
    N, D = xf.shape
    E, K = cfg.n_experts, cfg.top_k
    topw, _, keep, slot, capacity, aux = _route(params, cfg, xf)
    # token indices scattered into the slot table (N marks an empty slot),
    # then one gather of the values; the overflow slot E·C, the only one
    # written twice, is cut off
    inv = torch.full((E * capacity + 1,), N, dtype=torch.long, device=xf.device)
    arange_n = torch.arange(N, device=xf.device)
    for k in range(K):
        inv = inv.scatter(0, slot[:, k], arange_n)
    xf_pad = torch.cat([xf, xf.new_zeros((1, D))], dim=0)
    buf = xf_pad[inv[:-1]].reshape(E, capacity, D)
    # moe_shard="capacity" pins the capacity dim to a mesh axis in the
    # reference (_cap_shard); without a mesh it is the identity
    out_e = _expert_ffn(params, cfg, buf)
    out_flat = torch.cat([out_e.reshape(E * capacity, D), xf.new_zeros((1, D))], dim=0)
    y = xf.new_zeros((N, D))
    for k in range(K):
        w = (topw[:, k] * keep[:, k].float())[:, None].to(xf.dtype)
        y = y + out_flat[slot[:, k]] * w
    return y, aux


def moe_apply(params: PyTree, cfg: ModelConfig, x: torch.Tensor):
    """Top-k routed experts with capacity over x (B, L, D) → (out, aux loss).

    ``moe_dispatch="global"`` routes the B·L tokens together;
    ``"per_sequence"`` routes each sequence on its own (capacity per
    sequence) and averages the aux losses; ``"per_sequence_smap"`` is
    ``"per_sequence"`` without a mesh, as in the reference's fallback.
    Global routing refuses a call whose rows are cut over the ranks of a
    mesh (``launch.mesh.require_whole_call``): capacity, the tokens dropped
    and the aux loss depend on all of its tokens.
    """
    B, L, D = x.shape
    require_dense_model("an MoE layer")
    if cfg.moe_dispatch == "global":
        require_whole_call("an MoE layer routing the whole call (moe_dispatch='global')")
    if cfg.moe_dispatch in ("per_sequence", "per_sequence_smap"):
        outs, auxs = zip(*(_moe_tokens(params, cfg, x[b]) for b in range(B)))
        out, aux = torch.stack(outs), torch.stack(auxs).mean()
    else:
        out, aux = _moe_tokens(params, cfg, x.reshape(B * L, D))
        out = out.reshape(B, L, D)
    if cfg.n_shared_experts:
        out = out + _shared_expert(params, x)
    return out, aux
