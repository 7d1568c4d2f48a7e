"""Mamba-2 block: the SSD (state-space duality) chunked algorithm
[arXiv:2405.21060].

The port of the reference's ``repro/models/ssm.py``: ``mamba2_defs``,
``MambaCache``/``init_mamba_cache``, ``_segsum``, ``ssd_chunked`` and
``mamba2_apply``. Training and prefill use the chunked dual form: a
quadratic, attention-like term inside each chunk plus a linear recurrence
over the per-chunk states, which the reference scans with ``lax.scan`` and
the port runs as a Python loop over the chunks that stacks its outputs (no
in-place write, so the train step's ``vmap`` over workers batches it).
Decode is the O(1) recurrent update. The SSM state stays float32, in the
cache and in the scan.

With a telemetry sink installed (:mod:`repro_torch.telemetry`) each call of
:func:`mamba2_apply` is a ``ssm.mix`` span holding the ``ssm.scan`` span of
its :func:`ssd_chunked` call (a training forward's, and remat's recompute's,
since both run the layer); ``ssm.tokens`` adds each mixer call's B·L and
``ssm.chunks`` each scan's b·(l / chunk), by the shapes the call sees: per
worker inside the train step's ``vmap``, which runs the body once for all
workers.

The reference's four-operand einsum of the diagonal blocks is written as
two pairwise products, and every product whose operands JAX would promote
to float32 (bf16 inputs beside float32 step sizes and decays) takes float32
operands: torch's einsum does not promote mixed dtypes.

The cache is written in place (``conv``, ``state``), as ``KVCache`` is, and
a new :class:`MambaCache` over the same storage comes back with ``pos``
advanced; so a layer of a stacked cache, a view, updates the stack.

Inside ``launch.mesh.model_parallel``, with the heads cut over the model
axis (``ssm_heads`` divides k: ``dt_bias``, ``A_log`` and ``D``, and over
``ssm_inner`` ``norm.scale`` and ``out_proj``'s rows, a rank's contiguous
heads), the block is tensor parallel. ``in_proj``'s columns and the conv's
channels are cut straight across the z / x / B / C / dt boundaries, so the
rank gathers whole its product with ``in_proj``'s columns (a
(B, L, 2·di + 2·G·N + H) activation, far smaller than the weight in a
decode step) and the conv's leaves
(``tensor_parallel.all_gather_model``, whose gradient sums the ranks'
partial cotangents), and takes its heads' z, x and dt columns, the whole
B and C of the groups its heads read, and the matching conv channels; a
leaf the specs keep whole enters through ``copy_to_model``. ``x`` enters through ``copy_to_model``, SSD runs on the
rank's heads, the gated norm's mean of squares over the whole ``d_inner``
takes one all-reduce of a (B, L) float32 sum, and the output projection's
partial sum leaves through ``reduce_from_model``. The cache holds the
rank's heads' state, and in its conv tail the rank's x channels beside the
whole B and C. Where the heads do not divide k, the block runs whole on
every rank, its cut leaves gathered (``gather_from_model``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.launch import tensor_parallel as tp
from repro_torch.launch.mesh import model_shard
from repro_torch.models.layers import rmsnorm_apply, rmsnorm_defs
from repro_torch.models.params import ParamDef

PyTree = Any

__all__ = ["mamba2_defs", "MambaCache", "init_mamba_cache", "ssd_chunked", "mamba2_apply"]


def mamba2_defs(cfg: ModelConfig) -> PyTree:
    D = cfg.d_model
    di = cfg.d_inner
    G, N, H = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = di + 2 * G * N
    return {
        "in_proj": ParamDef((D, 2 * di + 2 * G * N + H), ("embed", "ssm_inner")),
        "conv_w": ParamDef((cfg.ssm_conv, conv_dim), (None, "ssm_inner"), scale=0.5),
        "conv_b": ParamDef((conv_dim,), ("ssm_inner",), init="zeros"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D": ParamDef((H,), ("ssm_heads",), init="ones"),
        "norm": rmsnorm_defs(di, axis="ssm_inner"),
        "out_proj": ParamDef((di, D), ("ssm_inner", "embed")),
    }


class MambaCache(NamedTuple):
    conv: torch.Tensor    # (B, ssm_conv - 1, conv_dim): the last inputs of the causal conv
    state: torch.Tensor   # (B, H, P, N) float32
    pos: int


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device, layers: int | None = None) -> MambaCache:
    """An empty cache; inside ``launch.mesh.model_parallel`` the rank's
    H/k heads (and their x channels beside the whole B and C) where k
    divides the heads."""
    shard, H = model_shard(), cfg.ssm_nheads
    Hl = H // shard.k if shard is not None and H % shard.k == 0 else H
    G = _local_groups(cfg, 0, Hl)[1]
    conv_dim = Hl * cfg.ssm_headdim + 2 * G * cfg.ssm_state
    lead = (batch,) if layers is None else (layers, batch)
    return MambaCache(
        torch.zeros(lead + (cfg.ssm_conv - 1, conv_dim), dtype=dtype, device=device),
        torch.zeros(lead + (Hl, cfg.ssm_headdim, cfg.ssm_state),
                    dtype=torch.float32, device=device),
        0)


def _local_groups(cfg: ModelConfig, index: int, Hl: int) -> tuple[int, int]:
    """(first, count) of the B/C groups that model shard ``index``'s ``Hl``
    heads read (head h reads group h // (H/G)): a contiguous run where the
    rank's heads span whole groups or fall in one."""
    G, rep = cfg.ssm_ngroups, cfg.ssm_nheads // cfg.ssm_ngroups
    if Hl == cfg.ssm_nheads:
        return 0, G
    if Hl % rep and rep % Hl:
        raise NotImplementedError(f"{Hl} heads per model shard over groups of {rep}")
    return index * Hl // rep, max(Hl // rep, 1)


def _whole(w: torch.Tensor, n: int) -> torch.Tensor:
    """A leaf of ``n`` columns (its last dim) whole on every rank of the
    model group: gathered where the specs cut it, else through *f*."""
    return tp.all_gather_model(w, -1) if w.shape[-1] < n else tp.copy_to_model(w)


def _head_columns(cfg: ModelConfig, index: int, Hl: int):
    """The column ranges, ``(start, length)``, of ``in_proj`` (z, x, B, C,
    dt) and of the conv (x, B, C) that model shard ``index``'s ``Hl`` heads
    use."""
    di, N, H, P = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    GN = cfg.ssm_ngroups * N
    g0, g = _local_groups(cfg, index, Hl)
    x = (index * Hl * P, Hl * P)
    conv = [x, (di + g0 * N, g * N), (di + GN + g0 * N, g * N)]
    proj = [x] + [(di + a, n) for a, n in conv] + [(2 * di + 2 * GN + index * Hl, Hl)]
    return proj, conv


def _columns(w: torch.Tensor, ranges) -> torch.Tensor:
    return torch.cat([w.narrow(-1, a, n) for a, n in ranges], dim=-1)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: out[..., i, j] = Σ_{j<t<=i} dA[..., t],
    -inf above the diagonal (exp gives 0 there, and a 0 gradient)."""
    Q = dA.shape[-1]
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD forward.

    x: (b, l, h, p) inputs; dt: (b, l, h) positive float32 step sizes; A:
    (h,) negative float32 decay rates; B, C: (b, l, g, n), the g groups
    broadcast over the heads. Returns y: (b, l, h, p) float32 and the final
    state (b, h, p, n) float32. A ``ssm.scan`` span (module note).
    """
    tel = telemetry.get()
    with tel.span("ssm.scan"):
        if tel.active:
            tel.counter("ssm.chunks", x.shape[0] * (x.shape[1] // chunk))
        return _ssd(x, dt, A, B, C, chunk)


def _ssd(x, dt, A, B, C, chunk: int):
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    if l % chunk:
        raise ValueError(f"length {l} is not a multiple of the chunk {chunk}")
    c = l // chunk
    rep = h // g
    f32 = torch.float32

    xc = x.reshape(b, c, chunk, h, p)
    dtc = dt.reshape(b, c, chunk, h)
    Bc = torch.repeat_interleave(B.reshape(b, c, chunk, g, n), rep, dim=3)   # (b,c,q,h,n)
    Cc = torch.repeat_interleave(C.reshape(b, c, chunk, g, n), rep, dim=3)

    dA = dtc * A                                                   # (b,c,q,h)
    dA_cs = torch.cumsum(dA, dim=2)                                # within-chunk
    # within-chunk (diagonal blocks): L[i, j] = exp(Σ_{j<t<=i} dA_t)
    Lseg = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))              # (b,c,h,q,q)
    xdt = xc * dtc[..., None]                                      # float32
    # bcqhn,bckhn,bchqk,bckhp->bcqhp as two products
    scores = torch.einsum("bcqhn,bckhn->bchqk", Cc.to(f32), Bc.to(f32)) * Lseg
    Y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores, xdt)

    # per-chunk input states: decay from each position to the chunk's end
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)          # (b,c,q,h)
    states = torch.einsum("bcqhn,bcqhp->bchpn", Bc.to(f32), decay_to_end[..., None] * xdt)

    chunk_decay = torch.exp(dA_cs[:, :, -1, :])                    # (b,c,h)
    s = torch.zeros((b, h, p, n), dtype=f32, device=x.device)
    prev = []
    for i in range(c):                                             # lax.scan over chunks
        prev.append(s)
        s = s * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)                         # (b,c,h,p,n)

    # cross-chunk: the contribution of the state entering each chunk
    state_decay = torch.exp(dA_cs)                                 # (b,c,q,h)
    Y_off = torch.einsum("bcqhn,bchpn->bcqhp", Cc.to(f32),
                         prev_states.to(Cc.dtype).to(f32)) * state_decay[..., None]
    y = (Y_diag + Y_off).reshape(b, l, h, p)
    return y, s


def _write(cache: MambaCache, conv: torch.Tensor, state: torch.Tensor, n: int) -> MambaCache:
    cache.conv.copy_(conv)
    cache.state.copy_(state)
    return MambaCache(cache.conv, cache.state, cache.pos + n)


def mamba2_apply(params, cfg: ModelConfig, x, *, cache: MambaCache | None = None):
    """x: (B, L, D) -> ((B, L, D), new cache or None). With a cache and L == 1,
    one recurrent decode step; with a cache and L > 1, a prefill from an
    empty cache that leaves the conv tail and the final state in it. A
    ``ssm.mix`` span (module note)."""
    tel = telemetry.get()
    with tel.span("ssm.mix"):
        if tel.active:
            tel.counter("ssm.tokens", x.shape[0] * x.shape[1])
        return _mamba2(params, cfg, x, cache)


def _mamba2(params, cfg: ModelConfig, x, cache: MambaCache | None):
    Bsz, L, _ = x.shape
    di, G, N, H, P = cfg.d_inner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    conv_dim = di + 2 * G * N
    in_proj, conv_w, conv_b = params["in_proj"], params["conv_w"], params["conv_b"]
    shard = model_shard()
    Hl = params["dt_bias"].shape[-1]
    cut = shard is not None and Hl < H             # the rank's heads (module note)
    if cut:
        x = tp.copy_to_model(x)
        proj_cols, conv_cols = _head_columns(cfg, shard.index, Hl)
        if in_proj.shape[-1] < 2 * di + 2 * G * N + H:
            # the rank's columns of the product, gathered whole
            zxbcdt = tp.all_gather_model(x @ in_proj, -1)
        else:
            zxbcdt = x @ tp.copy_to_model(in_proj)
        zxbcdt = _columns(zxbcdt, proj_cols)
        conv_w = _columns(_whole(conv_w, conv_dim), conv_cols)
        conv_b = _columns(_whole(conv_b, conv_dim), conv_cols)
        G = _local_groups(cfg, shard.index, Hl)[1]
        di, H, conv_dim = Hl * P, Hl, Hl * P + 2 * G * N
    else:
        if shard is not None:                      # whole on every rank
            in_proj, conv_w, conv_b = (tp.gather_from_model(w, -1) if w.shape[-1] < n else w
                                       for w, n in ((in_proj, 2 * di + 2 * G * N + H),
                                                    (conv_w, conv_dim), (conv_b, conv_dim)))
        zxbcdt = x @ in_proj
    z, xbc, dt_raw = torch.split(zxbcdt, [di, conv_dim, H], dim=-1)
    A = -torch.exp(params["A_log"].float())

    if cache is None or L > 1:
        # training forward or prefill: causal depthwise conv along L
        pad = xbc.new_zeros((Bsz, cfg.ssm_conv - 1, conv_dim))
        xbc_p = torch.cat([pad, xbc], dim=1)
        conv = sum(xbc_p[:, i:i + L] * conv_w[i][None, None]
                   for i in range(cfg.ssm_conv)) + conv_b
        conv = F.silu(conv)
        xs, B_, C_ = torch.split(conv, [di, G * N, G * N], dim=-1)
        dt = F.softplus(dt_raw.float() + params["dt_bias"])
        # pad to a chunk multiple with dt = 0 (no decay, no input), so the
        # final state is exact
        chunk = min(cfg.ssm_chunk, L) if L % cfg.ssm_chunk else cfg.ssm_chunk
        Lp = -(-L // chunk) * chunk
        if Lp != L:
            xs_p, dt_p, Bp, Cp = (F.pad(t, (0, 0, 0, Lp - L)) for t in (xs, dt, B_, C_))
        else:
            xs_p, dt_p, Bp, Cp = xs, dt, B_, C_
        y, final = ssd_chunked(xs_p.reshape(Bsz, Lp, H, P), dt_p, A,
                               Bp.reshape(Bsz, Lp, G, N), Cp.reshape(Bsz, Lp, G, N), chunk)
        y = y[:, :L]
        y = y + xs.reshape(Bsz, L, H, P) * params["D"][None, None, :, None]
        y = y.reshape(Bsz, L, di).to(x.dtype)
        new_cache = None
        if cache is not None:         # prefill: keep the conv tail and the final state
            new_cache = _write(cache, xbc_p[:, L:], final, L)
    else:
        # one recurrent step (L == 1)
        xbc_hist = torch.cat([cache.conv, xbc], dim=1)             # (B, conv, dim)
        conv = torch.einsum("bkc,kc->bc", xbc_hist, conv_w) + conv_b
        conv = F.silu(conv)[:, None]
        xs, B_, C_ = torch.split(conv, [di, G * N, G * N], dim=-1)
        dt = F.softplus(dt_raw.float() + params["dt_bias"])[:, 0]  # (B, H)
        xh = xs.reshape(Bsz, H, P)
        Bh = torch.repeat_interleave(B_.reshape(Bsz, G, N), H // G, dim=1)   # (B, H, N)
        Ch = torch.repeat_interleave(C_.reshape(Bsz, G, N), H // G, dim=1)
        decay = torch.exp(dt * A)                                  # (B, H)
        st = cache.state * decay[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", dt[..., None] * xh.float(), Bh.float())
        y = torch.einsum("bhpn,bhn->bhp", st, Ch.float()).to(x.dtype)
        y = y + xh * params["D"][None, :, None]
        y = y.reshape(Bsz, 1, di)
        new_cache = _write(cache, xbc_hist[:, 1:], st, 1)

    if cut:
        return tp.reduce_from_model(_cut_norm(params["norm"], y * F.silu(z), cfg)
                                    @ params["out_proj"]), new_cache
    norm, out_proj = params["norm"], params["out_proj"]
    if shard is not None:                          # whole on every rank
        norm = {"scale": tp.gather_from_model(norm["scale"], -1)
                if norm["scale"].shape[-1] < di else norm["scale"]}
        out_proj = tp.gather_from_model(out_proj, -2) if out_proj.shape[-2] < di else out_proj
    y = rmsnorm_apply(norm, y * F.silu(z), cfg.norm_eps)
    return y @ out_proj, new_cache


def _cut_norm(norm, x, cfg: ModelConfig):
    """``rmsnorm_apply`` over the rank's columns of the whole ``d_inner``:
    the sum of squares all-reduced over the model group, forward and
    backward (*g*, then *f*: every rank's normalizer reads every rank's
    columns)."""
    x32 = x.float()
    ss = tp.copy_to_model(tp.reduce_from_model(torch.sum(torch.square(x32), -1, keepdim=True)))
    normed = x32 * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    return (normed * norm["scale"].float()).to(x.dtype)
