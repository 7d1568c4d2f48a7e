#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``; nothing of JAX or of the JAX package)
through these phases, in order, and exits non-zero at the first failure:

1. device — needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. build — compiles every kernel of the paths below from the sources in this
   checkout (``nvcc``, ``sm_90a``), one compiler per source, all started
   together, and prints the build time.
3. kernel check — holds each kernel against its plain PyTorch version on the
   card at small and odd shapes and at the shape its path gives it, then
   times kernel and plain version with CUDA events. gossip_mix: float32 atol
   1e-5, bf16 atol 5e-2 (the reference's kernel-test tolerances).
   quant_pack: values and scales exactly equal (float32 and bf16 input, odd
   rows and columns, an unaligned buffer, zero rows, half-way ties, negative
   values).
4. slice 1 — ``repro_torch.train.loop.train``: the decentralized step of
   paper eq. (3) on granite-3-2b at its published widths, depth cut to 4
   layers, M=4 workers on a ring, momentum SGD, the fused gossip bus. Checks
   finite losses, one gossip_mix launch per step, and that one fused step
   from the trained state matches the einsum-backend step within the bf16
   tolerance; profiles one step.
5. slice 2 — the same model, batches and optimizer on ``hier(2, 2)`` (a ring
   of 2 pods ⊗ a clique of 2 inside each) with ``GossipSpec(hierarchical=
   True)``: 5 ``train()`` steps with exactly two gossip_mix launches each
   (intra-pod, cross-pod), one hierarchical step against one einsum step on
   the unsplit matrix within the bf16 tolerance, a profiled step; then 8
   rounds of ``hierarchical_mix_compressed(dci_dtype="int8")`` on the
   trained params with the error-feedback residual carried, exactly one
   quant_pack and one gossip_mix launch per round, round 1 within half the
   largest row scale plus one bf16 ulp of the exact ``hierarchical_mix``,
   a profiled round.
6. report — one JSON line of kernels, the nvidia-smi line, and last the
   ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Slice configuration (PERF.md, "Cells").
M_WORKERS = 4
N_LAYERS = 4            # granite-3-2b has 40; cut so M replicas + state fit
PER_WORKER_BATCH = 8
SEQ_LEN = 512
STEPS = 5
LR = 0.01
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DCI_ROUNDS = 8          # compressed cross-pod rounds of slice 2

# Device-memory rates (bytes/s) from NVIDIA's data sheets, by card name
# (first match wins), and the H100's float32 rate outside the tensor cores.
MEMORY_RATES = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                ("H100", 3.35e12))
F32_PEAK = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def memory_rate(name: str) -> float:
    for key, bw in MEMORY_RATES:
        if key in name:
            return bw
    raise RuntimeError(f"no memory rate on record for {name!r}")


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}  count={torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off for matmul and cuDNN: float32 products run in float32")
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels.gossip_mix import kernel as gm
    from repro_torch.kernels.quant_pack import kernel as qp

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:   # nvcc runs outside the GIL
        built = list(pool.map(lambda m: (m, m.library()[1]), (gm, qp)))
    log(f"[build] {len(built)} kernels built in {time.perf_counter() - t0:.2f} s")
    for mod, build_log in built:
        log(f"[build]   {os.path.relpath(mod.SOURCE, ROOT)}")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]     {line.strip()}")


def _mix_inputs(rows, cols, k, w_dtype, u_dtype, gen):
    import torch

    w = torch.randn((rows, cols), generator=gen, device="cuda").to(w_dtype)
    nbr = torch.randn((k, rows, cols), generator=gen, device="cuda").to(w_dtype)
    wts = torch.softmax(torch.randn(k + 1, generator=gen, device="cuda"), 0).cpu().numpy()
    u = None if u_dtype is None else torch.randn(
        (rows, cols), generator=gen, device="cuda").to(u_dtype)
    return w, nbr, wts, u


def _bound(moved: float, ops: float, card: str) -> tuple[float, str]:
    """Least time (ms) for ``moved`` bytes and ``ops`` float32 operations,
    and which of the two bounds it."""
    t_bytes, t_ops = moved / memory_rate(card), ops / F32_PEAK
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_check(card: str) -> dict:
    import torch

    from repro_torch.core import bus
    from repro_torch.kernels.gossip_mix import gossip_mix_2d, gossip_mix_reference

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for w_dt in (f32, bf16):
        for k in (1, 2, 4):
            for u_dt in (None, w_dt):
                cases.append((1001, 128, k, w_dt, u_dt))      # odd row count
    cases += [(37, 129, 2, f32, f32), (37, 129, 3, bf16, bf16),   # unaligned length
              (1001, 128, 2, bf16, f32), (1001, 128, 2, f32, bf16)]  # mixed dtypes
    worst = 0.0
    for rows, cols, k, w_dt, u_dt in cases:
        w, nbr, wts, u = _mix_inputs(rows, cols, k, w_dt, u_dt, gen)
        eta = 0.1 if u is not None else None
        out = gossip_mix_2d(w, nbr, wts, u, eta)
        ref = gossip_mix_reference(w, nbr, wts, u, eta)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(w_dt).split(".")[1]]
        if not (out.dtype == w.dtype and err <= tol):
            raise AssertionError(f"gossip_mix mismatch {rows}x{cols} k={k} "
                                 f"w={w_dt} u={u_dt}: max|err|={err} > {tol}")
        worst = max(worst, err)
    log(f"[kernel] gossip_mix matches its plain version on {len(cases)} small "
        f"cases (max|err| {worst:.3g})")

    # The main path's shape: M=4 bf16 replicas of the 4-layer full-width
    # model on the bus, (M·R, C) with k=2 ring neighbours and a bf16 update.
    rows = M_WORKERS * slice_bus_group().rows
    w, nbr, wts, u = _mix_inputs(rows, bus.LANE, 2, bf16, bf16, gen)
    out = gossip_mix_2d(w, nbr, wts, u, -1.0)
    ref = gossip_mix_reference(w, nbr, wts, u, -1.0)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    if err > TOL["bfloat16"]:
        raise AssertionError(f"gossip_mix mismatch at the slice shape: {err}")
    log(f"[kernel] gossip_mix at the slice shape ({rows}, {bus.LANE}) bf16 k=2: "
        f"max|err| {err:.3g} vs plain version")

    ms = time_cuda(lambda: gossip_mix_2d(w, nbr, wts, u, -1.0), iters=20)
    plain_ms = time_cuda(lambda: gossip_mix_reference(w, nbr, wts, u, -1.0), iters=3, warmup=1)
    n = w.numel()
    moved = n * w.element_size() * (1 + 2 + 1) + n * u.element_size()  # w, 2 nbr, out + u
    flops = n * (2 * 2 + 3)   # k+1 multiplies and k adds, then multiply and subtract
    bound_ms, bound_by = _bound(moved, flops, card)
    log(f"[kernel] gossip_mix {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del w, nbr, u
    torch.cuda.empty_cache()
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:45",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def _quant_cases(gen):
    """(label, x) small cases for quant_pack, each with its own hazard."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    scaled = lambda r, c: (torch.randn((r, c), generator=gen, device="cuda")
                           * torch.rand((r, 1), generator=gen, device="cuda") * 100)
    cases = []
    for dt in (f32, bf16):
        cases.append((f"{dt} odd rows", scaled(1001, 128).to(dt)))
        cases.append((f"{dt} odd cols", scaled(37, 129).to(dt)))
        flat = scaled(1, 1001 * 128 + 1).to(dt).view(-1)
        cases.append((f"{dt} unaligned buffer", flat[1:].view(1001, 128)))
        z = scaled(64, 128).to(dt)
        z[5] = 0
        z[40] = 0
        cases.append((f"{dt} zero rows", z))
        cases.append((f"{dt} negative", -scaled(64, 128).abs().to(dt)))
        # amax 127 gives scale exactly 1, so k + 0.5 entries are exact ties
        ties = (torch.arange(-64, 64, device="cuda", dtype=f32) + 0.5).repeat(32, 1)
        ties[:, 0] = 127.0
        ties[1::2] *= -1
        cases.append((f"{dt} half-way ties", ties.to(dt)))
    return cases


def phase_quant_check(card: str) -> dict:
    import torch

    from repro_torch.core import bus
    from repro_torch.kernels.quant_pack import quantize_pack_2d, quantize_pack_reference

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = _quant_cases(gen)
    for label, x in cases:
        v, s = quantize_pack_2d(x, block_r=x.shape[0])
        rv, rs = quantize_pack_reference(x)
        torch.cuda.synchronize()
        if not (v.dtype == torch.int8 and torch.equal(v, rv) and torch.equal(s, rs)):
            bad = (v.int() - rv.int()).abs().max().item()
            raise AssertionError(f"quant_pack mismatch ({label}, {tuple(x.shape)}): "
                                 f"max value diff {bad}, scales equal {torch.equal(s, rs)}")
    log(f"[kernel] quant_pack equals its plain version (values and scales) on "
        f"{len(cases)} small cases")

    # The compressed lane's shape: the (M·R, C) float32 x + residual of the
    # slice's M=4 bf16 replicas.
    group = slice_bus_group()
    rows = M_WORKERS * group.rows
    x = (torch.randn((rows, bus.LANE), generator=gen, device="cuda")
         * torch.rand((rows, 1), generator=gen, device="cuda"))
    v, s = quantize_pack_2d(x, block_r=group.block_r)
    rv, rs = quantize_pack_reference(x)
    torch.cuda.synchronize()
    equal = torch.equal(v, rv) and torch.equal(s, rs)
    err = (v.int() - rv.int()).abs().max().item() * rs.max().item()
    del v, s, rv, rs
    if not equal:
        raise AssertionError(f"quant_pack mismatch at the lane's shape: max|err| {err}")
    log(f"[kernel] quant_pack at the lane's shape ({rows}, {bus.LANE}) float32: "
        f"values and scales equal to the plain version")
    ms = time_cuda(lambda: quantize_pack_2d(x, block_r=group.block_r), iters=20)
    plain_ms = time_cuda(lambda: quantize_pack_reference(x), iters=3, warmup=1)
    n = x.numel()
    moved = n * x.element_size() + n + rows * 4        # x in; values and scales out
    ops = 4 * n + 2 * rows    # |x|, max, divide, round per element; scale per row
    bound_ms, bound_by = _bound(moved, ops, card)
    log(f"[kernel] quant_pack {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del x
    torch.cuda.empty_cache()
    return {"name": "quant_pack", "route": "cuda",
            "source": "src/repro_torch/kernels/quant_pack/csrc/quant_pack.cu",
            "replaces": "src/repro/kernels/quant_pack/kernel.py:37",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def slice_config():
    from repro_torch.configs import get_config

    return get_config("granite-3-2b", n_layers=N_LAYERS)


def slice_bus_group():
    """The bus group (rows per worker, row block) of the slice's parameter
    tree, planned from its defs."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.models import model as Mo

    defs = Mo.model_defs(slice_config())
    meta = _tree.map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"), defs)
    return bus.plan_layout(meta, lead_ndim=0).groups[0]


def slice_setup(tag: str):
    """(params0, batcher, batches, loss, optimizer) of the slices: the same
    seeded weights and the same batch sequence at every call."""
    import torch

    from repro_torch.core import bus
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd

    cfg = slice_config()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params0 = replicate_for_workers(Mo.init(gen, cfg, device="cuda"), M_WORKERS)
    toks, _ = token_stream(S=M_WORKERS * PER_WORKER_BATCH * 8, seq_len=SEQ_LEN,
                           vocab=cfg.vocab_size, seed=0)
    batcher = WorkerBatcher((toks,), pad_to_equal(random_split(len(toks), M_WORKERS)),
                            batch_size=PER_WORKER_BATCH, seed=0)

    def batches():
        while True:
            yield {"tokens": batcher.next()[0]}

    layout = bus.plan_layout(params0)
    n = layout.payload_elements()
    log(f"[{tag}] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"{cfg.param_dtype}; {n:,} params per replica, {layout.groups[0].rows:,} bus rows, "
        f"padded_bytes {layout.padded_bytes():,}; set-up {time.perf_counter() - t0:.1f} s")
    return params0, batcher, batches, (lambda p, b: Mo.loss_fn(p, cfg, b)), momentum_sgd(LR, 0.9)


def _params_err(a, b) -> tuple[float, bool]:
    """(max |a − b| over the param trees, whether a is all finite)."""
    import torch

    from repro_torch import _tree

    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(_tree.leaves(a), _tree.leaves(b)))
    return err, all(bool(torch.isfinite(x).all()) for x in _tree.leaves(a))


def phase_slice() -> dict:
    import torch

    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.kernels.quant_pack import quantize_pack_2d
    from repro_torch.train import train

    params0, batcher, batches, loss, opt = slice_setup("slice")
    topo = T.undirected_ring(M_WORKERS)
    spec = GossipSpec(topology=topo, backend="fused")
    torch.cuda.reset_peak_memory_stats()
    gossip_mix_2d.launches = quantize_pack_2d.launches = 0
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    launches = {"gossip_mix": gossip_mix_2d.launches, "quant_pack": quantize_pack_2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0}:
        raise AssertionError(f"training launched {launches} in {STEPS} steps, "
                             f"want 1 gossip_mix per step")
    tokens = M_WORKERS * PER_WORKER_BATCH * SEQ_LEN
    step_s = hist.step_time[-1]
    log(f"[slice] losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice] gossip_mix launches {launches['gossip_mix']} in {STEPS} steps; step 0 (warm-up) "
        f"{hist.step_time[0] * 1e3:.1f} ms; steps 1-{STEPS - 1} {step_s * 1e3:.1f} ms/step, "
        f"{tokens / step_s:,.0f} tokens/s ({tokens} tokens/step); peak memory {peak_gb:.1f} GB")

    # one fused step vs one einsum step from the same state and batch
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    fused = make_train_step(loss, opt, gossip=spec)
    dense = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"))
    s_f, m_f = fused(state, batch)
    s_e, m_e = dense(state, batch)
    err, finite = _params_err(s_f.params, s_e.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"fused step vs einsum step: max|err|={err}, finite={finite}")
    log(f"[slice] fused step vs einsum step from the same state: params max|err| {err:.3g} "
        f"(bf16 tol {TOL['bfloat16']}); losses {m_f.loss.item():.4f} / {m_e.loss.item():.4f}")
    del s_e, m_e
    profile_call("one fused step", lambda: fused(s_f, batch))
    return {"launches": launches, "step_s": step_s, "tokens": tokens}


def phase_slice2(slice1: dict) -> dict:
    """Hierarchical training on hier(2, 2), then the compressed cross-pod
    lane on the trained params. Returns each kernel's launches by path."""
    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step
    from repro_torch.core.gossip import (GossipSpec, hierarchical_mix,
                                         hierarchical_mix_compressed, mix_pytree,
                                         split_hierarchical)
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.kernels.quant_pack import quantize_pack_2d
    from repro_torch.train import train

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[slice2] {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated after slice 1")
    params0, batcher, batches, loss, opt = slice_setup("slice2")
    topo = T.hier(2, 2)          # ring of 2 pods ⊗ clique of 2: the product is clique(4)
    spec = GossipSpec(topology=topo, backend="fused", hierarchical=True)
    torch.cuda.reset_peak_memory_stats()
    gossip_mix_2d.launches = quantize_pack_2d.launches = 0
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    train_launches = {"gossip_mix": gossip_mix_2d.launches,
                      "quant_pack": quantize_pack_2d.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params0
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if train_launches != {"gossip_mix": 2 * STEPS, "quant_pack": 0}:
        raise AssertionError(f"hierarchical training launched {train_launches} in "
                             f"{STEPS} steps, want 2 gossip_mix per step")
    step_s = hist.step_time[-1]
    tokens = slice1["tokens"]
    log(f"[slice2] {topo.name}: losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice2] gossip_mix launches {train_launches['gossip_mix']} in {STEPS} steps; "
        f"step 0 (warm-up) {hist.step_time[0] * 1e3:.1f} ms; steps 1-{STEPS - 1} "
        f"{step_s * 1e3:.1f} ms/step, {tokens / step_s:,.0f} tokens/s (slice 1: "
        f"{slice1['step_s'] * 1e3:.1f} ms/step, {tokens / slice1['step_s']:,.0f} tokens/s); "
        f"peak memory {peak_gb:.1f} GB")

    # one hierarchical step vs one einsum step on the unsplit matrix
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    hier_step = make_train_step(loss, opt, gossip=spec)
    dense = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"))
    s_h, m_h = hier_step(state, batch)
    s_e, m_e = dense(state, batch)
    err, finite = _params_err(s_h.params, s_e.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"hierarchical step vs einsum step: max|err|={err}, "
                             f"finite={finite}")
    log(f"[slice2] hierarchical step vs einsum step from the same state: params max|err| "
        f"{err:.3g} (bf16 tol {TOL['bfloat16']}); losses {m_h.loss.item():.4f} / "
        f"{m_e.loss.item():.4f}")
    del s_e, m_e, s_h, m_h
    profile_call("one hierarchical step", lambda: hier_step(state, batch))
    params = state.params
    del state, batch
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[slice2] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the "
        f"compressed lane (the trained params are "
        f"{sum(x.numel() * x.element_size() for x in _tree.leaves(params)) / 1e9:.2f} GB)")

    # the compressed cross-pod lane: exact intra-pod mix, int8 cross-pod wire
    intra, inter = split_hierarchical(GossipSpec(topology=topo, backend="fused"))
    exact = hierarchical_mix(params, intra, inter)
    amax = max(x.abs().max().item() for x in _tree.leaves(mix_pytree(params, intra)))
    torch.cuda.synchronize()
    gossip_mix_2d.launches = quantize_pack_2d.launches = 0
    x, res, round_ms, peak = params, None, [], 0
    for r in range(DCI_ROUNDS):
        torch.cuda.reset_peak_memory_stats()    # the round alone, not its checks
        t0 = time.perf_counter()
        x, res = hierarchical_mix_compressed(x, intra, inter, dci_dtype="int8", residual=res)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        if (gossip_mix_2d.launches, quantize_pack_2d.launches) != (r + 1, r + 1):
            raise AssertionError(f"round {r}: {gossip_mix_2d.launches} gossip_mix and "
                                 f"{quantize_pack_2d.launches} quant_pack launches, "
                                 f"want {r + 1} each")
        if not all(bool(torch.isfinite(t).all()) for t in _tree.leaves(x)):
            raise AssertionError(f"round {r}: non-finite params")
        if r == 0:
            check_round1(x, exact, amax)
            del exact
    lane_launches = {"gossip_mix": gossip_mix_2d.launches,
                     "quant_pack": quantize_pack_2d.launches}
    steady = round_ms[1:]
    log(f"[slice2] {DCI_ROUNDS} compressed rounds, launches {lane_launches}; round 0 "
        f"{round_ms[0]:.1f} ms, rounds 1-{DCI_ROUNDS - 1} {sum(steady) / len(steady):.1f} "
        f"ms/round (min {min(steady):.1f}, max {max(steady):.1f}); peak memory of a "
        f"round {peak / 1e9:.1f} GB; residual norm "
        f"{math.sqrt(sum(r.float().pow(2).sum().item() for r in res if r is not None)):.4g}")
    profile_call("one compressed round", lambda: hierarchical_mix_compressed(
        x, intra, inter, dci_dtype="int8", residual=res))
    return {"slice2_hier_train": train_launches, "slice2_compressed": lane_launches}


def check_round1(got, exact, amax: float) -> None:
    """Round 1 of the int8 lane against the exact two-stage mix: every
    element within half the largest row scale (amax/127) plus one bf16 ulp
    of the value (the two casts to bf16 round apart)."""
    from repro_torch import _tree

    half_scale = 0.5 * amax / 127 * (1 + 1e-5)   # float32 rounding of deq and the sums
    worst = 0.0
    for g, e in zip(_tree.leaves(got), _tree.leaves(exact)):
        diff = (g.float() - e.float()).abs()
        ulp = 2.0 ** -7 * g.float().abs().maximum(e.float().abs())
        excess = (diff - half_scale - ulp).max().item()
        if excess > 0:
            raise AssertionError(f"round 1 off the exact mix by {excess:.3g} beyond "
                                 f"half the largest row scale {half_scale:.3g} + 1 ulp")
        worst = max(worst, diff.max().item())
    log(f"[slice2] round 1 vs exact hierarchical_mix: max|err| {worst:.4g} "
        f"(bound: half the largest row scale {half_scale:.4g} + 1 bf16 ulp)")


def profile_call(label: str, fn) -> None:
    """Device time of one call of ``fn`` by kernel (torch.profiler, CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        log("[profile] device time: not measured (the profiler saw no device kernels)")
        return
    log(f"[profile] {label}: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
        f"(under the profiler)")
    by_kind: dict[str, float] = {}
    for name, ms, _ in rows:
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {ms:8.2f} ms {100 * ms / busy:5.1f}%  {kind}")
    for name, ms, count in rows[:8]:
        log(f"[profile]   top: {ms:8.2f} ms x{count:<4d} {name[:100]}")


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "gossip_mix" in n:
        return "gossip_mix kernel (bus mix + update)"
    if "quant_pack" in n:
        return "quant_pack kernel (int8 wire)"
    if "indexselect" in n or "index_elementwise" in n:
        return "neighbour gather x[perm] (bus)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if "copy" in n:
        return "copies and casts (incl. bus pack)"
    return "other elementwise and reductions"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_device()
    phase_build()
    card = torch.cuda.get_device_name(0)
    entries = [phase_kernel_check(card), phase_quant_check(card)]
    slice1 = phase_slice()
    by_path = {"slice1_train": slice1["launches"]}
    by_path.update(phase_slice2(slice1))
    for e in entries:
        e["launches_by_path"] = {path: n[e["name"]] for path, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was never launched on the paths")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
