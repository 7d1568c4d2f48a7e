#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``; nothing of JAX or of the JAX package)
through these phases, in order, and exits non-zero at the first failure:

1. device — needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. build — compiles every kernel of the main path from the sources in this
   checkout (``nvcc``, ``sm_90a``) and prints the build time.
3. kernel check — holds each kernel against its plain PyTorch version on the
   card (float32 atol 1e-5, bf16 atol 5e-2, the reference's kernel-test
   tolerances), at small and odd shapes and at the shape the main path gives
   it, then times kernel and plain version with CUDA events.
4. slice — ``repro_torch.train.loop.train``: the decentralized step of paper
   eq. (3) on granite-3-2b at its published widths, depth cut to 4 layers,
   M=4 workers on a ring, momentum SGD, the fused gossip bus. Checks finite
   losses, one gossip_mix launch per step, and that one fused step from the
   trained state matches the einsum-backend step within the bf16 tolerance.
5. report — one JSON line of kernels, the nvidia-smi line, and last the
   ``{"ok": true, ...}`` line.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

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

    t0 = time.perf_counter()
    _, build_log = gm.library()
    log(f"[build] gossip_mix built in {time.perf_counter() - t0:.2f} s from "
        f"{os.path.relpath(gm.SOURCE, ROOT)}")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build]   {line.strip()}")


def _mix_inputs(rows, cols, k, w_dtype, u_dtype, gen):
    import torch

    w = torch.randn((rows, cols), generator=gen, device="cuda").to(w_dtype)
    nbr = torch.randn((k, rows, cols), generator=gen, device="cuda").to(w_dtype)
    wts = torch.softmax(torch.randn(k + 1, generator=gen, device="cuda"), 0).cpu().numpy()
    u = None if u_dtype is None else torch.randn(
        (rows, cols), generator=gen, device="cuda").to(u_dtype)
    return w, nbr, wts, u


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
    rows = M_WORKERS * slice_bus_rows()
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
    bw = memory_rate(card)
    bound_ms = max(moved / bw, flops / F32_PEAK) * 1e3
    bound_by = "bytes" if moved / bw >= flops / F32_PEAK else "operations"
    log(f"[kernel] gossip_mix {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del w, nbr, u
    torch.cuda.empty_cache()
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:45",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


def slice_config():
    from repro_torch.configs import get_config

    return get_config("granite-3-2b", n_layers=N_LAYERS)


def slice_bus_rows() -> int:
    """Bus rows per worker of the slice's parameter tree (from its defs)."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.models import model as Mo

    defs = Mo.model_defs(slice_config())
    meta = _tree.map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"), defs)
    return bus.plan_layout(meta, lead_ndim=0).groups[0].rows


def phase_slice() -> int:
    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.core import bus
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step, replicate_for_workers
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import train

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
    log(f"[slice] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"{cfg.param_dtype}; {n:,} params per replica, {layout.groups[0].rows:,} bus rows, "
        f"padded_bytes {layout.padded_bytes():,}; set-up {time.perf_counter() - t0:.1f} s")

    topo = T.undirected_ring(M_WORKERS)
    spec = GossipSpec(topology=topo, backend="fused")
    opt = momentum_sgd(LR, 0.9)
    loss = lambda p, b: Mo.loss_fn(p, cfg, b)
    torch.cuda.reset_peak_memory_stats()
    gossip_mix_2d.launches = 0
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    launches = gossip_mix_2d.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != STEPS:
        raise AssertionError(f"{launches} gossip_mix launches in {STEPS} steps, want {STEPS}")
    tokens = M_WORKERS * PER_WORKER_BATCH * SEQ_LEN
    step_s = hist.step_time[-1]
    log(f"[slice] losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice] gossip_mix launches {launches} in {STEPS} steps; step 0 (warm-up) "
        f"{hist.step_time[0] * 1e3:.1f} ms; steps 1-{STEPS - 1} {step_s * 1e3:.1f} ms/step, "
        f"{tokens / step_s:,.0f} tokens/s ({tokens} tokens/step); peak memory {peak_gb:.1f} GB")

    # one fused step vs one einsum step from the same state and batch
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    fused = make_train_step(loss, opt, gossip=spec)
    dense = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"))
    s_f, m_f = fused(state, batch)
    s_e, m_e = dense(state, batch)
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(_tree.leaves(s_f.params), _tree.leaves(s_e.params)))
    finite = all(bool(torch.isfinite(x).all()) for x in _tree.leaves(s_f.params))
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"fused step vs einsum step: max|err|={err}, finite={finite}")
    log(f"[slice] fused step vs einsum step from the same state: params max|err| {err:.3g} "
        f"(bf16 tol {TOL['bfloat16']}); losses {m_f.loss.item():.4f} / {m_e.loss.item():.4f}")
    del s_e, m_e
    profile_step(fused, s_f, batch)
    return launches


def profile_step(step, state, batch) -> None:
    """Device time of one fused step by kernel (torch.profiler, CUPTI)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = step(state, batch)
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
    log(f"[profile] one fused step: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
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
    if "indexselect" in n:
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
    entry = phase_kernel_check(torch.cuda.get_device_name(0))
    entry["launches"] = phase_slice()
    log(json.dumps({"kernels": [entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
