#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``src/repro_torch``; nothing of JAX or of the JAX package)
through these phases, in order, and exits non-zero at the first failure:

1. device — needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. build — compiles every kernel of the paths below from the sources in this
   checkout (``nvcc``, ``sm_90a``), one compiler per source, all started
   together, and prints the build time, each kernel's registers and spills
   (``ptxas -v``) and the count of ``HGMMA`` instructions in the
   flash_attention library's SASS (``cuobjdump``): none fails the run, as
   the bf16 route must run on the tensor cores.
3. kernel check — holds each kernel against its plain PyTorch version on the
   card at small and odd shapes and at the shapes its paths give it (for
   gossip_mix: k=2 for the ring, k=1 for the one-peer ring), then times
   kernel and plain version with CUDA events. gossip_mix: float32 atol
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
6. checkpoint — ``export_consensus`` of slice 1's trained worker-stacked
   params to an npz under ``build/``; ``load_consensus_params`` of it must
   equal ``consensus_params`` of the in-memory params bit for bit.
7. slice 5 — the same model and batches on the one-peer time-varying ring
   (``GossipSpec(time_varying="one_peer_exp")``, M=4): 5 ``train()``
   steps of ``momentum_sgd(warmup_cosine(0.01, 2, 5), 0.9)`` with
   worker-sharded asynchronous checkpoints every 2 steps, exactly one k=1
   gossip_mix launch per step; the shards restore to the trained params bit
   for bit, and ``consensus_from_sharded`` and ``load_consensus_params`` of
   them equal ``consensus_params`` bit for bit. Then a fused one-peer step
   at an even and at an odd step against an einsum step on that round's
   dense matrix, a ``microbatch=2`` momentum step against ``microbatch=1``
   (both within the bf16 tolerance), 2 Adam steps and 1 Adafactor step at
   ``microbatch=2`` (finite losses), and ``survivor_mix`` /
   ``survivor_hierarchical_mix`` with a dead worker (its slice bit-equal to
   its input, the live ones within the bf16 tolerance of a float32 einsum
   with the repaired matrices). Prints ms/step with and without a
   checkpoint in flight, the writer's seconds and each part's peak memory.
8. slice 3 — serving granite-3-2b at its published widths and full depth
   (40 layers, bf16, seeded random weights): a ``WaveBatcher`` with 4 slots
   serves 8 requests of a 3072-token prompt and 128 new tokens. Checks
   exactly one flash_attention launch per layer in each wave's prefill,
   finite logprobs, and that one wave's last-position prefill logits
   through the kernel agree with the same prefill through the training
   path's ``blockwise_attention``; times prefill and decode, reads peak
   memory and profiles one prefill and one decode step; the profiled
   prefill must run the wgmma kernel once per layer and never the float32
   one.
9. report — one JSON line of kernels, the nvidia-smi line, and last the
   ``{"ok": true, ...}`` line.

The flash_attention kernel check (phase 3) uses the reference's
kernel-test tolerances, float32 atol 2e-5 and bf16 3e-2, and holds bf16
besides to one bf16 ulp of the plain value plus 1e-4, element by element;
at the serving prefill's shape it runs both dtypes, each on its own kernel
(bf16: wgmma tensor cores and TMA; float32: CUDA cores), and prints each
one's time and TFLOP/s.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
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
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SERVE_SLOTS = 4         # slice 3: WaveBatcher slots
SERVE_REQUESTS = 8
PROMPT_LEN = 3072       # a multiple of blockwise_attention's 1024 chunk
NEW_TOKENS = 128
SERVE_MAX_LEN = PROMPT_LEN + NEW_TOKENS   # inside granite's 4096 context

# Device-memory rates (bytes/s) from NVIDIA's data sheets, by card name
# (first match wins), and the H100's float32 rate outside the tensor cores.
MEMORY_RATES = (("H200", 4.8e12), ("H100 NVL", 3.9e12), ("H100 PCIe", 2.0e12),
                ("H100", 3.35e12))
F32_PEAK = 67e12
BF16_PEAK = 989e12      # dense tensor-core rate


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


def _kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; a wrapper counts its launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.kernels.quant_pack import quantize_pack_2d

    return {"gossip_mix": gossip_mix_2d, "quant_pack": quantize_pack_2d,
            "flash_attention": flash_attention}


def reset_launches() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


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
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gossip_mix import kernel as gm
    from repro_torch.kernels.quant_pack import kernel as qp

    t0 = time.perf_counter()
    mods = (gm, qp, fa)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:   # nvcc runs outside the GIL
        built = list(pool.map(lambda m: (m, m.library()[1]), mods))
    log(f"[build] {len(built)} kernels built in {time.perf_counter() - t0:.2f} s")
    for mod, build_log in built:
        log(f"[build]   {os.path.relpath(mod.SOURCE, ROOT)}")
        for kernel, regs, spills in _ptxas_usage(build_log):
            log(f"[build]     {kernel}: {regs} registers, spills {spills}")
    # the bf16 route must issue wgmma: count HGMMA in the library's SASS
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(_build.library_path("flash_attention", fa.SOURCE))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"[build] flash_attention library: {n_hgmma} HGMMA instructions in its SASS "
        f"(cuobjdump --dump-sass)")
    if n_hgmma == 0:
        raise AssertionError("the flash_attention library issues no HGMMA: the bf16 route "
                             "is not on the tensor cores")


def _ptxas_usage(build_log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spill stores/loads) per entry function that
    ``ptxas -v`` reports; the name is the mangled one's kernel identifier
    and template argument."""
    out, kernel, spills = [], "?", "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            names, i = [], 0
            while i < len(mangled):      # length-prefixed identifiers of the mangled name
                m = re.match(r"\d+", mangled[i:])
                if m:
                    n, i = int(m.group()), i + m.end()
                    names.append(mangled[i:i + n])
                    i += n
                else:
                    i += 1
            kernel = next((w for w in names if "kernel" in w),
                          next((w for w in names if not w.startswith("_GLOBAL")), mangled))
            arg = re.search(r"ILi(\d+)E", mangled)
            kernel += f"<{arg.group(1)}>" if arg else ""
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[1]
        elif "Used" in line and "registers" in line:
            out.append((kernel, line.split("Used ")[1].split()[0], spills))
    return out


def _mix_inputs(rows, cols, k, w_dtype, u_dtype, gen):
    import torch

    w = torch.randn((rows, cols), generator=gen, device="cuda").to(w_dtype)
    nbr = torch.randn((k, rows, cols), generator=gen, device="cuda").to(w_dtype)
    wts = torch.softmax(torch.randn(k + 1, generator=gen, device="cuda"), 0).cpu().numpy()
    u = None if u_dtype is None else torch.randn(
        (rows, cols), generator=gen, device="cuda").to(u_dtype)
    return w, nbr, wts, u


def _bound(moved: float, ops: float, card: str, peak: float = F32_PEAK) -> tuple[float, str]:
    """Least time (ms) for ``moved`` bytes and ``ops`` operations at the
    ``peak`` rate of their type, and which of the two bounds it."""
    t_bytes, t_ops = moved / memory_rate(card), ops / peak
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

    # Slice 5's shape: the same rows, one one-peer neighbour (k=1).
    w, nbr, wts, u = _mix_inputs(rows, bus.LANE, 1, bf16, bf16, gen)
    out = gossip_mix_2d(w, nbr, wts, u, -1.0)
    ref = gossip_mix_reference(w, nbr, wts, u, -1.0)
    torch.cuda.synchronize()
    err1 = (out.float() - ref.float()).abs().max().item()
    del out, ref
    if err1 > TOL["bfloat16"]:
        raise AssertionError(f"gossip_mix mismatch at the one-peer shape: {err1}")
    ms1 = time_cuda(lambda: gossip_mix_2d(w, nbr, wts, u, -1.0), iters=20)
    plain_ms1 = time_cuda(lambda: gossip_mix_reference(w, nbr, wts, u, -1.0), iters=3, warmup=1)
    moved1 = n * w.element_size() * (1 + 1 + 1) + n * u.element_size()  # w, 1 nbr, out + u
    bound_ms1, bound_by1 = _bound(moved1, n * (2 * 1 + 3), card)
    log(f"[kernel] gossip_mix at the one-peer shape ({rows}, {bus.LANE}) bf16 k=1: max|err| "
        f"{err1:.3g} vs plain version; {ms1:.3f} ms (bound {bound_ms1:.3f} ms by {bound_by1}, "
        f"{moved1 / ms1 / 1e6:.0f} GB/s); plain version {plain_ms1:.3f} ms")
    del w, nbr, u
    torch.cuda.empty_cache()
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:45",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "k1_max_abs_err": err1, "k1_ms": ms1, "k1_plain_ms": plain_ms1,
            "k1_bound_ms": bound_ms1, "k1_bound_by": bound_by1}


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

# (B, Lq, Lkv, H, Hkv, hd, causal, window): the reference's FLASH_CASES
# (tests/test_kernels.py), then lengths off the 64-row tile, Lq != Lkv, a
# window smaller than a tile, MQA, rows past Lkv + window - 1.
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 1, 32, True, 64),
    (2, 128, 128, 4, 4, 64, False, None),
    (1, 64, 64, 2, 2, 128, True, None),
    (1, 128, 128, 4, 2, 16, True, 32),
    (2, 333, 333, 8, 2, 64, True, None),
    (1, 100, 100, 4, 2, 16, True, None),
    (1, 70, 150, 4, 1, 32, True, None),
    (1, 150, 70, 4, 2, 32, True, None),
    (1, 200, 200, 2, 2, 16, True, 5),
    (1, 130, 130, 4, 1, 128, False, 17),
    (1, 150, 70, 4, 2, 32, True, 5),      # rows no key reaches: the mean of v
    (1, 200, 130, 2, 1, 64, False, 40),
]


def _attn_inputs(B, Lq, Lkv, H, Hkv, hd, dtype, gen):
    """q, k, v in the model's (B, L, H, hd) layout, as the (B, H, L, hd)
    views ops.attention hands the kernel."""
    import torch

    q = torch.randn((B, Lq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Lkv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Lkv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _flash_err(out, ref, dtype, case) -> float:
    """max|err| of the kernel's output against its plain version; raises
    past FLASH_TOL, and for bf16 where an element is off by more than one
    bf16 ulp of the plain value (2^-7·|ref|) plus 1e-4. Both sides round a
    float32 result once to bf16, so they may differ by that rounding only;
    a fixed atol would be as large as a typical output of a long causal row
    (|o| ~ sqrt(e/i) at row i)."""
    import torch

    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = 0.0
    if dtype == torch.bfloat16:
        excess = (diff - 2.0 ** -7 * ref.float().abs() - 1e-4).max().item()
    tol = FLASH_TOL[str(dtype).split(".")[1]]
    if out.dtype != dtype or err > tol or excess > 0:
        raise AssertionError(
            f"flash_attention mismatch {dtype} (B, Lq, Lkv, H, Hkv, hd, causal, window)="
            f"{case}: max|err| {err} (tol {tol}), {excess} past 1 bf16 ulp + 1e-4")
    return err


def phase_flash_check(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_reference, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lkv, H, Hkv, hd, causal, window in FLASH_CASES:
            q, k, v = _attn_inputs(B, Lq, Lkv, H, Hkv, hd, dtype, gen)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_reference(q, k, v, causal=causal, window=window)
            err = _flash_err(out, ref, dtype, (B, Lq, Lkv, H, Hkv, hd, causal, window))
            worst[dtype] = max(worst.get(dtype, 0.0), err)
    log(f"[kernel] flash_attention matches its plain version on {len(FLASH_CASES)} cases "
        f"x 2 dtypes (max|err| float32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g})")

    # The serving slice's prefill: granite-3-2b, B = SERVE_SLOTS, L = PROMPT_LEN.
    cfg = serve_config()
    B, L, H, Hkv, hd = SERVE_SLOTS, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _attn_inputs(B, L, L, H, Hkv, hd, torch.bfloat16, gen)
    shape = (B, L, L, H, Hkv, hd, True, None)
    # float32 first: the CUDA-core route held to 2e-5 on rows of up to 3072
    # keys, where a bf16 tolerance would hide a lost kv tile; then bf16, the
    # wgmma route, with the same inputs rounded to bf16
    q32, k32, v32 = q.float(), k.float(), v.float()
    err32 = _flash_err(flash_attention(q32, k32, v32, causal=True),
                       attention_reference(q32, k32, v32, causal=True), torch.float32, shape)
    err = _flash_err(flash_attention(q, k, v, causal=True),
                     attention_reference(q, k, v, causal=True), torch.bfloat16, shape)
    log(f"[kernel] flash_attention at the prefill shape q {(B, L, H, hd)} k/v "
        f"{(B, L, Hkv, hd)} causal vs plain version: max|err| float32 {err32:.3g}, "
        f"bf16 {err:.3g}")
    ops = 4 * B * H * hd * (L * (L + 1) // 2)   # q·k and p·v over the causal pairs
    ms32 = time_cuda(lambda: flash_attention(q32, k32, v32, causal=True), iters=5)
    del q32, k32, v32
    torch.cuda.empty_cache()
    ms = time_cuda(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = time_cuda(lambda: attention_reference(q, k, v, causal=True), iters=3, warmup=1)
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=20)
    moved = 2 * q.numel() * q.element_size() + 2 * k.numel() * k.element_size()  # q, k, v in; o out
    bound_ms, bound_by = _bound(moved, ops, card, peak=BF16_PEAK)
    log(f"[kernel] flash_attention bf16 (wgmma) {ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s "
        f"(bound {bound_ms:.3f} ms by {bound_by}; it issues 1.5x these FLOP on the tensor "
        f"cores, P·V twice for the split P); float32 (CUDA cores) {ms32:.3f} ms, "
        f"{ops / ms32 / 1e9:.1f} TFLOP/s; plain version {plain_ms:.3f} ms; "
        f"scaled_dot_product_attention {library_ms:.3f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "float32_ms": ms32}


def slice_config():
    from repro_torch.configs import get_config

    return get_config("granite-3-2b", n_layers=N_LAYERS)


def serve_config():
    """granite-3-2b at its published widths and full depth (slice 3)."""
    from repro_torch.configs import get_config

    return get_config("granite-3-2b")


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
    from repro_torch.train import train

    params0, batcher, batches, loss, opt = slice_setup("slice")
    topo = T.undirected_ring(M_WORKERS)
    spec = GossipSpec(topology=topo, backend="fused")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0}:
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
    return {"launches": launches, "step_s": step_s, "tokens": tokens, "params": state.params}


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
    reset_launches()
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    train_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params0
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if train_launches != {"gossip_mix": 2 * STEPS, "quant_pack": 0, "flash_attention": 0}:
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
    reset_launches()
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
    lane_launches = read_launches()
    if lane_launches["flash_attention"]:
        raise AssertionError(f"the compressed lane launched {lane_launches}")
    steady = round_ms[1:]
    log(f"[slice2] {DCI_ROUNDS} compressed rounds, launches {lane_launches}; round 0 "
        f"{round_ms[0]:.1f} ms, rounds 1-{DCI_ROUNDS - 1} {sum(steady) / len(steady):.1f} "
        f"ms/round (min {min(steady):.1f}, max {max(steady):.1f}); peak memory of a "
        f"round {peak / 1e9:.1f} GB; residual norm "
        f"{math.sqrt(sum(r.float().pow(2).sum().item() for r in res if r is not None)):.4g}")
    profile_call("one compressed round", lambda: hierarchical_mix_compressed(
        x, intra, inter, dci_dtype="int8", residual=res))
    return {"slice2_hier_train": train_launches, "slice2_compressed": lane_launches}


def phase_slice5(slice1: dict) -> dict:
    """Slice 5: one-peer time-varying training with worker-sharded
    asynchronous checkpoints; both one-peer rounds against the dense
    matrix; gradient accumulation with momentum, Adam and Adafactor;
    survivor mixing. Returns the training run's launches."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec, survivor_hierarchical_mix, survivor_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.optim import adafactor_like, adam, momentum_sgd, warmup_cosine
    from repro_torch.serving import load_consensus_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train

    def fresh(label: str) -> float:
        """Collect, reset the peak, and return the GB still allocated."""
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gb = torch.cuda.memory_allocated() / 1e9
        log(f"[slice5] {gb:.2f} GB allocated before {label}")
        return gb

    fresh("slice 5")
    params0, batcher, batches, loss, _ = slice_setup("slice5")
    spec = GossipSpec(topology=T.undirected_ring(M_WORKERS), backend="fused",
                      time_varying="one_peer_exp")
    opt = momentum_sgd(warmup_cosine(LR, 2, STEPS), 0.9)

    # 1. train() with worker-sharded asynchronous checkpoints every 2 steps
    path = os.path.join(ROOT, "build", "chip_smoke", "slice5_ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for f in os.listdir(os.path.dirname(path)):
        if f.startswith("slice5_ckpt."):      # files of an earlier run
            os.remove(os.path.join(os.path.dirname(path), f))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gossip_mix_2d.launches_by_k = {}
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, ckpt_path=path, ckpt_every=2, ckpt_sharded=True,
                        device="cuda", verbose=False)
    launches, by_k = read_launches(), dict(gossip_mix_2d.launches_by_k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params0
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0} \
            or by_k != {1: STEPS}:
        raise AssertionError(f"one-peer training launched {launches} (by neighbour count "
                             f"{by_k}) in {STEPS} steps, want one k=1 gossip_mix per step")
    if ckpt.latest_step(path) != STEPS or len(hist.ckpt_write_s) != 3:
        raise AssertionError(f"checkpoint at step {ckpt.latest_step(path)}, "
                             f"{len(hist.ckpt_write_s)} writes; want step {STEPS}, 3 writes")
    st = [x * 1e3 for x in hist.step_time]
    log(f"[slice5] one-peer ring: losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice5] gossip_mix launches {launches['gossip_mix']} in {STEPS} steps, by neighbour "
        f"count {by_k}; step 0 (warm-up) {st[0]:.1f} ms; step 1 (no checkpoint in flight) "
        f"{st[1]:.1f} ms; steps 2-3 (after the step-2 snapshot, its write in flight) "
        f"{st[2]:.1f} ms/step; step 4 (after the step-4 snapshot) {st[4]:.1f} ms; slice 1 "
        f"{slice1['step_s'] * 1e3:.1f} ms/step; peak memory {peak_gb:.1f} GB")
    log(f"[slice5] checkpoints after steps 2, 4, 5: writer-thread seconds "
        f"{[round(x, 2) for x in hist.ckpt_write_s]} (device-to-host copy of each worker's "
        f"slice and its npz)")

    t0 = time.perf_counter()
    back = ckpt.restore_sharded(path, state.params, device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(_tree.leaves(back), _tree.leaves(state.params)))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    del back
    want = ckpt.consensus_params(state.params)
    single = _tree.map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                       state.params)
    t0 = time.perf_counter()
    from_shards = ckpt.consensus_from_sharded(path, single, device="cuda")
    torch.cuda.synchronize()
    t_cons = time.perf_counter() - t0
    loaded = load_consensus_params(path, slice_config(), device="cuda")
    for label, got in (("consensus_from_sharded", from_shards),
                       ("load_consensus_params", loaded)):
        pairs = list(zip(_tree.leaves(got), _tree.leaves(want)))
        if len(pairs) != len(_tree.leaves(want)) or any(
                a.dtype != b.dtype or not torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{label} of the sharded checkpoint differs from "
                                 f"consensus_params of the trained params")
    if bad:
        raise AssertionError(f"restore_sharded differs from the trained params at leaves {bad}")
    size = sum(os.path.getsize(f"{path}.shard-w{j}.npz") for j in range(M_WORKERS))
    for j in range(M_WORKERS):
        os.remove(f"{path}.shard-w{j}.npz")
    os.remove(path + ".meta.json")
    del from_shards, loaded, want
    log(f"[slice5] latest_step {STEPS}; {M_WORKERS} shards, {size / 1e9:.2f} GB; "
        f"restore_sharded {t_restore:.1f} s, equal to the trained params bit for bit; "
        f"consensus_from_sharded {t_cons:.1f} s and load_consensus_params both equal to "
        f"consensus_params bit for bit")

    # 2. both one-peer rounds against an einsum step on the round's dense matrix
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    fused = make_train_step(loss, opt, gossip=spec)
    for step in (STEPS + 1, STEPS):        # an even round, then an odd one
        at = state._replace(step=step)
        gossip_mix_2d.launches_by_k = {}
        s_f, m_f = fused(at, batch)
        k_f = dict(gossip_mix_2d.launches_by_k)
        dense = make_train_step(loss, opt, gossip=GossipSpec(
            topology=T.one_peer_exponential(M_WORKERS, step % 2), backend="einsum"))
        s_e, m_e = dense(at, batch)
        err, finite = _params_err(s_f.params, s_e.params)
        if k_f != {1: 1} or not finite or err > TOL["bfloat16"]:
            raise AssertionError(f"one-peer step {step}: launches by k {k_f}, vs einsum "
                                 f"max|err| {err}, finite {finite}")
        log(f"[slice5] step {step} (round {step % 2}, offset {1 << (step % 2)}): fused "
            f"one-peer step vs einsum step on one_peer_exponential({M_WORKERS}, {step % 2}).A: "
            f"params max|err| {err:.3g} (bf16 tol {TOL['bfloat16']}), one k=1 launch; "
            f"losses {m_f.loss.item():.4f} / {m_e.loss.item():.4f}")
        del s_f, m_f, s_e, m_e
    profile_call("one fused one-peer step", lambda: fused(state, batch))

    # 3. gradient accumulation: microbatch=2 against microbatch=1, then Adam
    # and Adafactor at microbatch=2 (finite losses)
    base = fresh("the microbatch=1 step")
    s1, m1 = fused(state, batch)
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    gc.collect()                     # the step's reference cycles, not s1
    torch.cuda.reset_peak_memory_stats()
    base2 = torch.cuda.memory_allocated() / 1e9
    s2, m2 = make_train_step(loss, opt, gossip=spec, microbatch=2)(state, batch)
    torch.cuda.synchronize()
    peak2 = torch.cuda.max_memory_allocated() / 1e9
    err, finite = _params_err(s2.params, s1.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"microbatch=2 vs microbatch=1: max|err| {err}, finite {finite}")
    log(f"[slice5] momentum step, microbatch=2 vs 1 from the same state and batch: params "
        f"max|err| {err:.3g} (bf16 tol {TOL['bfloat16']}); losses {m2.loss.item():.4f} / "
        f"{m1.loss.item():.4f}; peaks {peak1:.1f} GB (microbatch=1, {base:.1f} GB before) "
        f"and {peak2:.1f} GB (microbatch=2, {base2:.1f} GB before)")
    params = state.params
    del s1, m1, s2, m2, state, batch
    for name, make_opt, n_steps in (
            ("adam(warmup_cosine(1e-4, 1, 2))", lambda: adam(warmup_cosine(1e-4, 1, 2)), 2),
            ("adafactor_like(1e-4)", lambda: adafactor_like(1e-4), 1)):
        base = fresh(name)
        o = make_opt()
        step_fn = make_train_step(loss, o, gossip=spec, microbatch=2)
        st_o = init_state(params, o)
        losses, t0 = [], time.perf_counter()
        for _ in range(n_steps):
            st_o, m = step_fn(st_o, to_device({"tokens": batcher.next()[0]}, "cuda"))
            losses.append(m.loss.item())
        dt = (time.perf_counter() - t0) / n_steps
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(x).all()) for x in _tree.leaves(st_o.params))
        del st_o, m, step_fn, o
        if not finite:
            raise AssertionError(f"{name} at microbatch=2: losses {losses}, params finite "
                                 f"{finite}")
        log(f"[slice5] {name}, microbatch=2: {n_steps} steps, losses "
            f"{[round(x, 4) for x in losses]}, {dt * 1e3:.1f} ms/step (host clock, incl. the "
            f"first step); peak {peak:.1f} GB ({base:.1f} GB before)")

    # 4. survivor mixing on the trained params
    fresh("survivor mixing")
    cases = (("survivor_mix", T.undirected_ring(M_WORKERS), np.array([1, 1, 0, 1], bool)),
             ("survivor_hierarchical_mix", T.hier(2, 2), np.array([1, 1, 1, 0], bool)))
    for name, topo, alive in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "survivor_mix":
            mixed = survivor_mix(params, topo, alive)
            stages = [T.survivor_matrix(topo.A, alive)]
        else:
            mixed = survivor_hierarchical_mix(params, topo, alive)
            stages = list(T.repair_hier_stages(topo, alive))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mats = [torch.as_tensor(A, dtype=torch.float32, device="cuda") for A in stages]
        dead, live = np.nonzero(~alive)[0].tolist(), np.nonzero(alive)[0].tolist()
        worst = 0.0
        for x, y in zip(_tree.leaves(params), _tree.leaves(mixed)):
            if any(not torch.equal(y[j], x[j]) for j in dead):
                raise AssertionError(f"{name}: a dead worker's slice changed")
            ref = x.float()
            for A in mats:
                ref = torch.einsum("im,i...->m...", A, ref)
            worst = max(worst, (y[live].float() - ref[live]).abs().max().item())
            del ref
        del mixed
        if worst > TOL["bfloat16"]:
            raise AssertionError(f"{name}: live workers {worst} off the float32 einsum")
        log(f"[slice5] {name} on {topo.name}, alive {alive.astype(int).tolist()}: dead slice "
            f"bit-equal to its input, live workers max|err| {worst:.3g} vs the float32 einsum "
            f"with the repaired matri{'x' if len(mats) == 1 else 'ces'} (bf16 tol "
            f"{TOL['bfloat16']}); {ms:.1f} ms")
    del params
    return {"launches": launches}


def phase_checkpoint(params_M) -> None:
    """export_consensus of slice 1's worker-stacked params, then
    load_consensus_params of the file, bit for bit against
    consensus_params of the in-memory params."""
    import torch

    from repro_torch import _tree
    from repro_torch.serving import load_consensus_params
    from repro_torch.train import checkpoint as ckpt

    path = os.path.join(ROOT, "build", "chip_smoke", "slice1_consensus.npz")
    t0 = time.perf_counter()
    ckpt.export_consensus(params_M, dst=path, step=STEPS)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_consensus_params(path, slice_config(), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    want = ckpt.consensus_params(params_M)
    pairs = list(zip(_tree.flatten_with_path(loaded), _tree.leaves(want)))
    bad = ["/".join(map(str, p)) for (p, a), b in pairs
           if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]
    if bad or len(pairs) != len(_tree.leaves(want)):
        raise AssertionError(f"consensus checkpoint round trip differs at {bad[:5]}")
    size, step = os.path.getsize(path), ckpt.latest_step(path)
    os.remove(path)
    os.remove(path + ".meta.json")
    log(f"[checkpoint] export_consensus of {_tree.leaves(params_M)[0].shape[0]} stacked "
        f"workers → {size / 1e9:.2f} GB npz (step {step}) in {t_save:.1f} s; "
        f"load_consensus_params {t_load:.1f} s; {len(pairs)} leaves equal to "
        f"consensus_params bit for bit")


def phase_serve() -> dict:
    """Slice 3: the full-depth model served by WaveBatcher, then the
    prefill check against the blockwise route, timings and a profile."""
    import numpy as np
    import torch

    from repro_torch.data import token_stream
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.serving import WaveBatcher, generate, make_serve_step

    gc.collect()
    torch.cuda.empty_cache()
    log(f"[serve] {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated before slice 3")
    cfg = serve_config()
    t0 = time.perf_counter()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts, _ = token_stream(S=SERVE_REQUESTS, seq_len=PROMPT_LEN - 1,
                              vocab=cfg.vocab_size, seed=1)
    log(f"[serve] {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.param_dtype}: {count_params(Mo.model_defs(cfg)):,} params; "
        f"{SERVE_REQUESTS} requests of {PROMPT_LEN} prompt + {NEW_TOKENS} new tokens, "
        f"{SERVE_SLOTS} slots; set-up {time.perf_counter() - t0:.1f} s")

    # the user's path: WaveBatcher → generate → prefill (flash kernel) + decode
    wb = WaveBatcher(params, cfg, SERVE_SLOTS, SERVE_MAX_LEN)
    rids = [wb.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    wave_s = []
    while wb.queue:
        before = read_launches()
        t0 = time.perf_counter()
        wb.run_wave()
        wave_s.append(time.perf_counter() - t0)   # generate() ends in a host transfer
        n = read_launches()["flash_attention"] - before["flash_attention"]
        if n != cfg.n_layers:
            raise AssertionError(f"wave {len(wave_s)}: {n} flash_attention launches, "
                                 f"want one per layer ({cfg.n_layers})")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if sorted(wb.done) != rids or any(len(wb.done[r]) != NEW_TOKENS for r in rids):
        raise AssertionError("WaveBatcher did not serve every request in full")
    if launches["gossip_mix"] or launches["quant_pack"]:
        raise AssertionError(f"serving launched {launches}")
    new_tokens = SERVE_REQUESTS * NEW_TOKENS
    log(f"[serve] {len(wave_s)} waves, flash_attention launches {launches['flash_attention']} "
        f"({cfg.n_layers} per wave's prefill); wave wall {[round(x * 1e3, 1) for x in wave_s]} ms; "
        f"{new_tokens / sum(wave_s):,.1f} generated tokens/s end to end; peak memory "
        f"{peak_gb:.2f} GB")

    wave = prompts[:SERVE_SLOTS]
    with torch.no_grad():
        t0 = time.perf_counter()
        res = generate(params, cfg, wave, n_new=NEW_TOKENS)
        gen_s = time.perf_counter() - t0
        if not np.isfinite(res.logprobs).all():
            raise AssertionError("non-finite logprobs")
        if not all(np.array_equal(res.tokens[i], wb.done[rids[i]]) for i in range(SERVE_SLOTS)):
            raise AssertionError("generate() and WaveBatcher disagree on wave 1's tokens")
        log(f"[serve] wave 1 again through generate(): the same tokens, logprobs finite "
            f"(mean {res.logprobs.mean():.4f}), {gen_s * 1e3:.1f} ms")

        tok = torch.from_numpy(wave).cuda()
        prefill_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches = Mo.prefill(params, cfg, tok, max_len=SERVE_MAX_LEN)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        pf = sum(prefill_s) / len(prefill_s)
        # decode from generate()'s own runs: a run is one prefill and
        # NEW_TOKENS - 1 decode steps (the first wave also warms the caches'
        # allocations, so it is left out)
        runs = wave_s[1:] + [gen_s]
        step_s = sum((r - pf) / (NEW_TOKENS - 1) for r in runs) / len(runs)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        serve_step = make_serve_step(cfg)
        profile_call("one decode step", lambda: serve_step(params, caches, nxt))
        del caches
        log(f"[serve] prefill of a wave ({SERVE_SLOTS} x {PROMPT_LEN} tokens): "
            f"{[round(x * 1e3, 2) for x in prefill_s]} ms, mean {pf * 1e3:.2f} ms = time to "
            f"first token, {SERVE_SLOTS * PROMPT_LEN / pf:,.0f} prompt tokens/s; decode "
            f"{step_s * 1e3:.2f} ms/step ((run - prefill) / {NEW_TOKENS - 1} over "
            f"{len(runs)} generate() runs), {SERVE_SLOTS / step_s:,.1f} generated tokens/s")

        check_prefill(params, cfg, tok)
        rows = profile_call("one prefill wave", lambda: Mo.prefill(params, cfg, tok,
                                                                   max_len=SERVE_MAX_LEN))
        check_flash_route(rows, cfg.n_layers)
    del params
    return {"launches": launches}


def check_prefill(params, cfg, tok) -> None:
    """The wave's last-position prefill logits through the kernel (the
    serving route) against the same prefill through the training path's
    blockwise_attention, both bf16 on the card. Tolerance: twice the
    blockwise route's own distance from a float32 forward of the same
    weights (plus 1e-5 for float32 sums in another order). The two bf16
    routes round differently only inside attention, so a kernel as accurate
    as the blockwise route stays within it; a wrong kernel (mask, GQA head,
    tile edge) moves the logits by far more."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.models import model as Mo

    kernel = Mo.prefill(params, cfg, tok, max_len=SERVE_MAX_LEN)[0][:, -1]
    before = read_launches()["flash_attention"]
    h, _ = Mo.forward(params, cfg, tok)
    if read_launches()["flash_attention"] != before:
        raise AssertionError("the training path launched flash_attention")
    block = Mo.logits_from_hidden(params, cfg, h[:, -1:])[:, -1]
    del h
    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    p32 = _tree.map(lambda x: x.float(), params)
    h, _ = Mo.forward(p32, cfg32, tok)
    exact = Mo.logits_from_hidden(p32, cfg32, h[:, -1:])[:, -1]
    del h, p32
    e_kb = (kernel - block).abs().max().item()
    e_bf = (block - exact).abs().max().item()
    e_kf = (kernel - exact).abs().max().item()
    finite = bool(torch.isfinite(kernel).all())
    tol = 2 * e_bf + 1e-5
    log(f"[serve] last-position prefill logits (|logit| ≤ {exact.abs().max().item():.3f}): "
        f"kernel vs blockwise max|err| {e_kb:.4g} (tol {tol:.4g}); vs float32: "
        f"kernel {e_kf:.4g}, blockwise {e_bf:.4g}; argmax agree "
        f"{int((kernel.argmax(-1) == block.argmax(-1)).sum())}/{kernel.shape[0]}")
    if not finite or e_kb > tol:
        raise AssertionError(f"prefill through the kernel off the blockwise route: "
                             f"{e_kb} > {tol} (finite {finite})")


def check_flash_route(rows, n_layers: int) -> None:
    """The profiled bf16 prefill ran the wgmma kernel once per layer and
    never the float32 CUDA-core kernel."""
    flash = [(name, count) for name, _, count in rows if "flash_attention_fwd" in name]
    if not rows:
        log("[serve] flash_attention route of the prefill: not measured (no profile)")
        return
    launches = sum(count for _, count in flash)
    if launches != n_layers or any("wgmma" not in name for name, _ in flash):
        raise AssertionError(f"the bf16 prefill ran {flash}, want {n_layers} launches of "
                             f"the wgmma kernel and nothing else")
    log(f"[serve] the profiled prefill ran {launches} launches of {flash[0][0][:60]} and "
        f"none of the float32 kernel")


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


def profile_call(label: str, fn) -> list[tuple[str, float, int]]:
    """Device time of one call of ``fn`` by kernel (torch.profiler, CUPTI);
    returns (kernel name, device ms, launches) rows, none if the profiler saw
    no device kernels."""
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
        return []
    log(f"[profile] {label}: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
        f"(under the profiler), {sum(r[2] for r in rows)} kernel launches")
    by_kind: dict[str, float] = {}
    for name, ms, _ in rows:
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {ms:8.2f} ms {100 * ms / busy:5.1f}%  {kind}")
    for name, ms, count in rows[:8]:
        log(f"[profile]   top: {ms:8.2f} ms x{count:<4d} {name[:100]}")
    return rows


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "gossip_mix" in n:
        return "gossip_mix kernel (bus mix + update)"
    if "flash_attention_fwd" in n:
        return "flash_attention kernel (prefill attention)"
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
    entries = [phase_kernel_check(card), phase_quant_check(card), phase_flash_check(card)]
    slice1 = phase_slice()
    phase_checkpoint(slice1.pop("params"))
    by_path = {"slice1_train": slice1["launches"]}
    by_path.update(phase_slice2(slice1))
    by_path["slice5_train"] = phase_slice5(slice1)["launches"]
    by_path["slice3_serve"] = phase_serve()["launches"]
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
