"""Wrapper of the flash-attention forward kernels (``csrc/flash_attention.cu``).

:func:`flash_attention` computes blockwise online-softmax attention with
causal and sliding-window masks and GQA, the port of the Pallas TPU kernel
``repro/kernels/flash_attention/kernel.py:flash_attention``, in its layout:
q (B, H, Lq, hd), k/v (B, Hkv, Lkv, hd). For CPU tensors it runs the plain
version (:mod:`.ref`); for CUDA tensors it launches a CUDA kernel, built at
first call, or raises. The dtype picks the kernel, one for each:

* bfloat16: ``csrc/flash_attention_bf16.cuh``, wgmma tensor cores on bf16
  tiles that TMA copies into shared memory, 128 q rows by 128 kv rows (64
  kv rows at head dims 192 and 256, so that the tiles fit shared memory);
* float32: the CUDA-core kernel in ``csrc/flash_attention.cu``, 64 by 64
  (the reference's float32 tolerance, 2e-5, rules out TF32 tensor cores).

Both take the head dims in ``HEAD_DIMS``: those of granite (64), the
dense variants and mixtral (128), nemotron (192) and gemma (256), and the
smaller ones of the reduced test configs.

Nothing falls back from one route to another: a failed build or launch
raises. For ``meta`` tensors (a dry run, ``launch.dryrun``) the wrapper
takes the card's route as far as the launch: the same checks but the
pointers' alignment (a meta tensor has no storage), an output of the kernel's shape and dtype, and no
launch. ``flash_attention.launches`` counts kernel launches. Each launch,
and each call on ``meta``, reports its :func:`work` to a running
``launch.cost.measure``.

The kernels read every operand through its (batch, head, row) strides, so a
transposed view of a (B, L, H, hd) tensor goes in without a copy; the head
dim must be contiguous and every row 16-byte aligned. Unlike the Pallas
kernel they take any Lq and Lkv (they mask the ragged edge themselves). They
are forward only, as the TPU kernel is: the output carries no gradient
(``repro_torch.kernels.flash_attention.ops.attention`` guards autograd).
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_reference
from repro_torch.launch import cost

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
MAX_GRID_YZ = 65535   # the bf16 kernel's grid (H, B, Lq / 128): y and z at most this
BF16_BLOCK_Q = 128


@functools.cache
def library() -> tuple[ctypes.CDLL, str]:
    """The built kernel library and its compiler log (built once per process)."""
    lib, log = _build.load("flash_attention", SOURCE)
    lib.flash_attention_fwd.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib, log


def pairs(Lq: int, Lkv: int, causal: bool, window: int | None) -> int:
    """(q, k) position pairs the masks keep (query i sees key j ≤ i when
    causal, j > i − window with a window), all Lq·Lkv without a mask."""
    i = np.arange(Lq, dtype=np.int64)
    hi = np.minimum(i, Lkv - 1) if causal else np.full(Lq, Lkv - 1)
    lo = np.maximum(i - window + 1, 0) if window is not None else np.zeros(Lq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def work(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
         window: int | None) -> tuple[int, int]:
    """(FLOPs, bytes) of one call: q·k and p·v, 2·(hd + hd_v) FLOP per kept
    pair and q head; q, k and v read once, the output written once."""
    B, H, Lq, hd = q.shape
    ops = 2 * (hd + v.shape[3]) * B * H * pairs(Lq, k.shape[2], causal, window)
    moved = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return ops, moved


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Lq, hd); k/v: (B, Hkv, Lkv, hd) → (B, H, Lq, hd) in q's dtype."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-D, got {q.dim()}, {k.dim()}, {v.dim()}")
    B, H, Lq, hd = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape) or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit "
                         f"q {tuple(q.shape)}")
    if Hkv == 0 or H % Hkv:
        raise ValueError(f"{H} q heads are not a multiple of {Hkv} kv heads")
    if window is not None and window < 1:
        raise ValueError(f"window must be a positive length, got {window}")
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on CPU, CUDA or meta tensors, not {q.device}")

    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"all operands must be on {q.device}, got {t.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share a float32 or bfloat16 dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in the kernel's {HEAD_DIMS}")
    out = torch.empty_like(q)     # keeps q's memory order, so a view's output is one too
    if out.numel() == 0:
        return out
    vec = 16 // q.element_size()
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim, got strides {t.stride()}")
        if (t.is_cuda and t.data_ptr() % 16) or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"{name} rows must be 16-byte aligned: data_ptr "
                             f"{t.data_ptr() if t.is_cuda else '-'}, strides {t.stride()}")
        strides += list(t.stride()[:3])
    if q.dtype == torch.bfloat16 and (B > MAX_GRID_YZ or -(-Lq // BF16_BLOCK_Q) > MAX_GRID_YZ):
        raise ValueError(f"the bf16 kernel takes at most {MAX_GRID_YZ} batches and "
                         f"{MAX_GRID_YZ * BF16_BLOCK_Q} q rows, got {B} and {Lq}")
    if q.device.type == "meta":
        cost.record_kernel("flash_attention", lambda: work(q, k, v, causal, window),
                           products=True)
        return out

    lib, _ = library()
    c_strides = (ctypes.c_longlong * 12)(*strides)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, Hkv, Lq, Lkv, hd, c_strides, scale, int(causal),
            int(window or 0), _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: cudaError {err}")
    flash_attention.launches += 1
    cost.record_kernel("flash_attention", lambda: work(q, k, v, causal, window),
                       products=True)
    return out


flash_attention.launches = 0
