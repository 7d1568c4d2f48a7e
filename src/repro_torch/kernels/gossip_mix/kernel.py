"""Wrapper of the fused gossip-mix + update kernel (``csrc/gossip_mix.cu``).

:func:`gossip_mix_2d` computes ``out = a₀·w + Σ_d a_{d+1}·nbr_d − η·u``
(update optional), the port of the Pallas TPU kernel
``repro/kernels/gossip_mix/kernel.py:gossip_mix_2d``. For CPU tensors it
runs the plain version (:mod:`.ref`); for CUDA tensors it launches the CUDA
kernel, built at first call, or raises. There is no fallback from one to
the other. ``gossip_mix_2d.launches`` counts kernel launches and
``gossip_mix_2d.launches_by_k`` counts them by neighbour count k.

The weights and η are host values (Python floats, a numpy array or a CPU
tensor), passed to the kernel by value; the bus knows them from the
topology's permutation decomposition.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gossip_mix.ref import gossip_mix_reference

SOURCE = Path(__file__).resolve().parent / "csrc" / "gossip_mix.cu"
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def library() -> tuple[ctypes.CDLL, str]:
    """The built kernel library and its compiler log (built once per process)."""
    lib, log = _build.load("gossip_mix", SOURCE)
    lib.gossip_mix.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.gossip_mix.restype = ctypes.c_int
    lib.gossip_mix_max_neighbors.argtypes = []
    lib.gossip_mix_max_neighbors.restype = ctypes.c_int
    return lib, log


def gossip_mix_2d(
    w: torch.Tensor,                      # (R, C) or any shape
    neighbors: torch.Tensor,              # (k, *w.shape)
    weights: Sequence[float],             # k + 1 host values
    update: torch.Tensor | None = None,   # w.shape
    eta: float | None = None,             # host value, required with update
) -> torch.Tensor:
    k = neighbors.shape[0]
    wts = np.asarray(weights, np.float32).reshape(-1)
    if wts.shape[0] != k + 1:
        raise ValueError(f"{k} neighbours need {k + 1} weights, got {wts.shape[0]}")
    if tuple(neighbors.shape[1:]) != tuple(w.shape):
        raise ValueError(f"neighbors {tuple(neighbors.shape)} do not stack w {tuple(w.shape)}")
    if update is not None:
        if tuple(update.shape) != tuple(w.shape):
            raise ValueError(f"update {tuple(update.shape)} != w {tuple(w.shape)}")
        if eta is None:
            raise ValueError("update without eta")
    if w.device.type == "cpu":
        return gossip_mix_reference(w, neighbors, wts, update, eta)
    if w.device.type != "cuda":
        raise ValueError(f"gossip_mix_2d runs on CPU or CUDA tensors, not {w.device}")

    tensors = [w, neighbors] + ([update] if update is not None else [])
    for t in tensors:
        if t.device != w.device:
            raise ValueError(f"all operands must be on {w.device}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError("gossip_mix_2d needs contiguous operands")
    if w.dtype not in _DTYPE_CODE or neighbors.dtype != w.dtype:
        raise TypeError(f"w/neighbors must share a float32 or bfloat16 dtype, "
                        f"got {w.dtype}/{neighbors.dtype}")
    if update is not None and update.dtype not in _DTYPE_CODE:
        raise TypeError(f"update must be float32 or bfloat16, got {update.dtype}")

    lib, _ = library()
    if k > lib.gossip_mix_max_neighbors():
        raise ValueError(f"k={k} neighbours exceeds the kernel's "
                         f"{lib.gossip_mix_max_neighbors()}")
    out = torch.empty_like(w)
    n = w.numel()
    if n == 0:
        return out
    vec = 16 // w.element_size()
    aligned = n % vec == 0 and all(t.data_ptr() % 16 == 0 for t in tensors + [out])
    c_wts = (ctypes.c_float * (k + 1))(*wts.tolist())
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.gossip_mix(
            w.data_ptr(), neighbors.data_ptr(),
            update.data_ptr() if update is not None else None, out.data_ptr(),
            n, k, c_wts, float(np.float32(eta if update is not None else 0.0)),
            _DTYPE_CODE[w.dtype],
            _DTYPE_CODE[update.dtype if update is not None else w.dtype],
            int(aligned), stream)
    if err != 0:
        raise RuntimeError(f"gossip_mix kernel launch failed: cudaError {err}")
    gossip_mix_2d.launches += 1
    gossip_mix_2d.launches_by_k[k] = gossip_mix_2d.launches_by_k.get(k, 0) + 1
    return out


gossip_mix_2d.launches = 0
gossip_mix_2d.launches_by_k = {}
