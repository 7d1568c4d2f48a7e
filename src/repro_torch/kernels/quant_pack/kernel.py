"""Wrapper of the fused int8 quantize-pack kernel (``csrc/quant_pack.cu``).

:func:`quantize_pack_2d` turns an (R, C) float buffer into its int8 wire
image, one absmax scale per row: the port of the Pallas TPU kernel
``repro/kernels/quant_pack/kernel.py:quantize_pack_2d``. For CPU tensors it
runs the plain version (:mod:`.ref`); for CUDA tensors it launches the CUDA
kernel, built at first call, or raises. There is no fallback from one to
the other. ``quantize_pack_2d.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_pack.ref import quantize_pack_reference

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant_pack.cu"
DEFAULT_BLOCK_R = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROW = 128    # the row width of the one-warp-per-row path (the bus's LANE)


@functools.cache
def library() -> tuple[ctypes.CDLL, str]:
    """The built kernel library and its compiler log (built once per process)."""
    lib, log = _build.load("quant_pack", SOURCE)
    lib.quant_pack.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.quant_pack.restype = ctypes.c_int
    return lib, log


def quantize_pack_2d(x: torch.Tensor, *,
                     block_r: int = DEFAULT_BLOCK_R) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 quantization of a flat (R, C) bus buffer.

    Returns ``(values, scales)``: int8 ``(R, C)`` and float32 ``(R, 1)``,
    with ``|x − values·scale| ≤ scale/2`` elementwise and all-zero rows
    exact (scale 1). ``block_r`` is the reference's row tile: R must be a
    multiple of ``min(block_r, R)``; on the card it only validates the input.
    """
    if x.dim() != 2 or x.shape[1] == 0:
        raise ValueError(f"quantize_pack_2d takes an (R, C>0) buffer, got {tuple(x.shape)}")
    R, C = x.shape
    br = min(block_r, R)
    if br < 1 or R % br:
        raise ValueError(f"rows {R} are not a multiple of block_r {br}")
    if x.device.type == "cpu":
        return quantize_pack_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_pack_2d runs on CPU or CUDA tensors, not {x.device}")
    if not x.is_contiguous():
        raise ValueError("quantize_pack_2d needs a contiguous buffer")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"quantize_pack_2d takes float32 or bfloat16, got {x.dtype}")

    lib, _ = library()
    values = torch.empty((R, C), dtype=torch.int8, device=x.device)
    scales = torch.empty((R, 1), dtype=torch.float32, device=x.device)
    # one 16-byte (float32) or 8-byte (bf16) load per lane, 4 int8 out
    vectorized = C == _ROW and x.data_ptr() % (4 * x.element_size()) == 0
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_pack(x.data_ptr(), values.data_ptr(), scales.data_ptr(),
                             R, C, _DTYPE_CODE[x.dtype], int(vectorized), stream)
    if err != 0:
        raise RuntimeError(f"quant_pack kernel launch failed: cudaError {err}")
    quantize_pack_2d.launches += 1
    return values, scales


quantize_pack_2d.launches = 0
