"""Moving parameter trees and batches between numpy and the port's tensors.

bf16 travels as its 16 bits, as ``repro/train/checkpoint.py`` stores it:
numpy ``bfloat16`` → ``uint16`` view → ``torch.int16`` → ``.view(bfloat16)``.
``torch.from_numpy`` refuses the ``ml_dtypes`` bfloat16 arrays JAX hands
out, and a float round trip would not be bit-exact for every value.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import _tree

__all__ = ["resolve_device", "params_from_jax", "params_to_numpy", "to_device"]


def resolve_device(device: str | torch.device) -> torch.device:
    """The torch device for ``device``; raises for CUDA when there is no card.

    The port never drops quietly to the CPU: a caller that wants the CPU
    says ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def _from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(np_tree: Any, device: str | torch.device = "cuda",
                    dtype: torch.dtype | None = None) -> Any:
    """The reference's parameters (as numpy arrays) as a tree of tensors.

    Dict keys come out in sorted order, the reference's leaf order.
    ``dtype`` optionally casts every floating leaf after the exact transfer.
    """
    dev = resolve_device(device)

    def leaf(a):
        t = _from_numpy(a, dev)
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        return t

    return _tree.map(leaf, np_tree)


def params_to_numpy(tree: Any) -> Any:
    """Tensors → numpy arrays; bf16 leaves become ``ml_dtypes.bfloat16``."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes  # only needed when a bf16 leaf is present

            return t.view(torch.int16).numpy().view(np.uint16).view(
                ml_dtypes.bfloat16)
        return t.numpy()

    return _tree.map(leaf, tree)


def to_device(tree: Any, device: str | torch.device = "cuda") -> Any:
    """A batch (numpy arrays or tensors) as tensors on ``device``."""
    dev = resolve_device(device)
    return _tree.map(
        lambda a: a.to(dev) if isinstance(a, torch.Tensor) else _from_numpy(a, dev),
        tree)
