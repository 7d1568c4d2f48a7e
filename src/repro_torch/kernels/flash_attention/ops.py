"""Flash attention in the model's (B, L, H, hd) layout.

The counterpart of the reference's ``repro/kernels/flash_attention/ops.py``
(``attention``). The operands go to
:func:`repro_torch.kernels.flash_attention.kernel.flash_attention` as
transposed views, (B, H, L, hd), whose strides the kernel reads: no copy is
made on the way in or out.

The kernel is forward only, like the Pallas kernel, and the reference has no
backward kernel for it. A ctypes launch records nothing for autograd, so
:func:`attention` is a ``torch.autograd.Function`` whose backward raises:
without it a call under autograd would silently drop the attention
gradients. Training takes ``models.attention.blockwise_attention``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention

__all__ = ["attention"]


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        o = flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window, scale=scale)
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "flash_attention is forward only: there is no backward kernel (the "
            "TPU kernel has none either); differentiate through "
            "repro_torch.models.attention.blockwise_attention instead")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              scale: float | None = None) -> torch.Tensor:
    """q: (B, Lq, H, hd); k/v: (B, Lkv, Hkv, hd) -> (B, Lq, H, hd)."""
    return _FlashAttention.apply(q, k, v, causal, window, scale)
