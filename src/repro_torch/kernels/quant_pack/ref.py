"""Plain PyTorch version of the fused int8 quantize-pack kernel.

Per row of an (R, C) float buffer (one 128-lane bus row on the gossip bus):

    amax   = max |x|
    scale  = amax · fl32(1/127)   if amax > 0, else 1.0
    values = round_half_even(x / scale)  as int8

The reference writes ``amax / 127.0``; XLA compiles a division by a
constant into a multiply by the constant's float32 reciprocal, which is what
the reference kernel computes (one ulp off the true quotient in some
rows), so this version multiplies by that reciprocal too.
``x / scale`` stays a true division and ``torch.round`` rounds half to even
like ``jnp.round``. The CPU path of
:func:`repro_torch.kernels.quant_pack.quantize_pack_2d` and the kernel
checks on the card use it.
"""
from __future__ import annotations

import numpy as np
import torch

# 1/127 rounded to float32: 0x1.020408p-7
RECIP_127 = float(np.float32(1) / np.float32(127))


def quantize_pack_reference(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(values int8 (R, C), scales float32 (R, 1))`` of a float (R, C) ``x``."""
    xf = x.float()
    amax = xf.abs().amax(-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax * RECIP_127, 1.0)
    return torch.round(xf / scale).to(torch.int8), scale
