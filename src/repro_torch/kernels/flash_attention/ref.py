"""Plain PyTorch version of the flash-attention forward kernel.

The port of the reference's ``repro/kernels/flash_attention/ref.py``
(``attention_reference``): q, k and v upcast to float32, GQA by a reshape of
the q heads into (kv head, group), the causal and sliding-window masks with
the finite ``-1e30``, a softmax over the whole row, one cast to q's dtype.
The CPU path of :func:`repro_torch.kernels.flash_attention.flash_attention`
and the kernel checks on the card use it.
"""
from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Lq, hd); k/v: (B, Hkv, Lkv, hd) with H % Hkv == 0."""
    B, H, Lq, hd = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = float(scale if scale is not None else 1.0 / np.sqrt(hd))
    qg = q.reshape(B, Hkv, G, Lq, hd)
    s = torch.einsum("bkgqh,bksh->bkgqs", qg.float(), k.float()) * scale
    qi = torch.arange(Lq, device=q.device)[:, None]
    ki = torch.arange(Lkv, device=q.device)[None, :]
    ok = torch.ones((Lq, Lkv), dtype=torch.bool, device=q.device)
    if causal:
        ok = ok & (ki <= qi)
    if window is not None:
        ok = ok & (ki > qi - window)
    s = torch.where(ok, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksh->bkgqh", p, v.float())
    return o.reshape(B, H, Lq, hd).to(q.dtype)
