"""PyTorch/CUDA port of the decentralized-gradient-methods system.

The JAX package ``repro`` is the reference; this package mirrors its
subpackage layout (``core``, ``data``, ``optim``, ``models``, ``configs``,
``kernels``, ``train``) so every module has a counterpart there. It imports
``torch`` and numpy only, never ``jax`` and nothing of ``repro``.

Entry points that create tensors take ``device=`` and default to ``"cuda"``;
without a card they raise unless the caller passes ``device="cpu"``.
"""
from repro_torch.convert import resolve_device

__all__ = ["resolve_device"]
