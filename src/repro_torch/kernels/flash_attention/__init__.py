from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_reference

__all__ = ["attention_reference", "flash_attention"]
