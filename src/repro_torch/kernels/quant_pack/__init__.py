from repro_torch.kernels.quant_pack.kernel import DEFAULT_BLOCK_R, quantize_pack_2d
from repro_torch.kernels.quant_pack.ref import quantize_pack_reference

__all__ = ["DEFAULT_BLOCK_R", "quantize_pack_2d", "quantize_pack_reference"]
