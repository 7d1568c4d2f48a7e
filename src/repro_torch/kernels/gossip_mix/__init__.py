from repro_torch.kernels.gossip_mix.kernel import gossip_mix_2d
from repro_torch.kernels.gossip_mix.ops import gossip_mix_leaf, gossip_mix_pytree
from repro_torch.kernels.gossip_mix.ref import gossip_mix_reference

__all__ = ["gossip_mix_2d", "gossip_mix_reference", "gossip_mix_leaf", "gossip_mix_pytree"]
