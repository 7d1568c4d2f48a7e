"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    arch_type="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    head_dim=0,
    d_ff=0,                 # mamba blocks have no MLP
    vocab_size=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_ngroups=1,
    subquadratic=True,      # O(1) decode state -> long_500k eligible
    source="arXiv:2405.21060",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
