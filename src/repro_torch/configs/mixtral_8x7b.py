"""mixtral-8x7b [moe] — 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    mlp_type="swiglu",
    n_experts=8,
    top_k=2,
    d_ff_expert=14336,
    window=4096,            # SWA -> bounded KV cache
    subquadratic=True,      # windowed cache -> long_500k eligible
    source="arXiv:2401.04088",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
