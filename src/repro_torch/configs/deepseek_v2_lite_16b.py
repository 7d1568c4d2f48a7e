"""deepseek-v2-lite-16b [moe] — MLA (kv_lora=512), 2 shared + 64 routed top-6.
[arXiv:2405.04434]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    arch_type="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,             # dense MLP of the first (non-MoE) layer
    vocab_size=102400,
    mlp_type="swiglu",
    attention_type="mla",
    kv_lora_rank=512,
    qk_rope_dim=64,
    qk_nope_dim=128,
    v_head_dim=128,
    n_experts=64,
    n_shared_experts=2,
    top_k=6,
    d_ff_expert=1408,
    first_dense_layers=1,
    source="arXiv:2405.04434",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
