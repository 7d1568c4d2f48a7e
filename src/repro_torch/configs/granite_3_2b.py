"""granite-3-2b [dense] — GQA. [hf:ibm-granite/granite-3.0-2b-base]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    arch_type="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    mlp_type="swiglu",
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-2b-base",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
