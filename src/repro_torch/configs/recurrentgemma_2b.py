"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 attn:recurrent.
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

_PATTERN = tuple((["rglru", "rglru", "local"] * 9)[:26])  # (R,R,A)x8 + R,R

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,           # MQA on the local-attention layers
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    mlp_type="geglu",
    layer_pattern=_PATTERN,
    lru_width=2560,
    window=2048,            # local attention window
    emb_scale=True,
    tie_embeddings=True,
    subquadratic=True,      # bounded recurrent + windowed state
    source="arXiv:2402.19427",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
