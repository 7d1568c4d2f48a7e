"""chameleon-34b [vlm] — early-fusion over discrete VQ image tokens, qk-norm.
[arXiv:2405.09818]

Early fusion means image patches are VQ-quantized into tokens *in the same
65536 vocab* as text, so the faithful backbone input really is token ids;
the VQ tokenizer itself is the (stubbed) frontend per the assignment.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    arch_type="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    mlp_type="swiglu",
    qk_norm=True,
    source="arXiv:2405.09818",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
