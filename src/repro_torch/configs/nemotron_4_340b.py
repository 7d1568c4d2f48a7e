"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP. [arXiv:2402.16819]

The reference's numbers. ``serve_sharding="fsdp"`` spreads one replica over
a device mesh, which the port does not have yet: on one card the model runs
at a cut depth (PERF.md, Cells).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
    source="arXiv:2402.16819",
    dp_mode="gossip",
    serve_sharding="fsdp",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
