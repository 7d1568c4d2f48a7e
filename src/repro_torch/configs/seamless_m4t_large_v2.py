"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal. [arXiv:2308.11596]

A copy of the reference's config. The speech frontend (mel-spectrogram +
conv feature extractor) is a stub, as in the reference: callers supply
precomputed frame embeddings of shape (batch, encoder_seq, d_model)
(``enc_embeds``); the model is the transformer backbone (a 24-layer encoder
over the frames + a 24-layer text decoder with cross-attention).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    arch_type="audio",
    n_layers=24,            # decoder layers
    encoder_layers=24,      # encoder layers over frame embeddings
    encoder_seq=4096,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256206,
    mlp_type="gelu",
    frontend="audio",
    source="arXiv:2308.11596",
    dp_mode="gossip",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
