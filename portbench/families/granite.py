"""Granite's dense decoder (``model_type`` "granite"): the tensors of one
layer, and the port's ``ModelConfig`` for a configuration file.

Grouped-query attention and a SwiGLU MLP, pre-norm. The port has none of
Granite's embedding, residual and logits multipliers and no attention
dropout, and it scales attention scores by 1/sqrt(head_dim): a file that
asks for other values is refused rather than run as something else.
"""
from __future__ import annotations

# the values of the keys the port cannot vary
RUNS = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0, "logits_scaling": 1.0,
        "attention_dropout": 0.0, "attention_bias": False, "mlp_bias": False,
        "rope_scaling": None}


def layer(c: dict, i: int) -> list[tuple[str, tuple, float | str]]:
    """(part, shape, std or 'ones') of every tensor of decoder layer ``i``."""
    D, H, K, hd = (c["hidden_size"], c["num_attention_heads"], c["num_key_value_heads"],
                   c["head_dim"])
    F = c["intermediate_size"]
    return [("attn_norm", (D,), "ones"),
            ("wq", (D, H, hd), D ** -0.5), ("wk", (D, K, hd), D ** -0.5),
            ("wv", (D, K, hd), D ** -0.5), ("wo", (H, hd, D), (H * hd) ** -0.5),
            ("mlp_norm", (D,), "ones"),
            ("w_gate", (D, F), D ** -0.5), ("w_up", (D, F), D ** -0.5),
            ("w_down", (F, D), F ** -0.5)]


def routed(c: dict) -> tuple[int, int] | None:
    """(experts, experts per token) of the routed ``experts.*`` tensors: none."""
    return None


def model_config(c: dict, name: str):
    from portbench import port

    want = dict(RUNS, attention_multiplier=c["head_dim"] ** -0.5)
    port.refuse_unless(c, name, want)
    return port.model_config_of(c, name, arch_type="dense", head_dim=c["head_dim"])
