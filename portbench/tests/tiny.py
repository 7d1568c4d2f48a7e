"""Tiny stand-ins of the cells, for runs on the CPU: the cell's own files
with every width and count cut so that a run takes seconds."""
from __future__ import annotations

from portbench import harness

GRANITE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               intermediate_size=128, vocab_size=256, num_hidden_layers=2,
               attention_multiplier=16 ** -0.5)
DEEPSEEK = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=4, kv_lora_rank=32,
                qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16, intermediate_size=128,
                moe_intermediate_size=32, n_routed_experts=8, num_experts_per_tok=2,
                n_shared_experts=1, vocab_size=256, num_hidden_layers=2)

def cell(name: str) -> dict:
    c = harness.cell(name)
    c["cfg"].update(DEEPSEEK if c["cfg"]["model_type"] == "deepseek_v2" else GRANITE)
    c["mix"].update(batch_per_worker=min(2, c["mix"]["batch_per_worker"]), seq_len=16)
    return c
