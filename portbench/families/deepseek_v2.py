"""DeepSeek-V2's decoder (``model_type`` "deepseek_v2"): multi-head latent
attention, leading dense layers, then routed and shared experts. The tensors
of one layer, and the port's ``ModelConfig`` for a configuration file.

The port runs plain rotary embeddings, softmax routing to the greedy top-k
with the weights renormalized, capacity-bounded experts and one load-balance
loss over the whole call: a file that asks for anything else is refused.
Plain rotary embeddings are ``rope_scaling`` null or YaRN at factor 1, which
interpolates no frequency and scales by no mscale (see ``plain_rope``).
"""
from __future__ import annotations

RUNS = {"norm_topk_prob": True, "seq_aux": False,
        "scoring_func": "softmax", "topk_method": "greedy", "q_lora_rank": None,
        "moe_layer_freq": 1, "n_group": 1, "topk_group": 1, "routed_scaling_factor": 1,
        "attention_bias": False}


def plain_rope(scaling: dict | None) -> bool:
    """Whether DeepSeek's ``rope_scaling`` is the plain rotary embedding: none,
    or YaRN at factor 1, where the interpolated frequencies equal the original
    ones and each mscale term, 0.1·mscale·ln(factor) + 1, is 1."""
    return scaling is None or (scaling.get("type") == "yarn" and scaling.get("factor") == 1)


def _moe(c: dict, i: int) -> bool:
    return i >= c["first_k_dense_replace"]


def layer(c: dict, i: int) -> list[tuple[str, tuple, float | str]]:
    """(part, shape, std or 'ones') of every tensor of decoder layer ``i``."""
    D, H = c["hidden_size"], c["num_attention_heads"]
    r, dn, dr, dv = (c["kv_lora_rank"], c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                     c["v_head_dim"])
    out = [("attn_norm", (D,), "ones"),
           ("wq", (D, H, dn + dr), D ** -0.5), ("w_dkv", (D, r + dr), D ** -0.5),
           ("kv_norm", (r,), "ones"), ("w_uk", (r, H, dn), r ** -0.5),
           ("w_uv", (r, H, dv), r ** -0.5), ("wo", (H, dv, D), (H * dv) ** -0.5),
           ("mlp_norm", (D,), "ones")]
    if not _moe(c, i):
        F = c["intermediate_size"]
        return out + [("w_gate", (D, F), D ** -0.5), ("w_up", (D, F), D ** -0.5),
                      ("w_down", (F, D), F ** -0.5)]
    E, Fe = c["n_routed_experts"], c["moe_intermediate_size"]
    out += [("router", (D, E), 0.02), ("experts.w_gate", (E, D, Fe), D ** -0.5),
            ("experts.w_up", (E, D, Fe), D ** -0.5), ("experts.w_down", (E, Fe, D), Fe ** -0.5)]
    Fs = Fe * c["n_shared_experts"]
    if Fs:
        out += [("shared.w_gate", (D, Fs), D ** -0.5), ("shared.w_up", (D, Fs), D ** -0.5),
                ("shared.w_down", (Fs, D), Fs ** -0.5)]
    return out


def routed(c: dict) -> tuple[int, int] | None:
    """(experts, experts per token) of the routed ``experts.*`` tensors."""
    return c["n_routed_experts"], c["num_experts_per_tok"]


def model_config(c: dict, name: str):
    from portbench import port

    port.refuse_unless(c, name, RUNS)
    if not plain_rope(c.get("rope_scaling")):
        raise ValueError(f"{name}: the port runs plain rotary embeddings (rope_scaling null "
                         f"or YaRN at factor 1), the file asks for {c.get('rope_scaling')}")
    return port.model_config_of(
        c, name, arch_type="moe", head_dim=c["qk_nope_head_dim"], attention_type="mla",
        kv_lora_rank=c["kv_lora_rank"], qk_rope_dim=c["qk_rope_head_dim"],
        qk_nope_dim=c["qk_nope_head_dim"], v_head_dim=c["v_head_dim"],
        n_experts=c["n_routed_experts"], n_shared_experts=c["n_shared_experts"],
        top_k=c["num_experts_per_tok"], d_ff_expert=c["moe_intermediate_size"],
        first_dense_layers=c["first_k_dense_replace"],
        capacity_factor=float(c["capacity_factor"]),
        router_aux_coef=float(c["router_aux_coef"]))
