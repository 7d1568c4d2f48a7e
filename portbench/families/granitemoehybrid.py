"""Granite 4.0-H's hybrid decoder (``model_type`` "granitemoehybrid"): the
tensors of one layer, and the port's ``ModelConfig`` for a configuration
file.

Each layer is a Mamba-2 mixer or NoPE grouped-query attention, as
``layer_types`` says, and then a SwiGLU MLP of ``shared_intermediate_size``;
Granite's four multipliers scale the embedding, the scores, every residual
branch and the logits. The block's first norm is ``attn_norm`` on every
layer (the name the harness gives a block's first norm), the MLP's
``mlp_norm``. A Mamba-2 layer's tensors: ``in_proj`` (columns z, x, B, C,
dt), ``conv_w`` (the published ``conv1d.weight`` (channels, 1, width) as
(width, channels)), ``conv_b``, ``dt_bias``, ``A_log``, ``D``, the gated
norm's ``norm`` and ``out_proj``.

The mixer's small tensors are drawn, so that the comparison sees what they
steer; the benchmark draws N(0, std) or ones, so each is the zero-mean
normal nearest the published constructor's draw:

- ``conv_w`` and ``conv_b`` at 1/sqrt(3·width) = 0.2887, the standard
  deviation of ``nn.Conv1d``'s default uniform draw within 1/sqrt(width):
  taps that differ, so a reversed or shifted tap order or a permuted
  channel changes the output;
- ``A_log`` at 2: A = -exp(A_log) spans about e^-4 … e^4 over the heads
  (published: log 1 … log 64, one per head), so a share of the heads
  carries its state across a whole 256-token chunk and the SSD's
  cross-chunk term is a real part of the output;
- ``dt_bias`` at 1 (published: ones), so the step sizes differ by head;
- ``D`` ones, as published.

The benchmark counts drawn tensors as parameters, and the port's
``ModelConfig.n_params`` leaves these vectors out, as it does for
mamba2-2.7b: the frozen count is the port's plus the conv and the two
per-head vectors, 0.02% of a replica.

The port runs no experts, no biases but the conv's, one group of B and C,
RMSNorm and SiLU: a file that asks for anything else is refused rather
than run as something else.
"""
from __future__ import annotations

RUNS = {"num_local_experts": 0, "num_experts_per_tok": 0, "position_embedding_type": "nope",
        "mamba_n_groups": 1, "attention_bias": False, "mamba_proj_bias": False,
        "mamba_conv_bias": True, "normalization_function": "rmsnorm", "rope_scaling": None}

KINDS = {"mamba": "ssm", "attention": "attn"}


def _mlp(c: dict) -> list[tuple[str, tuple, float | str]]:
    D, F = c["hidden_size"], c["shared_intermediate_size"]
    return [("mlp_norm", (D,), "ones"), ("w_gate", (D, F), D ** -0.5),
            ("w_up", (D, F), D ** -0.5), ("w_down", (F, D), F ** -0.5)]


def layer(c: dict, i: int) -> list[tuple[str, tuple, float | str]]:
    """(part, shape, std or 'ones') of every tensor of decoder layer ``i``."""
    D = c["hidden_size"]
    if c["layer_types"][i] == "attention":
        H, K = c["num_attention_heads"], c["num_key_value_heads"]
        hd = D // H
        return [("attn_norm", (D,), "ones"),
                ("wq", (D, H, hd), D ** -0.5), ("wk", (D, K, hd), D ** -0.5),
                ("wv", (D, K, hd), D ** -0.5), ("wo", (H, hd, D), (H * hd) ** -0.5)] + _mlp(c)
    H, P, N, G = (c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"],
                  c["mamba_n_groups"])
    di = H * P
    conv, conv_std = di + 2 * G * N, (3 * c["mamba_d_conv"]) ** -0.5
    return [("attn_norm", (D,), "ones"),
            ("in_proj", (D, 2 * di + 2 * G * N + H), D ** -0.5),
            ("conv_w", (c["mamba_d_conv"], conv), conv_std), ("conv_b", (conv,), conv_std),
            ("dt_bias", (H,), 1.0), ("A_log", (H,), 2.0), ("D", (H,), "ones"),
            ("norm", (di,), "ones"), ("out_proj", (di, D), di ** -0.5)] + _mlp(c)


def routed(c: dict) -> tuple[int, int] | None:
    """(experts, experts per token) of the routed ``experts.*`` tensors: none."""
    return None


def model_config(c: dict, name: str):
    from portbench import port

    port.refuse_unless(c, name, RUNS)
    kinds = c["layer_types"]
    if len(kinds) != c["num_hidden_layers"] or set(kinds) - set(KINDS):
        raise ValueError(f"{name}: layer_types {kinds} against {c['num_hidden_layers']} "
                         f"layers of kinds {sorted(KINDS)}")
    D, H, P = c["hidden_size"], c["mamba_n_heads"], c["mamba_d_head"]
    if H * P != c["mamba_expand"] * D or D % c["num_attention_heads"]:
        raise ValueError(f"{name}: {H} Mamba heads of {P} against expand "
                         f"{c['mamba_expand']} of {D}, or {c['num_attention_heads']} "
                         f"attention heads that do not divide it")
    return port.model_config_of(
        dict(c, intermediate_size=c["shared_intermediate_size"]), name, arch_type="hybrid",
        head_dim=D // c["num_attention_heads"], layer_pattern=tuple(KINDS[k] for k in kinds),
        ssm_state=c["mamba_d_state"], ssm_headdim=P, ssm_expand=c["mamba_expand"],
        ssm_chunk=c["mamba_chunk_size"], ssm_ngroups=c["mamba_n_groups"],
        ssm_conv=c["mamba_d_conv"], embedding_multiplier=float(c["embedding_multiplier"]),
        attention_multiplier=float(c["attention_multiplier"]),
        residual_multiplier=float(c["residual_multiplier"]),
        logits_scaling=float(c["logits_scaling"]), position_embedding="nope", ssm_mlp=True)
