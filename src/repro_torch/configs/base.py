"""Architecture configuration schema.

A copy of the reference's ``repro/configs/base.py`` (a plain dataclass), so
a config and its ``reduced()`` smoke variant carry the same numbers in both
packages. configs/<id>.py instantiate it with the exact assignment numbers.
The port's model runs the dense GQA family so far; the other fields are kept
so the later families' configs need no schema change.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str            # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    source: str = ""          # citation from the assignment

    # --- layer flavour ------------------------------------------------------
    mlp_type: str = "swiglu"          # swiglu | geglu | relu2
    attention_type: str = "gqa"       # gqa | mla
    window: int | None = None         # sliding-window size (mixtral SWA, rg local)
    qk_norm: bool = False             # chameleon
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    emb_scale: bool = False           # gemma: embeddings × sqrt(d_model)
    tie_embeddings: bool = False

    # --- MoE ----------------------------------------------------------------
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0       # deepseek-v2: first layer(s) dense
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    moe_dispatch: str = "global"      # global | per_sequence (§Perf: keeps the
                                      # dispatch local to batch shards)
    moe_shard: str = "auto"           # auto | capacity (§Perf: shard the
                                      # capacity dim over 'model', replicate
                                      # expert weights — removes the expanded-
                                      # buffer TP psum; serving-oriented)

    # --- MLA (deepseek-v2) ----------------------------------------------------
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- SSM (mamba2 SSD) -----------------------------------------------------
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_ngroups: int = 1
    ssm_conv: int = 4

    # --- hybrid (recurrentgemma / griffin) -------------------------------------
    layer_pattern: tuple[str, ...] | None = None  # per-layer kinds, len n_layers
    lru_width: int = 0

    # --- encoder-decoder (seamless) ---------------------------------------------
    encoder_layers: int = 0
    encoder_seq: int = 4096           # precomputed frame-embedding length (stub)

    # --- modality frontend stubs -------------------------------------------------
    frontend: str | None = None       # 'audio' -> input_specs gives frame embeddings

    # --- distribution defaults ----------------------------------------------------
    dp_mode: str = "gossip"           # gossip | allreduce (training; replicas
                                      # that exceed one device group shard
                                      # over the WorkerMesh model axis INSIDE
                                      # gossip mode — the old 'fsdp'
                                      # technique-off fallback is retired)
    serve_sharding: str = "tp"        # tp | fsdp — prefill/decode param
                                      # layout; 'fsdp' spreads one replica's
                                      # d_model over the worker axes too
                                      # (nemotron-scale checkpoints)
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    subquadratic: bool = False        # eligible for long_500k decode
    shard_activations: str | bool = False  # §Perf pin: False | 'model' | 'batch'
                                      # (fsdp runs only — never under the
                                      # gossip vmap); see model._act_shard
    parallel_block: bool = False      # §Perf (beyond-paper, PaLM-style):
                                      # x + attn(n1(x)) + mlp(n2(x)) — the two
                                      # row-parallel outputs sum BEFORE the TP
                                      # all-reduce, halving per-layer collective
                                      # bytes. Architectural deviation: opt-in.

    # ---------------------------------------------------------------------------
    @property
    def layer_kinds(self) -> tuple[str, ...]:
        if self.layer_pattern is not None:
            assert len(self.layer_pattern) == self.n_layers
            return self.layer_pattern
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        return ("attn",) * self.n_layers

    @property
    def d_inner(self) -> int:  # mamba2
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def moe_layer_flags(self) -> tuple[bool, ...]:
        if not self.n_experts:
            return (False,) * self.n_layers
        return tuple(i >= self.first_dense_layers for i in range(self.n_layers))

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        n = V * D * (1 if self.tie_embeddings else 2)
        per_attn = D * self.n_heads * self.head_dim + 2 * D * self.n_kv_heads * self.head_dim \
            + self.n_heads * self.head_dim * D
        if self.attention_type == "mla":
            per_attn = (D * self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
                        + D * (self.kv_lora_rank + self.qk_rope_dim)
                        + self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                        + self.n_heads * self.v_head_dim * D)
        gate = {"swiglu": 3, "geglu": 3, "relu2": 2, "gelu": 2}[self.mlp_type]
        per_mlp = gate * D * F
        per_moe = (self.n_experts + self.n_shared_experts) * gate * D * self.d_ff_expert \
            + D * self.n_experts if self.n_experts else 0
        per_ssm = (2 * self.d_inner + 2 * self.ssm_ngroups * self.ssm_state + self.ssm_nheads) * D \
            + self.d_inner * D if self.ssm_state else 0
        total = n
        for i, kind in enumerate(self.layer_kinds):
            if kind == "ssm":
                total += per_ssm
            elif kind == "rglru":
                w = self.lru_width or D
                total += 2 * D * w + w * D + per_mlp
                continue
            else:
                total += per_attn
                total += per_moe if self.moe_layer_flags[i] else per_mlp
        return total

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers (pattern-preserving), d_model ≤ 256."""
        scale = max(self.d_model // 256, 1)
        d_model = self.d_model // scale
        head_dim = max((self.head_dim // scale) // 8 * 8, 8)  # even, rope-safe
        n_heads = max(d_model // max(head_dim, 1) // 2, 1)
        n_kv = max(min(self.n_kv_heads, n_heads), 1)
        if self.n_kv_heads == self.n_heads:
            n_kv = n_heads
        n_layers = min(self.n_layers, 2)
        pattern = None
        if self.layer_pattern is not None:
            # keep one of each kind present in the pattern
            kinds = list(dict.fromkeys(self.layer_pattern))[:2]
            pattern = tuple(kinds + ["attn"] * 0)[:2]
            n_layers = len(pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=n_layers,
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=head_dim,
            d_ff=max(self.d_ff // scale, 32),
            vocab_size=min(self.vocab_size, 1024),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2) if self.top_k else 0,
            d_ff_expert=max(self.d_ff_expert // scale, 16) if self.d_ff_expert else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            kv_lora_rank=min(self.kv_lora_rank, 64),
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.qk_rope_dim else 0,
            qk_nope_dim=min(self.qk_nope_dim, 32) if self.qk_nope_dim else 0,
            v_head_dim=min(self.v_head_dim, 32) if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=min(self.ssm_headdim, 16) if self.ssm_state else self.ssm_headdim,
            ssm_chunk=32,
            lru_width=min(self.lru_width, d_model) if self.lru_width else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_seq=64,
            window=min(self.window, 32) if self.window else None,
            layer_pattern=pattern,
            scan_layers=False,
            remat=False,
        )
