"""Granite 4.0-H's hybrid decoder on the port against the benchmark's plain
reference (``portbench/reference/granitemoehybrid.py``), on the CPU.

The configuration is the benchmark's file for granite-4.0-h-micro, cut to a
small size: d_model 64, 4 attention heads (2 kv heads) of 16, an MLP of 128,
vocab 256, Mamba-2 with 4 heads of 16 (expand 1), state 16, chunk 8, 32
tokens, float32, weights from the benchmark's seeded draw. Granite's
multipliers keep their published values (embedding 12, scores 1/64,
residual branches 0.22, logits / 8) and attention has no positional
embedding. Tolerances: loss and every gradient rtol 1e-4 / atol 1e-6, as
the other families' references are held to the port (float32 sums in
other orders: the reference takes the SSD in its quadratic form, the port
chunk by chunk); the train step's losses and per-tensor change norms rtol
1e-4.

Also here: the benchmark's frozen parameter count is ``ModelConfig.n_params``
plus the Mamba mixers' drawn conv and per-head vectors, the family refuses
what the port does not run, and the one-peer exponential graph's reference
matrix is the port's round at every step.
"""
import dataclasses
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from portbench import harness, port, weights, yardstick  # noqa: E402
from portbench.reference import plain  # noqa: E402
from repro_torch.core import decentralized as Dc  # noqa: E402
from repro_torch.core import topology as T  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.optim import momentum_sgd  # noqa: E402

CONFIG = "granite-4.0-h-micro.l10"
SMALL = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=128, shared_intermediate_size=128, vocab_size=256,
             mamba_n_heads=4, mamba_d_head=16, mamba_expand=1, mamba_d_state=16,
             mamba_chunk_size=8, torch_dtype="float32")
PATTERNS = {"ssm-attn-ssm": ["mamba", "attention", "mamba"],
            "ssm-ssm-attn-ssm": ["mamba", "mamba", "attention", "mamba"]}
# the value at which each of the port's fields leaves the arithmetic as it is
# (the four multipliers share their names with the configuration file's keys)
NEUTRAL = {"embedding_multiplier": 1.0, "attention_multiplier": 16 ** -0.5,
           "residual_multiplier": 1.0, "logits_scaling": 1.0, "position_embedding": "rope"}


def published() -> dict:
    return harness.load_json(harness.HERE / "configs" / f"{CONFIG}.json")


def small(layer_types=PATTERNS["ssm-attn-ssm"], **over) -> dict:
    return dict(published(), **SMALL, num_hidden_layers=len(layer_types),
                layer_types=layer_types, **over)


def tokens(b=2, seed=3):
    return torch.randint(0, 256, (b, 33), generator=torch.Generator().manual_seed(seed))


def port_loss_and_grads(c: dict, cfg, toks):
    W = weights.make(c, 7, "cpu")
    Wp = {n: t.clone().requires_grad_() for n, t in W.items()}
    loss = Mo.loss_fn(port.program_params(cfg, Wp), cfg, {"tokens": toks})
    return loss.detach(), dict(zip(Wp, torch.autograd.grad(loss, list(Wp.values()))))


def reference_loss_and_grads(c: dict, toks):
    ref = harness.reference(c["model_type"])
    W = {n: t.clone().requires_grad_() for n, t in weights.make(c, 7, "cpu").items()}
    loss = ref.loss(W, c, toks, "fp32")
    return loss.detach(), dict(zip(W, torch.autograd.grad(loss, list(W.values()))))


@pytest.mark.parametrize("scan", [True, False], ids=["scanned", "list"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_loss_and_gradients_equal_the_reference(pattern, scan):
    c = small(PATTERNS[pattern])
    cfg = dataclasses.replace(port.model_config(c, CONFIG), scan_layers=scan)
    segs = Mo.plan_segments(cfg)
    assert any(s.scanned for s in segs) == (scan and pattern == "ssm-ssm-attn-ssm")
    assert cfg.remat and cfg.ssm_mlp and cfg.position_embedding == "nope"
    lp, gp = port_loss_and_grads(c, cfg, tokens())
    lr, gr = reference_loss_and_grads(c, tokens())
    torch.testing.assert_close(lp, lr, rtol=1e-4, atol=1e-6)
    assert set(gp) == set(gr)
    for n in gr:
        torch.testing.assert_close(gp[n], gr[n], rtol=1e-4, atol=1e-6, msg=n)


@pytest.mark.parametrize("field", list(NEUTRAL))
def test_each_multiplier_and_nope_is_in_the_loss(field):
    """The port with one field at its neutral value is far from the
    reference as published, so a dropped multiplier (or rotary embeddings
    left on) fails the test above; a multiplier moved on both sides agrees
    again."""
    c = small()
    cfg = port.model_config(c, CONFIG)
    lr, gr = reference_loss_and_grads(c, tokens())
    lp, gp = port_loss_and_grads(c, dataclasses.replace(cfg, **{field: NEUTRAL[field]}),
                                 tokens())
    far = max(float((gp[n] - gr[n]).abs().max() / (gr[n].abs().max() + 1e-30)) for n in gr)
    assert abs(float(lp - lr)) > 1e-3 * abs(float(lr)) or far > 1e-2, (field, far)
    if field != "position_embedding":          # the reference has no rotary embedding
        c2 = dict(c, **{field: NEUTRAL[field]})
        lr2, gr2 = reference_loss_and_grads(c2, tokens())
        torch.testing.assert_close(lp, lr2, rtol=1e-4, atol=1e-6)
        for n in gr2:
            torch.testing.assert_close(gp[n], gr2[n], rtol=1e-4, atol=1e-6, msg=n)


def test_train_step_equals_plain_train_steps():
    """One ``make_train_step`` step of two workers on the clique, through the
    fused bus under remat, against ``plain.train_steps``: the loss and the
    change of every tensor."""
    c = small(PATTERNS["ssm-ssm-attn-ssm"])
    cfg = port.model_config(c, CONFIG)
    ref = harness.reference(c["model_type"])
    W = weights.make(c, 11, "cpu")
    batch = torch.stack([tokens(seed=5), tokens(seed=6)])             # (M, B, L + 1)
    opt = momentum_sgd(lr=0.01, mu=0.9)
    step = Dc.make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt,
                              gossip=GossipSpec(topology=T.clique(2), backend="fused"))
    p0 = port.program_params(cfg, W)
    state, m = step(Dc.init_state(Dc.replicate_for_workers(p0, 2), opt), {"tokens": batch})
    change = {n: float(torch.linalg.vector_norm(t - W[n]))
              for n, t in port.benchmark_names(cfg, state.params, lead=1).items()}
    losses, _, ref_change = plain.train_steps(
        lambda p, t, pr: ref.loss(p, c, t, pr), W,
        lambda k: harness.reference_topology("clique").matrix(k, M=2), [batch],
        opt=harness.reference_optimizer("momentum_sgd"), opt_args={"lr": 0.01, "mu": 0.9},
        prec="fp32", dtype=torch.float32)
    assert math.isclose(float(m.loss), losses[0], rel_tol=1e-4)
    assert set(change) == set(ref_change)
    for n, v in ref_change.items():
        assert math.isclose(change[n], v, rel_tol=1e-4, abs_tol=1e-7), n


@pytest.mark.parametrize("layers", [10, 40])
def test_parameter_counts_agree(layers):
    """The frozen count (drawn tensors) is ``ModelConfig.n_params``, which
    the roofline's active count equals, plus each Mamba layer's drawn conv
    weights and bias, ``dt_bias`` and ``A_log`` (the port's count leaves
    them out, as for mamba2-2.7b); at 40 layers it is the published 3B."""
    from repro_torch.launch import roofline

    c = published()
    if layers == 40:
        c = dict(c, num_hidden_layers=40, layer_types=c["published"]["layer_types"])
    cfg = port.model_config(c, CONFIG)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
    vectors = (cfg.ssm_conv + 1) * conv_dim + 2 * cfg.ssm_nheads
    n_ssm = c["layer_types"].count("mamba")
    assert cfg.n_params() == roofline.active_params(cfg)
    assert yardstick.n_params(c) == cfg.n_params() + n_ssm * vectors
    assert n_ssm * vectors < 3e-4 * cfg.n_params()
    if layers == 10:
        assert round(cfg.n_params() / 1e6, 1) == 951.7
    else:
        assert 3.0e9 < cfg.n_params() < 3.5e9


def test_the_mamba_mlp_is_counted_only_where_the_config_asks():
    c = published()
    cfg = port.model_config(c, CONFIG)
    bare = dataclasses.replace(cfg, ssm_mlp=False)
    assert cfg.n_params() - bare.n_params() == 9 * 3 * 2048 * 8192
    assert "mlp" not in Mo.model_defs(bare)["segments"][0]


@pytest.mark.parametrize("key,value", [("num_local_experts", 8),
                                       ("position_embedding_type", "rope"),
                                       ("mamba_n_groups", 2), ("attention_bias", True),
                                       ("mamba_proj_bias", True), ("mamba_conv_bias", False)])
def test_family_refuses_what_the_port_does_not_run(key, value):
    with pytest.raises(ValueError, match=key):
        port.model_config(dict(published(), **{key: value}), CONFIG)


@pytest.mark.parametrize("step", range(6))
def test_one_peer_reference_matrix_is_the_port_round(step):
    g = harness.load_json(harness.HERE / "mixes" / "train.onepeer-m8.json")["gossip"]
    spec = port.gossip(g, 8)
    rounds = spec.one_peer_specs
    got = harness.reference_topology(g["topology"]).matrix(step, **g["args"])
    np.testing.assert_allclose(got, rounds[step % len(rounds)].topology.A, rtol=0, atol=0)
