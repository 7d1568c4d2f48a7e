"""The port's dense GQA decoder against the JAX reference on the same weights.

float32 throughout except the last test. Tolerances: loss and gradients
rtol 1e-4 / atol 1e-6 — both sides compute in float32, but matmuls and
reductions sum in different orders (oneDNN vs XLA), which moves the last
few bits of values summed over hundreds of terms. The bf16 forward differs
by design where the reference takes float32 products of bf16 operands (the
port rounds scores and logits to bf16 once, ROADMAP queue 3), so its loss is
held to 2e-2 absolute on a loss near ln(vocab) ≈ 5.5.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6


# reduced granite at benchmarks/common.py:problem_lm's widths
SMALL = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)


def _configs(**kw):
    kw = {**SMALL, **kw}
    return (jget_config("granite-3-2b", reduced=True, **kw),
            tget_config("granite-3-2b", reduced=True, **kw))


def _pair(jcfg, seed=0):
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B=2, L=17, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L)).astype(np.int32)


@pytest.mark.parametrize("scanned", [False, True])
def test_loss_and_every_gradient_match(scanned):
    jcfg, tcfg = _configs(scan_layers=scanned, n_layers=2)
    jp, tp = _pair(jcfg)
    toks = _tokens(jcfg.vocab_size)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    tflat = _tree.flatten_with_path(tg)
    assert len(jflat) == len(tflat)
    for (jpath, a), (tpath, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


@pytest.mark.parametrize("kw", [dict(q_base=6), dict(positions=np.arange(3, 20)),
                                dict(q_base=6, window=5)],
                         ids=["q_base", "positions", "q_base-window"])
def test_gqa_apply_positions_and_q_base_match(kw):
    """``gqa_apply(positions=, q_base=)`` set the rope positions and the
    causal offset of a chunk, as the reference's do."""
    jcfg, tcfg = _configs(n_layers=1)
    jp, tp = _pair(jcfg)
    x = np.random.default_rng(2).normal(size=(2, 17, jcfg.d_model)).astype(np.float32)
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, _ = jattn.gqa_apply(jp["segments"][0][0]["mix"], jcfg, jnp.asarray(x), **jkw)
    got, cache = tattn.gqa_apply(tp["segments"][0][0]["mix"], tcfg, torch.from_numpy(x), **tkw)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("scanned", [False, True])
def test_forward_q_base_matches(scanned):
    """``forward(q_base=)`` threads the chunk's offset to every block."""
    jcfg, tcfg = _configs(scan_layers=scanned, n_layers=2)
    jp, tp = _pair(jcfg)
    toks = _tokens(jcfg.vocab_size, L=9)
    jh = JM.forward(jp, jcfg, jnp.asarray(toks), q_base=11)[0]
    th, caches = TM.forward(tp, tcfg, torch.from_numpy(toks), q_base=11)
    assert caches is None
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=RTOL, atol=1e-5)
    assert not torch.allclose(th, TM.forward(tp, tcfg, torch.from_numpy(toks))[0])


def _qkv(B=2, Lq=32, Lkv=32, H=4, Kh=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Lq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Lkv, Kh, hd)).astype(np.float32),
            rng.normal(size=(B, Lkv, Kh, hd)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, None), (False, None), (True, 12)])
def test_attention_matches_reference(causal, window):
    q, k, v = _qkv()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    pos = np.arange(32)
    jd = jattn.dense_attention(jq, jk, jv, jnp.asarray(pos), jnp.asarray(pos),
                               causal=causal, window=window)
    td = tattn.dense_attention(tq, tk, tv, torch.from_numpy(pos), torch.from_numpy(pos),
                               causal=causal, window=window)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL, atol=1e-5)
    # small chunks: 4 q blocks × 4 kv blocks, the mask skips unreachable blocks
    jb = jattn.blockwise_attention(jq, jk, jv, 0, causal=causal, window=window,
                                   q_chunk=8, kv_chunk=8)
    tb = tattn.blockwise_attention(tq, tk, tv, 0, causal=causal, window=window,
                                   q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(tb.numpy(), td.numpy(), rtol=RTOL, atol=1e-5)


def test_attention_any_switches_to_blockwise_for_long_kv():
    q, k, v = _qkv(B=1, Lq=48, Lkv=48, H=2, Kh=1, hd=8, seed=1)
    out = tattn.attention_any(*map(torch.from_numpy, (q, k, v)), 0, block_threshold=16)
    jout = jattn.attention_any(*map(jnp.asarray, (q, k, v)), 0, block_threshold=16)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=1e-5)


def test_rope_and_rmsnorm_match():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 3, 16)).astype(np.float32)
    pos = np.arange(5, 16)
    np.testing.assert_allclose(
        tlayers.rope(torch.from_numpy(x), torch.from_numpy(pos), 500.0).numpy(),
        np.asarray(jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 500.0)),
        rtol=RTOL, atol=1e-5)
    scale = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        tlayers.rmsnorm_apply({"scale": torch.from_numpy(scale)}, torch.from_numpy(x)).numpy(),
        np.asarray(jlayers.rmsnorm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        rtol=RTOL, atol=1e-6)


def test_bf16_forward_close_to_reference():
    jcfg, tcfg = _configs(param_dtype="bfloat16", compute_dtype="bfloat16", n_layers=2)
    jp, tp = _pair(jcfg, seed=1)
    assert {x.dtype for x in _tree.leaves(tp)} == {torch.bfloat16}
    toks = _tokens(jcfg.vocab_size, seed=1)
    jl = jax.jit(lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}))(jp)
    tl = TM.loss_fn(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    assert abs(tl.item() - float(jl)) < 2e-2
    jh = jax.jit(lambda p: JM.forward(p, jcfg, jnp.asarray(toks))[0])(jp)
    th = TM.forward(tp, tcfg, torch.from_numpy(toks))[0]
    assert th.dtype == torch.bfloat16 and tuple(th.shape) == tuple(jh.shape)
    np.testing.assert_allclose(th.float().numpy(), np.asarray(jh, np.float32), atol=0.25)


def test_port_init_follows_the_std_rule():
    cfg = dataclasses.replace(tget_config("granite-3-2b", reduced=True), vocab_size=4096)
    p = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    seg = p["segments"][0][0]
    assert abs(p["embed"].std().item() - 0.02) < 1e-3
    assert abs(seg["mix"]["wq"].std().item() - cfg.d_model ** -0.5) < 5e-3
    assert abs(seg["mlp"]["w_up"].std().item() - cfg.d_model ** -0.5) < 5e-3
    assert torch.equal(seg["norm1"]["scale"], torch.ones(cfg.d_model))
    again = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(p), _tree.leaves(again)))
