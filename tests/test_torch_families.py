"""The dense variants and sliding windows of the port against the JAX
reference on the same weights: deepseek-7b, gemma-2b, nemotron-4-340b,
chameleon-34b and mixtral-8x7b (whose MoE layer has its own file,
``tests/test_torch_moe.py``).

Configs are the reference's reduced ones (``get_config(name,
reduced=True)``, float32, 2 layers); weights are made by the reference and
moved bit for bit (``convert.params_from_jax``). Tolerances are those of
``tests/test_torch_model.py`` and ``tests/test_torch_serving.py``: loss and
gradients rtol 1e-4 / atol 1e-6, logits, caches and logprobs atol 1e-5 (the
same float32 arithmetic, summed in other orders); greedy tokens must be
equal. The flash kernel's plain version at head dims 192 and 256 is held to
the Pallas kernel in interpret mode at the reference's kernel-test
tolerances (float32 2e-5, bf16 3e-2). The gemma embedding under bf16 must
be bit-equal.
"""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_config_parity import assert_config_matches_reference

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_NAMES as JARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.kernels.flash_attention.ops import attention as jflash_op  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JP  # noqa: E402
from repro.serving import ContinuousBatcher as JContinuousBatcher  # noqa: E402
from repro.serving import WaveBatcher as JWaveBatcher  # noqa: E402
from repro.serving import generate as jgenerate  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TP  # noqa: E402
from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss and gradients
ATOL_OUT = 1e-5               # logits, caches, logprobs
FAMILIES = ["deepseek-7b", "gemma-2b", "nemotron-4-340b", "chameleon-34b", "mixtral-8x7b"]


def _pair(name, seed=0, **overrides):
    jcfg = jget_config(name, reduced=True, **overrides)
    tcfg = tget_config(name, reduced=True, **overrides)
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B, L, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L)).astype(np.int32)


def _close(t, j, atol=ATOL_OUT):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


def _check_caches(tcaches, jcaches, pos):
    tl, jl = _tree.leaves(tcaches), jax.tree.leaves(jcaches)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        if isinstance(t, int):
            assert t == pos and np.all(np.asarray(j) == pos)
        else:
            assert tuple(t.shape) == tuple(j.shape)
            _close(t, j)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("name", FAMILIES)
def test_config_equals_the_reference_field_by_field(name, reduced):
    assert name in ARCH_NAMES
    j, t = jget_config(name, reduced=reduced), tget_config(name, reduced=reduced)
    assert_config_matches_reference(j, t)
    assert t.n_params() == j.n_params()


# ---------------------------------------------------------------------------
# Layers: MLP variants, qk-norm, scaled embeddings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_type", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_apply_matches(mlp_type):
    jcfg = jget_config("granite-3-2b", reduced=True, mlp_type=mlp_type)
    tcfg = tget_config("granite-3-2b", reduced=True, mlp_type=mlp_type)
    rng = np.random.default_rng(1)
    defs = TL.mlp_defs(tcfg)
    assert sorted(defs) == sorted(JL.mlp_defs(jcfg))
    assert ("w_gate" in defs) == (mlp_type in ("swiglu", "geglu"))
    p = {k: (rng.normal(size=d.shape) / np.sqrt(d.shape[0])).astype(np.float32)
         for k, d in defs.items()}
    x = rng.normal(size=(2, 5, tcfg.d_model)).astype(np.float32)
    want = JL.mlp_apply(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    got = TL.mlp_apply(convert.params_from_jax(p, device="cpu"), tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL_OUT)


def test_qk_norm_attention_matches():
    """chameleon's q_norm / k_norm: RMSNorms over hd before rope, with
    scales that are not ones."""
    jcfg, tcfg, jp, tp = _pair("chameleon-34b")
    mix_j = jp["segments"][0][0]["mix"]
    assert set(mix_j) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    rng = np.random.default_rng(2)
    hd = jcfg.head_dim
    scales = {n: rng.normal(1.0, 0.3, size=(hd,)).astype(np.float32) for n in ("q_norm", "k_norm")}
    mix_j = dict(mix_j, **{n: {"scale": jnp.asarray(s)} for n, s in scales.items()})
    mix_t = convert.params_from_jax(jax.tree.map(np.asarray, mix_j), device="cpu")
    x = rng.normal(size=(2, 9, jcfg.d_model)).astype(np.float32)
    want, _ = JA.gqa_apply(mix_j, jcfg, jnp.asarray(x))
    got, _ = TA.gqa_apply(mix_t, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL_OUT)
    plain, _ = TA.gqa_apply(mix_t, dataclasses.replace(tcfg, qk_norm=False), torch.from_numpy(x))
    assert (plain - got).abs().max() > 1e-2          # the norms do change the output


@pytest.mark.parametrize("d_model", [256, 2048])
def test_emb_scale_bf16_bit_equal(d_model):
    """gemma's embeddings × √d_model in bf16: JAX rounds the Python float
    to bf16 first (45.25 for √2048), so the port multiplies by that
    rounded constant; a float32 constant would put elements one bf16 ulp
    away."""
    kw = dict(d_model=d_model, vocab_size=512, param_dtype="bfloat16", compute_dtype="bfloat16")
    jcfg, tcfg = jget_config("gemma-2b", reduced=True, **kw), tget_config("gemma-2b", reduced=True, **kw)
    assert tcfg.emb_scale
    rng = np.random.default_rng(3)
    table = np.asarray(jnp.asarray(rng.normal(size=(512, d_model)).astype(np.float32), jnp.bfloat16))
    toks = _tokens(512, 3, 64, seed=3)
    want = np.asarray(JM._embed({"embed": jnp.asarray(table)}, jcfg, jnp.asarray(toks)))
    params = convert.params_from_jax({"embed": table}, device="cpu")
    got = TM._embed(params, tcfg, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    bits = got.view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(bits, want.view(np.uint16))
    if d_model == 2048:     # √2048 is not a bf16 value: the unrounded constant misses
        loose = params["embed"][torch.from_numpy(toks).long()] * float(np.sqrt(d_model))
        assert not np.array_equal(loose.view(torch.int16).numpy().view(np.uint16),
                                  want.view(np.uint16))


def test_unsupported_families_still_raise():
    """No family of the reference is unsupported any more: every reference
    config is registered in the port and builds its model_defs, at full
    size and reduced, with the reference's parameter count. What still
    raises is a name the reference does not have."""
    assert sorted(ARCH_NAMES) == sorted(JARCH_NAMES)
    for name in JARCH_NAMES:
        for reduced in (False, True):
            defs = TM.model_defs(tget_config(name, reduced=reduced))
            assert TP.count_params(defs) == JP.count_params(
                JM.model_defs(jget_config(name, reduced=reduced))), (name, reduced)
    with pytest.raises(KeyError, match="unknown arch"):
        tget_config("whisper-large-v3")


# ---------------------------------------------------------------------------
# Each family: loss and gradients, prefill + decode, greedy generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_every_gradient_match(name):
    jcfg, tcfg, jp, tp = _pair(name)
    toks = _tokens(jcfg.vocab_size, 2, 41, seed=1)      # past mixtral's 32-token window
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    tflat = _tree.flatten_with_path(tg)
    assert len(jflat) == len(tflat)
    for (jpath, a), (tpath, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape, tpath
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


def test_parallel_block_matches():
    """The opt-in PaLM-style block, x + attn(norm1(x)) + mlp(norm2(x)): no
    config uses it, the reference keeps it; loss and gradients."""
    jcfg, tcfg, jp, tp = _pair("gemma-2b", parallel_block=True)
    toks = _tokens(jcfg.vocab_size, 2, 17, seed=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    for a, b in zip(jax.tree.leaves(jg), _tree.leaves(tg)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    serial = TM.loss_fn(tp, dataclasses.replace(tcfg, parallel_block=False),
                        {"tokens": torch.from_numpy(toks)})
    assert abs(serial.item() - tl.item()) > 1e-4     # the two blocks differ


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_four_decode_steps_match(name):
    jcfg, tcfg, jp, tp = _pair(name)
    B, Lp = 2, 40
    toks = _tokens(jcfg.vocab_size, B, Lp, seed=2)
    max_len = Lp + 8
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=max_len)
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    _close(tl, jl)
    _check_caches(tc, jc, Lp)
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    for step in range(4):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _check_caches(tc, jc, Lp + step + 1)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("name", FAMILIES)
def test_generate_greedy_matches(name):
    jcfg, tcfg, jp, tp = _pair(name, seed=1)
    toks = _tokens(jcfg.vocab_size, 2, 36, seed=4)
    ref = jgenerate(jp, jcfg, jnp.asarray(toks), n_new=6)
    got = generate(tp, tcfg, toks, n_new=6)
    assert np.array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(ref.logprobs), atol=ATOL_OUT, rtol=0)


# ---------------------------------------------------------------------------
# Sliding windows: ring caches, the windowed long prefill
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Lp,max_len,steps", [
    (20, 64, 16),    # L < W: written at 0, decode wraps the ring at 32
    (45, 64, 6),     # L >= W: the last 32 positions rolled by L % W
    (32, 40, 3),     # L == W
    (10, 20, 6),     # max_len < W: a full cache with the window mask
], ids=["short", "wrapped", "exact", "full-cache"])
def test_ring_cache_prefill_and_decode_match(Lp, max_len, steps):
    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b", seed=2)
    W = tcfg.window
    toks = _tokens(jcfg.vocab_size, 2, Lp, seed=5)
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=max_len)
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    assert tc[0][0].k.shape[1] == min(W, max_len)
    assert TA._is_ring(tc[0][0], W) == (max_len >= W)
    _close(tl, jl)
    _check_caches(tc, jc, Lp)
    nxt = _tokens(jcfg.vocab_size, 2, steps, seed=6)
    for t in range(steps):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt[:, t:t + 1]))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt[:, t:t + 1]))
        _close(tl, jl)
        _check_caches(tc, jc, Lp + t + 1)


def test_ragged_decode_with_a_ring_raises_as_the_reference():
    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b")
    toks = _tokens(jcfg.vocab_size, 2, 40, seed=7)
    lens = np.asarray([40, 33], np.int32)
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=48, lengths=jnp.asarray(lens))
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=48,
                        lengths=torch.from_numpy(lens))
    _close(tl, jl)                     # a ragged prefill into a ring is allowed
    nxt = _tokens(jcfg.vocab_size, 2, 1, seed=8)
    with pytest.raises(NotImplementedError, match="ring cache"):
        JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt), lengths=jnp.asarray(lens), prompt_len=40)
    with pytest.raises(NotImplementedError, match="ring cache"):
        TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt), lengths=torch.from_numpy(lens),
                       prompt_len=40)


@pytest.mark.parametrize("window", [300, 1024])
def test_windowed_long_prefill_takes_the_flash_op(window):
    """Past 1024 unmasked tokens the port's prefill goes through the flash op
    (its plain version on the CPU) with the window; the reference through
    blockwise_attention. Attention alone, then a 1-layer mixtral prefill."""
    rng = np.random.default_rng(9)
    q = rng.normal(size=(1, 1100, 4, 16)).astype(np.float32)
    k = rng.normal(size=(1, 1100, 2, 16)).astype(np.float32)
    v = rng.normal(size=(1, 1100, 2, 16)).astype(np.float32)
    want = JA.blockwise_attention(*map(jnp.asarray, (q, k, v)), 0, causal=True, window=window)
    got = flash_ops.attention(*map(torch.from_numpy, (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)

    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b", n_layers=1, window=window)
    toks = _tokens(jcfg.vocab_size, 1, 1100, seed=10)
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=1104)
    before = flash_attention.launches
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=1104)
    assert flash_attention.launches == before           # the CPU takes the plain version
    _close(tl, jl)
    _check_caches(tc, jc, 1100)


# ---------------------------------------------------------------------------
# The flash kernel's plain version at the new head dims
# ---------------------------------------------------------------------------

WIDE_CASES = [
    # (B, Lq, Lkv, H, Hkv, hd, causal, window)
    (1, 128, 128, 4, 1, 256, True, None),      # gemma: MQA at hd 256
    (1, 128, 128, 4, 2, 192, True, None),      # nemotron: GQA at hd 192
    (1, 128, 128, 2, 1, 256, True, 48),        # a window
    (1, 64, 128, 2, 2, 192, False, None),      # Lq != Lkv
]


@pytest.mark.parametrize("case", WIDE_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_version_at_wide_head_dims_matches_pallas(case, dtype):
    B, Lq, Lkv, H, Hkv, hd, causal, window = case
    assert hd in HEAD_DIMS
    rng = np.random.default_rng(11)
    arrs = [np.asarray(jnp.asarray(rng.normal(size=s).astype(np.float32), getattr(jnp, dtype)))
            for s in ((B, Lq, H, hd), (B, Lkv, Hkv, hd), (B, Lkv, Hkv, hd))]
    want = np.asarray(jflash_op(*map(jnp.asarray, arrs), causal=causal, window=window,
                                block_q=64, block_kv=64), np.float32)
    got = flash_ops.attention(*(convert.params_from_jax(a, device="cpu") for a in arrs),
                              causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    tol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)


# ---------------------------------------------------------------------------
# Serving: WaveBatcher, ContinuousBatcher
# ---------------------------------------------------------------------------


def test_wave_batcher_mixtral_equal_length_prompts_match():
    """Mixtral waves of equal-length prompts past the window (a ragged wave
    over a ring raises in both, as the reference documents)."""
    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b", seed=3)
    rng = np.random.default_rng(12)
    reqs = [(rng.integers(0, jcfg.vocab_size, size=40).astype(np.int32), n) for n in (3, 6, 5)]
    jwb, twb = JWaveBatcher(jp, jcfg, 2, 64), WaveBatcher(tp, tcfg, 2, 64)
    jids = [jwb.submit(p, n) for p, n in reqs]
    tids = [twb.submit(p, n) for p, n in reqs]
    jdone, tdone = jwb.run_until_done(), twb.run_until_done()
    for jr, tr, (_, n) in zip(jids, tids, reqs):
        assert len(tdone[tr]) == n
        assert np.array_equal(tdone[tr], np.asarray(jdone[jr]))


def _gemma_requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, size=int(rng.integers(2, 11))).astype(np.int32),
             int(rng.integers(1, 9))) for _ in range(n)]


def test_wave_batcher_gemma_ragged_matches():
    jcfg, tcfg, jp, tp = _pair("gemma-2b", seed=4)
    reqs = _gemma_requests(jcfg, 6, seed=13)
    jwb, twb = JWaveBatcher(jp, jcfg, 4, 24), WaveBatcher(tp, tcfg, 4, 24)
    jids = [jwb.submit(p, n) for p, n in reqs]
    tids = [twb.submit(p, n) for p, n in reqs]
    jdone, tdone = jwb.run_until_done(), twb.run_until_done()
    for jr, tr, (_, n) in zip(jids, tids, reqs):
        assert np.array_equal(tdone[tr], np.asarray(jdone[jr]))


def test_continuous_batcher_gemma_matches_reference_generate():
    jcfg, tcfg, jp, tp = _pair("gemma-2b", seed=5)
    reqs = _gemma_requests(jcfg, 6, seed=14)
    cb = ContinuousBatcher(tp, tcfg, 3, 32, page_size=4, max_new=8)
    cb.warmup()
    rids = [cb.submit(p, n) for p, n in reqs]
    cb.run_until_done()
    assert cb.stats()["bucket_misses"] == 0
    for rid, (p, n) in zip(rids, reqs):
        ref = jgenerate(jp, jcfg, jnp.asarray(p[None]), n_new=n, max_len=len(p) + n)
        assert np.array_equal(cb.done[rid], np.asarray(ref.tokens[0]))
        np.testing.assert_allclose(cb.done_logprobs[rid], np.asarray(ref.logprobs[0]),
                                   atol=ATOL_OUT, rtol=0)


def test_continuous_batcher_mixtral_raises_as_the_reference():
    jcfg, tcfg, jp, tp = _pair("mixtral-8x7b")
    with pytest.raises(ValueError, match="use WaveBatcher") as jerr:
        JContinuousBatcher(jp, jcfg, 2, 64, page_size=4)
    with pytest.raises(ValueError, match="use WaveBatcher") as terr:
        ContinuousBatcher(tp, tcfg, 2, 64, page_size=4)
    assert "sliding-window" in str(jerr.value) and "sliding-window" in str(terr.value)
