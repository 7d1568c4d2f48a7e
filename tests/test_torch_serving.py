"""The port's serving path against the JAX reference on the same weights.

Reduced granite in float32 (``get_config(..., reduced=True)``), weights made
by the reference and moved bit for bit. Tolerances: logits and caches atol
1e-5 (float32 on both sides; matmuls and softmax sum in other orders, which
moves the last bits), logprobs atol 1e-5; greedy tokens must be equal.

A prompt longer than 1024 takes the long-kv prefill route on both sides:
the reference's ``blockwise_attention``, the port's flash op (its plain
version on the CPU). Sampled decoding draws from a ``torch.Generator``,
which cannot give the numbers ``jax.random`` gives for the same seed, so it
is held to determinism under a seed, not to the reference's tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import WaveBatcher as JWaveBatcher  # noqa: E402
from repro.serving import generate as jgenerate  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import WaveBatcher, generate, make_serve_step  # noqa: E402

ATOL = 1e-5


def _pair(seed=0, **overrides):
    jcfg = jget_config("granite-3-2b", reduced=True, **overrides)
    tcfg = tget_config("granite-3-2b", reduced=True, **overrides)
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B, L, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L)).astype(np.int32)


def _requests(cfg, n, max_prompt=10, max_new=8, seed=3):
    """tests/test_serving.py's ragged request mix."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(2, max_prompt + 1)))
             .astype(np.int32),
             int(rng.integers(1, max_new + 1))) for _ in range(n)]


def _close(t, j, atol=ATOL):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


def _check_caches(tcaches, jcaches, pos):
    """Every layer's k/v equal to the reference's, and the position."""
    tl, jl = _tree.leaves(tcaches), jax.tree.leaves(jcaches)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        if isinstance(t, int):
            assert t == pos and np.all(np.asarray(j) == pos)
        else:
            _close(t, j)


@pytest.mark.parametrize("Lp,scanned", [(9, False), (9, True), (2048, False)])
def test_prefill_and_decode_match_reference(Lp, scanned):
    """Prefill then two decode steps: logits and caches. Lp = 2048 takes the
    long-kv route; scanned=True is a 2-layer scan_layers override, whose
    cache is stacked on a leading layer dim."""
    jcfg, tcfg, jp, tp = _pair(scan_layers=scanned)
    B = 2 if Lp < 1024 else 1
    toks = _tokens(jcfg.vocab_size, B, Lp)
    max_len = Lp + 4
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=max_len)
    before = flash_attention.launches
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=max_len)
    assert flash_attention.launches == before           # the CPU takes the plain version
    _close(tl, jl)
    _check_caches(tc, jc, Lp)
    if scanned:
        assert tc[0].k.shape == (tcfg.n_layers, B, max_len, tcfg.n_kv_heads, tcfg.head_dim)
        assert tc[0].k[0].data_ptr() != tc[0].k[1].data_ptr()   # real storage per layer
    nxt = _tokens(jcfg.vocab_size, B, 1, seed=1)
    for step in range(2):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _check_caches(tc, jc, Lp + step + 1)
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)


def test_ragged_prefill_and_decode_match_reference():
    jcfg, tcfg, jp, tp = _pair()
    lens = np.asarray([2, 5, 9, 12, 1], np.int32)
    Lb = 12
    toks = _tokens(jcfg.vocab_size, len(lens), Lb, seed=1)
    jl, jc, *_ = JM.prefill(jp, jcfg, jnp.asarray(toks), max_len=Lb + 4,
                            lengths=jnp.asarray(lens))
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=Lb + 4,
                        lengths=torch.from_numpy(lens))
    _close(tl, jl)
    nxt = _tokens(jcfg.vocab_size, len(lens), 1, seed=2)
    for _ in range(2):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt), lengths=jnp.asarray(lens),
                                prompt_len=Lb)
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt),
                                lengths=torch.from_numpy(lens), prompt_len=Lb)
        _close(tl, jl)
        _check_caches(tc, jc, tc[0][0].pos)


@pytest.mark.parametrize("Lp", [7, 1100])
def test_generate_greedy_matches_reference(Lp):
    jcfg, tcfg, jp, tp = _pair(n_layers=1) if Lp > 1024 else _pair()
    toks = _tokens(jcfg.vocab_size, 2 if Lp < 1024 else 1, Lp, seed=4)
    ref = jgenerate(jp, jcfg, jnp.asarray(toks), n_new=6)
    got = generate(tp, tcfg, toks, n_new=6)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == ref.tokens.shape
    assert np.array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(ref.logprobs), atol=ATOL, rtol=0)


def test_wave_batcher_ragged_matches_reference():
    jcfg, tcfg, jp, tp = _pair()
    reqs = _requests(jcfg, 7)
    jwb = JWaveBatcher(jp, jcfg, 4, 24)
    twb = WaveBatcher(tp, tcfg, 4, 24)
    jids = [jwb.submit(p, n) for p, n in reqs]
    tids = [twb.submit(p, n) for p, n in reqs]
    jdone, tdone = jwb.run_until_done(), twb.run_until_done()
    for jr, tr, (_, n) in zip(jids, tids, reqs):
        assert len(tdone[tr]) == n
        assert np.array_equal(tdone[tr], np.asarray(jdone[jr]))


def test_wave_batcher_matches_unbatched_generate():
    _, tcfg, _, tp = _pair()
    reqs = _requests(tcfg, 5, seed=7)
    wb = WaveBatcher(tp, tcfg, 4, 24)
    rids = [wb.submit(p, n) for p, n in reqs]
    wb.run_until_done()
    for rid, (p, n) in zip(rids, reqs):
        solo = generate(tp, tcfg, p[None], n_new=n)
        assert np.array_equal(solo.tokens[0], wb.done[rid])


def test_sampled_decoding_is_deterministic_under_a_seed():
    """torch.Generator draws, not jax.random's: the same seed gives the same
    tokens, another seed other tokens; logprobs are those of the drawn tokens."""
    _, tcfg, _, tp = _pair()
    toks = _tokens(tcfg.vocab_size, 2, 5, seed=5)
    a = generate(tp, tcfg, toks, n_new=12, temperature=1.0, seed=3)
    b = generate(tp, tcfg, toks, n_new=12, temperature=1.0, seed=3)
    c = generate(tp, tcfg, toks, n_new=12, temperature=1.0, seed=4)
    assert np.array_equal(a.tokens, b.tokens) and np.array_equal(a.logprobs, b.logprobs)
    assert not np.array_equal(a.tokens, c.tokens)
    greedy = generate(tp, tcfg, toks, n_new=1)
    first = generate(tp, tcfg, toks, n_new=1, temperature=1.0, seed=3)
    assert np.isfinite(a.logprobs).all() and (a.logprobs <= 0).all()
    assert first.logprobs[0, 0] <= greedy.logprobs[0, 0]     # greedy takes the max


def test_serve_step_is_decode_step():
    _, tcfg, _, tp = _pair()
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, 2, 6))
    _, c1, *_ = TM.prefill(tp, tcfg, toks, max_len=8)
    _, c2, *_ = TM.prefill(tp, tcfg, toks, max_len=8)
    nxt = toks[:, -1:]
    a, _ = make_serve_step(tcfg)(tp, c1, nxt)
    b, _ = TM.decode_step(tp, tcfg, c2, nxt)
    assert torch.equal(a, b)


def test_forward_without_caches_is_the_training_path():
    """forward() with no caches returns no caches and the same hidden states
    as a prefill (which writes caches in place)."""
    _, tcfg, _, tp = _pair()
    toks = torch.from_numpy(_tokens(tcfg.vocab_size, 2, 6))
    h, none = TM.forward(tp, tcfg, toks)
    assert none is None
    caches = TM.init_cache(tp, tcfg, 2, 8)
    h2, new = TM.forward(tp, tcfg, toks, caches=caches, prompt_len=6)
    torch.testing.assert_close(h, h2, atol=1e-6, rtol=0)
    assert [x for x in _tree.leaves(new) if isinstance(x, int)] == [6] * tcfg.n_layers
    assert new[0][0].k.data_ptr() == caches[0][0].k.data_ptr()     # written in place
    cfg_bf16 = dataclasses.replace(tcfg, compute_dtype="bfloat16")
    assert TM.init_cache(tp, cfg_bf16, 1, 4)[0][0].k.dtype == torch.bfloat16
