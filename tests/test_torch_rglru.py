"""The port's RG-LRU hybrid (recurrentgemma-2b) against the JAX reference on
the same weights and inputs.

Config: the reference's reduced recurrentgemma-2b (``get_config(...,
reduced=True)``, float32, 2 layers: one RG-LRU, one local MQA attention
with a 32-token window, d_model 256), and a 3-layer ``scan_layers``
override (R, R, A) whose two RG-LRU layers form a stacked segment. Weights
are made by the reference and moved bit for bit
(``convert.params_from_jax``); inputs come from a numpy seed.

Tolerances. The port's log-depth scan (``rglru.linear_scan``) multiplies
and adds in another order than XLA's ``associative_scan``: on decays and
inputs shaped as the gates make them (a in (0, 1), |h| up to 4) the two
differ by at most 2.4e-7 up to 257 steps (4.8e-7 at 3072), and each stays
within 3.1e-7 of a float64 recurrence; both are held to atol 1e-6, about
two float32 ulps of the largest state. Layer outputs, logits, caches and logprobs
atol 1e-5 and loss and gradients rtol 1e-4 / atol 1e-6, as
``tests/test_torch_families.py`` holds them; greedy tokens must be equal.
"""
import functools

import numpy as np
import pytest
import torch

from _torch_config_parity import assert_config_matches_reference

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import init_state as j_init_state  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.serving import WaveBatcher as JWaveBatcher  # noqa: E402
from repro.serving import generate as jgenerate  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state as t_init_state  # noqa: E402
from repro_torch.core.decentralized import make_train_step as t_make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss, gradients, train step
ATOL_OUT = 1e-5               # layer outputs, logits, caches, logprobs
ATOL_SCAN = 1e-6              # linear_scan against associative_scan and float64
NAME = "recurrentgemma-2b"
SCANNED = dict(n_layers=3, layer_pattern=("rglru", "rglru", "local"), scan_layers=True)


def _pair(seed=0, **overrides):
    jcfg = jget_config(NAME, reduced=True, **overrides)
    tcfg = tget_config(NAME, reduced=True, **overrides)
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


@functools.lru_cache(maxsize=None)
def _jprefill(jcfg, max_len):
    """The reference's prefill, jitted (one compile, not one per op):
    (params, tokens[, lengths]) -> (last logits, caches)."""
    return jax.jit(lambda p, t, lengths=None: JM.prefill(p, jcfg, t, max_len=max_len,
                                                         lengths=lengths)[:2])


@functools.lru_cache(maxsize=None)
def _jdecode(jcfg):
    """The reference's decode_step, jitted: (params, caches, token)."""
    return jax.jit(lambda p, c, t: JM.decode_step(p, jcfg, c, t))


# ---------------------------------------------------------------------------
# Config, the scan, rglru_apply
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_the_reference_field_by_field(reduced):
    assert NAME in ARCH_NAMES
    j, t = jget_config(NAME, reduced=reduced), tget_config(NAME, reduced=reduced)
    assert_config_matches_reference(j, t)
    assert t.n_params() == j.n_params()
    assert TM.plan_segments(t) == [TM.Segment(s.kind, s.moe, s.length, s.scanned)
                                   for s in JM.plan_segments(j)]


@pytest.mark.parametrize("L", [1, 2, 31, 257])
def test_linear_scan_matches_associative_scan(L):
    """h_t = a_t h_{t-1} + b_t against jax.lax.associative_scan of the
    reference's combine, on decays and inputs shaped as _gates makes them."""
    rng = np.random.default_rng(L)
    a = np.exp(-8.0 * np.log1p(np.e) * rng.uniform(size=(2, L, 48))).astype(np.float32)
    b = (np.sqrt(1 - a ** 2) * rng.normal(size=(2, L, 48))).astype(np.float32)

    def combine(c1, c2):
        return c1[0] * c2[0], c2[0] * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(a), jnp.asarray(b)), axis=1)
    got = TR.linear_scan(torch.from_numpy(a), torch.from_numpy(b))
    h, exact = np.zeros((2, 48)), []
    for t in range(L):                                   # the recurrence, float64
        h = a[:, t] * h + b[:, t]
        exact.append(h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_SCAN, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.stack(exact, 1), atol=ATOL_SCAN, rtol=0)


def test_rglru_apply_prefill_then_decode_matches():
    jcfg, tcfg, jp, _ = _pair()
    mj = jp["segments"][0][0]["mix"]
    mt = convert.params_from_jax(jax.tree.map(np.asarray, mj), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 37, jcfg.d_model)).astype(np.float32)
    japply = jax.jit(lambda p, x, c: JR.rglru_apply(p, jcfg, x, cache=c))
    want, _ = japply(mj, jnp.asarray(x), None)
    got, none = TR.rglru_apply(mt, tcfg, torch.from_numpy(x))
    assert none is None
    _close(got, want)
    jc = JR.init_rglru_cache(jcfg, 2, jnp.float32)
    tc = TR.init_rglru_cache(tcfg, 2, torch.float32, torch.device("cpu"))
    want, jc = japply(mj, jnp.asarray(x), jc)
    got, tc = TR.rglru_apply(mt, tcfg, torch.from_numpy(x), cache=tc)
    assert tc.h.dtype == torch.float32
    _close(got, want)
    _check_caches(tc, jc, 37)
    for t in range(4):
        xs = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = japply(mj, jnp.asarray(xs), jc)
        got, tc = TR.rglru_apply(mt, tcfg, torch.from_numpy(xs), cache=tc)
        _close(got, want)
        _check_caches(tc, jc, 38 + t)

def test_params_from_jax_carries_the_tree_leaf_for_leaf():
    """The reference's tree lands on the port's defs: the same paths in JAX
    leaf order, the same shapes, every value bit for bit."""
    jcfg, tcfg, jp, tp = _pair(**SCANNED)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jp)
    tflat = _tree.flatten_with_path(tp)
    dflat = _tree.flatten_with_path(TM.model_defs(tcfg))
    assert len(jflat) == len(tflat) == len(dflat)
    for (jpath, a), (tpath, b), (dpath, d) in zip(jflat, tflat, dflat):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath)
        assert keys == tpath == dpath
        assert tuple(b.shape) == a.shape == d.shape
        assert np.array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# The model: loss and gradients, prefill + decode through the ring, generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_loss_and_every_gradient_match(scanned):
    jcfg, tcfg, jp, tp = _pair(**(SCANNED if scanned else {}))
    toks = _tokens(jcfg.vocab_size, 2, 41, seed=1)      # past the 32-token window
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    tflat = _tree.flatten_with_path(tg)
    assert len(jflat) == len(tflat)
    for (jpath, a), (tpath, b) in zip(jflat, tflat):
        keys = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in jpath)
        assert keys == tpath
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_prefill_and_decode_through_the_ring_match(scanned):
    """A 45-token prompt past the local layer's 32-slot ring, then 6 decode
    steps that wrap it again."""
    jcfg, tcfg, jp, tp = _pair(seed=2, **(SCANNED if scanned else {}))
    B, Lp = 2, 45
    toks = _tokens(jcfg.vocab_size, B, Lp, seed=2)
    jl, jc, *_ = _jprefill(jcfg, 64)(jp, jnp.asarray(toks))
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=64)
    ring = tc[-1][0]
    assert isinstance(ring, TA.KVCache) and TA._is_ring(ring, tcfg.window)
    _close(tl, jl)
    _check_caches(tc, jc, Lp)
    for step in range(6):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(nxt))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _check_caches(tc, jc, Lp + step + 1)


def test_generate_greedy_and_wave_batcher_match():
    """generate() of a (2, 36) prompt, then two WaveBatcher waves of the same
    shape (2 x 36 + 6: the reference compiles its decode loop once)."""
    jcfg, tcfg, jp, tp = _pair(seed=1)
    toks = _tokens(jcfg.vocab_size, 2, 36, seed=4)
    ref = jgenerate(jp, jcfg, jnp.asarray(toks), n_new=6)
    got = generate(tp, tcfg, toks, n_new=6)
    assert np.array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(ref.logprobs), atol=ATOL_OUT, rtol=0)
    reqs = [(t, n) for t, n in zip(_tokens(jcfg.vocab_size, 4, 36, seed=5), (6, 3, 4, 6))]
    jwb, twb = JWaveBatcher(jp, jcfg, 2, 42), WaveBatcher(tp, tcfg, 2, 42)
    jids = [jwb.submit(p, n) for p, n in reqs]
    tids = [twb.submit(p, n) for p, n in reqs]
    jdone, tdone = jwb.run_until_done(), twb.run_until_done()
    for jr, tr, (_, n) in zip(jids, tids, reqs):
        assert len(tdone[tr]) == n
        assert np.array_equal(tdone[tr], np.asarray(jdone[jr]))


def test_ragged_prompts_and_paged_serving_are_refused_as_the_reference():
    jcfg, tcfg, jp, tp = _pair()
    toks = _tokens(jcfg.vocab_size, 2, 12, seed=6)
    lens = np.asarray([12, 7], np.int32)
    with pytest.raises(NotImplementedError, match="pollute rglru recurrent state"):
        jgenerate(jp, jcfg, jnp.asarray(toks), n_new=2, lengths=jnp.asarray(lens))
    with pytest.raises(NotImplementedError, match="pollute rglru recurrent state"):
        generate(tp, tcfg, toks, n_new=2, lengths=lens)
    with pytest.raises(ValueError, match="use WaveBatcher") as err:
        ContinuousBatcher(tp, tcfg, 2, 32, page_size=4)
    assert "rglru" in str(err.value)


# ---------------------------------------------------------------------------
# Training: one decentralized step
# ---------------------------------------------------------------------------


def test_fused_train_step_matches_reference_and_einsum():
    """One decentralized step of eq. (3) on the ring, M = 4, momentum SGD,
    through make_train_step's vmap over workers and the fused bus, against
    the reference's fused step; then the port's einsum step against its
    fused one."""
    M = 4
    jcfg, tcfg, jp, _ = _pair(seed=7)
    p0 = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, size=(M, 2, 41)).astype(np.int32)
    jopt, topt = joptim.momentum_sgd(0.05, 0.9), toptim.momentum_sgd(0.05, 0.9)
    jstep = jax.jit(j_make_train_step(
        lambda p, b: JM.loss_fn(p, jcfg, {"tokens": b}), jopt,
        gossip=JSpec(topology=JT.make("ring", M), backend="fused")))
    tstep = t_make_train_step(
        lambda p, b: TM.loss_fn(p, tcfg, {"tokens": b}), topt,
        gossip=TSpec(topology=TT.make("ring", M), backend="fused"))
    jst = j_init_state(j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt)
    tst = t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M), topt)
    jst, jm = jstep(jst, jnp.asarray(toks))
    tst, tm = tstep(tst, torch.from_numpy(toks))
    for a, b in zip(jax.tree.leaves(jst.params), _tree.leaves(tst.params)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(tm._fields, jm, tm):
        np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL, err_msg=name)
    estep = t_make_train_step(
        lambda p, b: TM.loss_fn(p, tcfg, {"tokens": b}), topt,
        gossip=TSpec(topology=TT.make("ring", M), backend="einsum"))
    est, em = estep(t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M),
                                 topt), torch.from_numpy(toks))
    for a, b in zip(_tree.leaves(tst.params), _tree.leaves(est.params)):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(tm._fields, tm, em):
        np.testing.assert_allclose(b.item(), a.item(), rtol=RTOL, atol=ATOL, err_msg=name)
