"""The port's Mamba-2 (mamba2-2.7b) against the JAX reference on the same
weights and inputs.

Config: the reference's reduced mamba2-2.7b (``get_config(...,
reduced=True)``, float32, 2 layers, d_model 256, d_inner 512, 32 heads of
16, state 16, chunk 32), and a ``scan_layers`` override whose two layers
form a stacked segment. Weights are made by the reference and moved bit
for bit (``convert.params_from_jax``); inputs come from a numpy seed.
Tolerances, all float32 with sums in other orders (the reference's
four-operand einsum taken as two products, its chunk scan as a loop):
layer outputs, logits, caches and logprobs atol 1e-5 as
``tests/test_torch_families.py`` holds them, plus rtol 1e-5 because the
SSM state grows to |11| here, where one float32 rounding is ~1e-6;
``ssd_chunked`` on raw unit-normal inputs (outputs up to |30|, sums of up
to 96 terms) and its gradients rtol 1e-4 / atol 1e-5; loss and gradients
of the model rtol 1e-4 / atol 1e-6; greedy tokens must be equal.
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
from repro.models import ssm as JS  # noqa: E402
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
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss, gradients, train step
ATOL_OUT, RTOL_OUT = 1e-5, 1e-5   # layer outputs, logits, caches, logprobs
RTOL_SSD, ATOL_SSD = 1e-4, 1e-5   # ssd_chunked on raw inputs, and its gradients
NAME = "mamba2-2.7b"


def _pair(seed=0, **overrides):
    jcfg = jget_config(NAME, reduced=True, **overrides)
    tcfg = tget_config(NAME, reduced=True, **overrides)
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(vocab, B, L, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, L)).astype(np.int32)


def _close(t, j, atol=ATOL_OUT, rtol=RTOL_OUT):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=rtol)


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


def _ssd_inputs(b, l, h, p, g, n, seed):
    """x, dt (positive), A (negative), B, C as the model makes them."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, l, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,))).astype(np.float32)
    B = rng.normal(size=(b, l, g, n)).astype(np.float32)
    C = rng.normal(size=(b, l, g, n)).astype(np.float32)
    return x, dt, A, B, C


# ---------------------------------------------------------------------------
# Config, _segsum, ssd_chunked
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_the_reference_field_by_field(reduced):
    assert NAME in ARCH_NAMES
    j, t = jget_config(NAME, reduced=reduced), tget_config(NAME, reduced=reduced)
    assert_config_matches_reference(j, t)
    assert t.n_params() == j.n_params()
    assert (t.d_inner, t.ssm_nheads) == (j.d_inner, j.ssm_nheads)


def test_segsum_matches_with_minus_inf_above_the_diagonal():
    dA = -np.abs(np.random.default_rng(0).normal(size=(2, 3, 7))).astype(np.float32)
    want = np.asarray(JS._segsum(jnp.asarray(dA)))
    got = TS._segsum(torch.from_numpy(dA)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isneginf(got[..., 0, 1]).all()
    assert np.isfinite(np.diagonal(got, axis1=-2, axis2=-1)).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6, rtol=0)


@pytest.mark.parametrize("l,chunk,g", [(32, 32, 1), (96, 32, 1), (40, 8, 2)],
                         ids=["one-chunk", "three-chunks", "groups"])
def test_ssd_chunked_matches(l, chunk, g):
    x, dt, A, B, C = _ssd_inputs(2, l, 4, 8, g, 16, seed=l)
    jy, jfinal = JS.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    ty, tfinal = TS.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)), chunk)
    assert ty.dtype == tfinal.dtype == torch.float32
    _close(ty, jy, ATOL_SSD, RTOL_SSD)
    _close(tfinal, jfinal, ATOL_SSD, RTOL_SSD)


def test_ssd_chunked_gradients_are_finite_and_match():
    """The -inf above _segsum's diagonal must give 0, not NaN, in the
    backward pass, in both packages."""
    x, dt, A, B, C = _ssd_inputs(1, 64, 4, 8, 1, 16, seed=5)
    w = np.random.default_rng(6).normal(size=(1, 64, 4, 8)).astype(np.float32)
    wf = np.random.default_rng(7).normal(size=(1, 4, 8, 16)).astype(np.float32)

    def jloss(*args):
        y, final = JS.ssd_chunked(*args, 16)
        return jnp.sum(y * w) + jnp.sum(final * wf)

    def tloss(*args):
        y, final = TS.ssd_chunked(*args, 16)
        return torch.sum(y * torch.from_numpy(w)) + torch.sum(final * torch.from_numpy(wf))

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, (x, dt, A, B, C)))
    tg = torch.func.grad(tloss, argnums=(0, 1, 2, 3, 4))(*map(torch.from_numpy, (x, dt, A, B, C)))
    for a, b in zip(jg, tg):
        assert np.isfinite(np.asarray(a)).all() and bool(torch.isfinite(b).all())
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL_SSD, atol=ATOL_SSD)


# ---------------------------------------------------------------------------
# mamba2_apply: the chunk rule, prefill, recurrent decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("L", [64, 45, 20], ids=["multiple", "not-multiple", "below-chunk"])
def test_mamba2_apply_prefill_then_recurrent_decode_matches(L):
    """L a multiple of the chunk (32), not a multiple (padded with dt = 0),
    and below it (one chunk of L): the output, the conv tail and the final
    state, then 4 O(1) decode steps from that cache."""
    jcfg, tcfg, jp, _ = _pair()
    mj = jp["segments"][0][0]["mix"]
    mt = convert.params_from_jax(jax.tree.map(np.asarray, mj), device="cpu")
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, jcfg.d_model)).astype(np.float32)
    japply = jax.jit(lambda p, x, c: JS.mamba2_apply(p, jcfg, x, cache=c))
    want, _ = japply(mj, jnp.asarray(x), None)
    got, none = TS.mamba2_apply(mt, tcfg, torch.from_numpy(x))
    assert none is None
    _close(got, want)
    jc = JS.init_mamba_cache(jcfg, 2, jnp.float32)
    tc = TS.init_mamba_cache(tcfg, 2, torch.float32, torch.device("cpu"))
    want, jc = japply(mj, jnp.asarray(x), jc)
    got, tc = TS.mamba2_apply(mt, tcfg, torch.from_numpy(x), cache=tc)
    assert tc.state.dtype == torch.float32
    _close(got, want)
    _check_caches(tc, jc, L)
    for t in range(4):
        xs = rng.normal(size=(2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = japply(mj, jnp.asarray(xs), jc)
        got, tc = TS.mamba2_apply(mt, tcfg, torch.from_numpy(xs), cache=tc)
        _close(got, want)
        _check_caches(tc, jc, L + t + 1)

def test_params_from_jax_carries_the_tree_leaf_for_leaf():
    """The reference's tree lands on the port's defs: the same paths in JAX
    leaf order, the same shapes, every value bit for bit."""
    jcfg, tcfg, jp, tp = _pair(**dict(scan_layers=True))
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
# The model: loss and gradients, prefill + decode, generate, ragged refusal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_loss_and_every_gradient_match(scanned):
    jcfg, tcfg, jp, tp = _pair(scan_layers=scanned)
    toks = _tokens(jcfg.vocab_size, 2, 41, seed=1)      # 40 positions: a padded last chunk
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
        assert bool(torch.isfinite(b).all()), tpath
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_prefill_and_four_decode_steps_match(scanned):
    jcfg, tcfg, jp, tp = _pair(seed=2, scan_layers=scanned)
    B, Lp = 2, 70
    toks = _tokens(jcfg.vocab_size, B, Lp, seed=2)
    jl, jc, *_ = _jprefill(jcfg, Lp + 8)(jp, jnp.asarray(toks))
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=Lp + 8)
    _close(tl, jl)
    _check_caches(tc, jc, Lp)
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(nxt))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        _check_caches(tc, jc, Lp + step + 1)


def test_decode_equals_a_reprefill_of_the_extended_sequence():
    """The recurrent decode and the chunked form compute the same function:
    8 decode steps after a prefill against one prefill of the whole
    sequence (the chip run's check, at float32 here)."""
    _, tcfg, _, tp = _pair(seed=3)
    toks = _tokens(tcfg.vocab_size, 2, 40, seed=3)
    logits, caches, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks[:, :32]), max_len=40)
    for t in range(32, 40):
        logits, caches = TM.decode_step(tp, tcfg, caches, torch.from_numpy(toks[:, t:t + 1]))
    again, _, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=40)
    _close(logits, again.numpy())


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
    with pytest.raises(NotImplementedError, match="pollute mamba2 recurrent state"):
        jgenerate(jp, jcfg, jnp.asarray(toks), n_new=2, lengths=jnp.asarray(lens))
    with pytest.raises(NotImplementedError, match="pollute mamba2 recurrent state"):
        generate(tp, tcfg, toks, n_new=2, lengths=lens)
    twb = WaveBatcher(tp, tcfg, 2, 24)
    twb.submit(toks[0], 2)
    twb.submit(toks[1, :7], 2)
    with pytest.raises(NotImplementedError, match="pollute mamba2 recurrent state"):
        twb.run_wave()
    with pytest.raises(ValueError, match="use WaveBatcher"):
        ContinuousBatcher(tp, tcfg, 2, 32, page_size=4)


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
