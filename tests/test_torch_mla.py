"""The port's multi-head latent attention (deepseek-v2-lite-16b) against the
JAX reference on the same weights.

Config: the reference's reduced deepseek-v2-lite-16b (``get_config(...,
reduced=True)``, float32, 2 layers: one dense, one MoE with 4 experts,
kv_lora 64, qk 32 + 16, v 32), and a 3-layer ``scan_layers`` override
whose MoE layers form a stacked segment. Weights are made by the reference
and moved bit for bit (``convert.params_from_jax``). Tolerances are those
of ``tests/test_torch_families.py``: loss and gradients rtol 1e-4 / atol
1e-6, layer outputs, logits, caches and logprobs atol 1e-5 (the same
float32 arithmetic, summed in other orders; the paged attention function
returns a layer output, after ``w_uv`` and ``wo``, so it is held there
too); greedy tokens must be equal. The zero-padded v of MLA's flash call is held to the reference's
``blockwise_attention`` at v head dim below qk head dim, float32 2e-5.
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
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
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
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate  # noqa: E402
from repro_torch.serving import kvcache as tkv  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss, gradients, train step
ATOL_OUT = 1e-5               # layer outputs, logits, caches, logprobs
NAME = "deepseek-v2-lite-16b"


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


def _mix(jp, layer=0):
    """The first layer's MLA weights: (jax tree, torch tree)."""
    mj = jp["segments"][layer][0]["mix"]
    return mj, convert.params_from_jax(jax.tree.map(np.asarray, mj), device="cpu")


def _x(cfg, B, L, seed=1):
    return np.random.default_rng(seed).normal(size=(B, L, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# Config and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_equals_the_reference_field_by_field(reduced):
    assert NAME in ARCH_NAMES
    j, t = jget_config(NAME, reduced=reduced), tget_config(NAME, reduced=reduced)
    assert_config_matches_reference(j, t)
    assert t.n_params() == j.n_params()


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_params_from_jax_carries_the_tree_leaf_for_leaf(scanned):
    """The reference's tree lands on the port's defs: the same paths in JAX
    leaf order, the same shapes, every value bit for bit."""
    kw = dict(n_layers=3, scan_layers=True) if scanned else {}
    jcfg, tcfg, jp, tp = _pair(**kw)
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
# mla_apply: training, prefill, absorbed decode, paged attention
# ---------------------------------------------------------------------------


def test_mla_apply_training_matches():
    jcfg, tcfg, jp, _ = _pair()
    mj, mt = _mix(jp)
    x = _x(jcfg, 2, 23)
    want, _ = JA.mla_apply(mj, jcfg, jnp.asarray(x))
    got, cache = TA.mla_apply(mt, tcfg, torch.from_numpy(x))
    assert cache is None
    _close(got, want)


@pytest.mark.parametrize("q_base", [0, 5])
def test_mla_apply_q_base_matches(q_base):
    """``q_base``: a chunk whose first token sits at that position (rope
    positions and causal offset), against the reference's."""
    jcfg, tcfg, jp, _ = _pair()
    mj, mt = _mix(jp)
    x = _x(jcfg, 2, 11)
    want, _ = JA.mla_apply(mj, jcfg, jnp.asarray(x), q_base=q_base)
    got, _ = TA.mla_apply(mt, tcfg, torch.from_numpy(x), q_base=q_base)
    _close(got, want)
    if q_base:
        assert not torch.allclose(got, TA.mla_apply(mt, tcfg, torch.from_numpy(x))[0])


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_mla_apply_prefill_then_absorbed_decode_matches(ragged):
    jcfg, tcfg, jp, _ = _pair()
    mj, mt = _mix(jp)
    B, Lp, S = 3, 11, 16
    lens = np.asarray([11, 7, 4], np.int32) if ragged else None
    jl = jnp.asarray(lens) if ragged else None
    tl = torch.from_numpy(lens) if ragged else None
    x = _x(jcfg, B, Lp)
    jc = JA.init_mla_cache(jcfg, B, S, jnp.float32)
    tc = TA.init_mla_cache(tcfg, B, S, torch.float32, torch.device("cpu"))
    japply = jax.jit(lambda p, x, c, lens: JA.mla_apply(
        p, jcfg, x, cache=c, lengths=lens, prompt_len=Lp if ragged else None))
    want, jc = japply(mj, jnp.asarray(x), jc, jl)
    got, tc = TA.mla_apply(mt, tcfg, torch.from_numpy(x), cache=tc, lengths=tl, prompt_len=Lp)
    _close(got, want)
    _check_caches(tc, jc, Lp)
    for t in range(4):
        xs = _x(jcfg, B, 1, seed=10 + t)
        want, jc = japply(mj, jnp.asarray(xs), jc, jl)
        got, tc = TA.mla_apply(mt, tcfg, torch.from_numpy(xs), cache=tc, lengths=tl,
                               prompt_len=Lp if ragged else None)
        _close(got, want)
        _check_caches(tc, jc, Lp + t + 1)


def test_mla_paged_attention_matches():
    """The absorbed paged decode over shared pools: three slots, tables with
    dump entries, lengths that end mid-page."""
    jcfg, tcfg, jp, _ = _pair()
    mj, mt = _mix(jp)
    rng = np.random.default_rng(3)
    H, dn, dr, r = jcfg.n_heads, jcfg.qk_nope_dim, jcfg.qk_rope_dim, jcfg.kv_lora_rank
    Pn, page, dump = 9, 4, 8
    tables = np.asarray([[4, 0, dump], [2, 7, 5], [1, dump, dump]], np.int32)
    lengths = np.asarray([6, 10, 2], np.int32)
    arrs = [rng.normal(size=s).astype(np.float32) for s in
            ((3, 1, H, dn), (3, 1, H, dr), (Pn, page, r), (Pn, page, dr))]
    scale = 1.0 / np.sqrt(dn + dr)
    want = JA._mla_paged_attention(mj, *map(jnp.asarray, arrs), jnp.asarray(tables),
                                   jnp.asarray(lengths), scale)
    got = TA._mla_paged_attention(mt, *map(torch.from_numpy, arrs), torch.from_numpy(tables),
                                  torch.from_numpy(lengths), scale)
    _close(got, want)


def test_mla_flash_call_pads_v_exactly():
    """The flash op's plain version with v zero-padded from 32 to the qk
    width 48, the padding cut off, against the reference's
    blockwise_attention with dv != dqk; then a 1-layer prefill past 1024
    tokens, the port through the flash op and the reference blockwise."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(1, 1100, 4, 48)).astype(np.float32)
    k = rng.normal(size=(1, 1100, 4, 48)).astype(np.float32)
    v = rng.normal(size=(1, 1100, 4, 32)).astype(np.float32)
    scale = 0.2
    want = JA.blockwise_attention(*map(jnp.asarray, (q, k, v)), 0, causal=True, scale=scale)
    got = TA._mla_flash(*map(torch.from_numpy, (q, k, v)), scale)
    assert tuple(got.shape) == (1, 1100, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)

    jcfg, tcfg, jp, tp = _pair(n_layers=1)
    toks = _tokens(jcfg.vocab_size, 1, 1100, seed=5)
    jl, jc, *_ = _jprefill(jcfg, 1104)(jp, jnp.asarray(toks))
    before = flash_attention.launches
    tl, tc, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=1104)
    assert flash_attention.launches == before            # the CPU takes the plain version
    _close(tl, jl)
    _check_caches(tc, jc, 1100)


# ---------------------------------------------------------------------------
# The model: loss and gradients, prefill + decode, generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_loss_and_every_gradient_match(scanned):
    kw = dict(n_layers=3, scan_layers=True) if scanned else {}
    jcfg, tcfg, jp, tp = _pair(**kw)
    toks = _tokens(jcfg.vocab_size, 2, 33, seed=1)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)})))(jp)
    tg, tl = torch.func.grad_and_value(
        lambda p: TM.loss_fn(p, tcfg, {"tokens": torch.from_numpy(toks)}))(tp)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    tflat = _tree.flatten_with_path(tg)
    assert len(jflat) == len(tflat)
    for (_, a), (tpath, b) in zip(jflat, tflat):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_prefill_and_four_decode_steps_match(scanned):
    kw = dict(n_layers=3, scan_layers=True) if scanned else {}
    jcfg, tcfg, jp, tp = _pair(seed=2, **kw)
    B, Lp = 2, 30
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


@pytest.mark.parametrize("ragged", [False, True], ids=["equal", "ragged"])
def test_generate_greedy_matches(ragged):
    jcfg, tcfg, jp, tp = _pair(seed=1)
    toks = _tokens(jcfg.vocab_size, 2, 20, seed=4)
    lens = np.asarray([20, 13], np.int32) if ragged else None
    ref = jgenerate(jp, jcfg, jnp.asarray(toks), n_new=6,
                    lengths=jnp.asarray(lens) if ragged else None)
    got = generate(tp, tcfg, toks, n_new=6, lengths=lens)
    assert np.array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(ref.logprobs), atol=ATOL_OUT, rtol=0)


def test_wave_batcher_ragged_matches():
    jcfg, tcfg, jp, tp = _pair(seed=3)
    rng = np.random.default_rng(6)
    # two ragged waves of the same padded shape (9 + 5): one reference compile
    reqs = [(rng.integers(0, jcfg.vocab_size, size=n).astype(np.int32), m)
            for n, m in ((9, 5), (6, 3), (4, 2), (9, 5))]
    from repro.serving import WaveBatcher as JWaveBatcher

    jwb, twb = JWaveBatcher(jp, jcfg, 2, 16), WaveBatcher(tp, tcfg, 2, 16)
    jids = [jwb.submit(p, n) for p, n in reqs]
    tids = [twb.submit(p, n) for p, n in reqs]
    jdone, tdone = jwb.run_until_done(), twb.run_until_done()
    for jr, tr, (_, n) in zip(jids, tids, reqs):
        assert len(tdone[tr]) == n
        assert np.array_equal(tdone[tr], np.asarray(jdone[jr]))


# ---------------------------------------------------------------------------
# Continuous batching over the paged MLA cache
# ---------------------------------------------------------------------------


def _requests(cfg, n, max_prompt=10, max_new=8, seed=3):
    """tests/test_serving.py's ragged request mix."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, size=int(rng.integers(2, max_prompt + 1)))
             .astype(np.int32), int(rng.integers(1, max_new + 1))) for _ in range(n)]


def _run(tcfg, tp, reqs, slots=4, max_len=32, page=4, max_new=8):
    cb = ContinuousBatcher(tp, tcfg, slots, max_len, page_size=page, max_new=max_new)
    cb.warmup()
    rids = [cb.submit(p, n) for p, n in reqs]
    cb.run_until_done()
    return cb, rids


@pytest.mark.parametrize("scanned", [False, True], ids=["list", "scanned"])
def test_continuous_bit_matches_unbatched_mla(scanned):
    """The reference's test of the same name: paged MLA with the MoE
    switched off (capacity routing depends on the batch's composition),
    each request bit for bit the unbatched generate() of the same package
    (the port's generate is held to the reference's above); the first
    request also against the reference's generate."""
    kw = dict(n_experts=0, n_shared_experts=0, top_k=0)
    if scanned:
        kw.update(n_layers=2, scan_layers=True)
    jcfg, tcfg, jp, tp = _pair(**kw)
    caches = tkv.init_paged_caches(tcfg, tkv.PagePool(2, 16, 4), "cpu")
    assert isinstance(caches[0] if scanned else caches[0][0], TA.PagedMLACache)
    reqs = _requests(tcfg, 4, max_prompt=7, max_new=4)
    cb, rids = _run(tcfg, tp, reqs, slots=2, max_len=16, max_new=4)
    assert cb.stats()["bucket_misses"] == 0
    for rid, (p, n) in zip(rids, reqs):
        ref = generate(tp, tcfg, p[None], n_new=n, max_len=len(p) + n)
        assert np.array_equal(ref.tokens[0], cb.done[rid]), rid
        np.testing.assert_allclose(cb.done_logprobs[rid], ref.logprobs[0], atol=ATOL_OUT, rtol=0)
    p, n = reqs[0]
    ref = jgenerate(jp, jcfg, jnp.asarray(p[None]), n_new=n, max_len=len(p) + n)
    assert np.array_equal(np.asarray(ref.tokens[0]), cb.done[rids[0]])


def test_continuous_moe_serves_all_and_is_deterministic():
    """The reference's test of the same name (slow there, not here): with
    the MoE on, every request served in full and two runs equal."""
    _, tcfg, _, tp = _pair()
    reqs = _requests(tcfg, 6, max_prompt=7, max_new=6)
    cb1, rids1 = _run(tcfg, tp, reqs, max_len=16, max_new=6)
    cb2, rids2 = _run(tcfg, tp, reqs, max_len=16, max_new=6)
    assert len(cb1.done) == len(reqs)
    for r1, r2, (_, n) in zip(rids1, rids2, reqs):
        assert cb1.done[r1].shape == (n,)
        assert np.array_equal(cb1.done[r1], cb2.done[r2])


def test_paged_mla_decode_steps_match_reference():
    """Admission into the paged MLA cache, then decode steps through it,
    against the reference's scatter_prefill and paged decode on the same
    pools (the dump page, garbage by design, left out)."""
    from repro.serving import kvcache as jkv

    jcfg, tcfg, jp, tp = _pair(seed=5, n_experts=0, n_shared_experts=0, top_k=0)
    slots, max_len, page = 2, 16, 4
    jpool, tpool = jkv.PagePool(slots, max_len, page), tkv.PagePool(slots, max_len, page)
    jc, tc = jkv.init_paged_caches(jcfg, jpool), tkv.init_paged_caches(tcfg, tpool, "cpu")
    toks = _tokens(jcfg.vocab_size, 2, 8, seed=7)
    lens = np.asarray([8, 5], np.int32)
    rows = np.stack([jpool.admit(s, 12) for s in range(2)])
    assert np.array_equal(rows, np.stack([tpool.admit(s, 12) for s in range(2)]))
    ids = rows[:, :2]
    jl, jd = _jprefill(jcfg, 8)(jp, jnp.asarray(toks), lengths=jnp.asarray(lens))
    tl, td, *_ = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=8,
                        lengths=torch.from_numpy(lens))
    _close(tl, jl)
    jc = jkv.scatter_prefill(jcfg, jc, jd, jnp.arange(2), jnp.asarray(ids),
                             jnp.asarray(rows), jnp.asarray(lens))
    tkv.scatter_prefill(tcfg, tc, td, torch.arange(2), torch.from_numpy(ids).long(),
                        torch.from_numpy(rows), torch.from_numpy(lens))
    nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    for _ in range(3):
        jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(nxt))
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        _close(tl, jl)
        jc = jkv.bump_lengths(jcfg, jc, jnp.ones((2,), jnp.int32))
        tkv.bump_lengths(tcfg, tc, torch.ones((2,), dtype=torch.int32))
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
    for t, j in zip(_tree.leaves(tc), jax.tree.leaves(jc)):
        t, j = t.numpy(), np.asarray(j)
        if t.ndim == 3:                                   # pools: leave out the dump page
            t, j = t[:jpool.dump], j[:jpool.dump]
        np.testing.assert_allclose(t, j, atol=ATOL_OUT, rtol=0)
    tkv.retire_slot(tcfg, tc, 1, dump=tpool.dump)
    tkv.clear_paged_caches(tcfg, tc, tpool.dump)
    assert all(not t.any() for t in (tc[0][0].ckv_pages, tc[0][0].kr_pages, tc[0][0].lengths))


# ---------------------------------------------------------------------------
# Training: one fused decentralized step
# ---------------------------------------------------------------------------


def test_fused_train_step_matches_reference_and_einsum():
    """One decentralized step of eq. (3) on the ring, M = 4, momentum SGD,
    through make_train_step's vmap over workers and the fused bus, against
    the reference's fused step; then the port's einsum step against its
    fused one."""
    M = 4
    jcfg, tcfg, jp, _ = _pair(seed=7)
    p0 = jax.tree.map(np.asarray, jp)
    toks = np.random.default_rng(8).integers(0, tcfg.vocab_size, size=(M, 2, 17)).astype(np.int32)
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
