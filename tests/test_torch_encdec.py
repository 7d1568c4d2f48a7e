"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
reference on the same weights and inputs.

Configs: the reference's reduced seamless (``get_config(...,
reduced=True)``: float32, 2 encoder and 2 decoder layers, d_model 256, 8
heads of 16, 64 frames), with a ``scan_layers`` override whose layers form
stacked segments on both sides; and a narrow one over 2048 frames, past
the 1024-key threshold, where the reference's encoder takes
``blockwise_attention`` and so does the port's training path, while the
port's prefill takes the flash op (its plain version on the CPU). Weights
are made by the reference and moved bit for bit
(``convert.params_from_jax``); frame embeddings and tokens come from a
numpy seed. Tolerances are ``tests/test_torch_families.py``'s: loss and
gradients rtol 1e-4 / atol 1e-6, the encoder's memory, logits, caches,
cross K/V and logprobs atol 1e-5 (the same float32 arithmetic, summed in
other orders); greedy tokens must be equal.
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
from repro.serving import ContinuousBatcher as JContinuousBatcher  # noqa: E402
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
from repro_torch.serving import ContinuousBatcher, generate  # noqa: E402

RTOL, ATOL = 1e-4, 1e-6       # loss, gradients, train step
ATOL_OUT = 1e-5               # memory, logits, caches, cross K/V, logprobs
NAME = "seamless-m4t-large-v2"
# 2048 frames (two of blockwise_attention's 1024-key chunks) at a narrow width
LONG = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
            encoder_seq=2048)


def _pair(seed=0, **overrides):
    jcfg = jget_config(NAME, reduced=True, **overrides)
    tcfg = tget_config(NAME, reduced=True, **overrides)
    jp = JM.init(jax.random.PRNGKey(seed), jcfg)
    return jcfg, tcfg, jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _inputs(cfg, B, L, seed=0):
    """(frame embeddings (B, encoder_seq, D) float32, tokens (B, L) int32)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(size=(B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return enc, rng.integers(0, cfg.vocab_size, size=(B, L)).astype(np.int32)


def _close(t, j, atol=ATOL_OUT):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


def _check_tree(ttree, jtree, pos=None):
    """Equal structure and leaf shapes, values within ATOL_OUT; Python-int
    cache positions equal ``pos``."""
    tl, jl = _tree.leaves(ttree), jax.tree.leaves(jtree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        if isinstance(t, int):
            assert t == pos and np.all(np.asarray(j) == pos)
        else:
            assert tuple(t.shape) == tuple(j.shape)
            _close(t, j)


def _counting_flash(monkeypatch):
    """Count the model's calls of the flash op (the CPU runs its plain version)."""
    calls = []
    real = TA.flash_ops.attention

    def counted(*args, **kw):
        calls.append(kw.get("causal"))
        return real(*args, **kw)

    monkeypatch.setattr(TA.flash_ops, "attention", counted)
    return calls


@functools.lru_cache(maxsize=None)
def _jencode(jcfg):
    return jax.jit(lambda p, e: JM.encode(p, jcfg, e))


@functools.lru_cache(maxsize=None)
def _jprefill(jcfg, max_len):
    """The reference's prefill, jitted (one compile, not one per op)."""
    return jax.jit(lambda p, t, e: JM.prefill(p, jcfg, t, max_len=max_len, enc_embeds=e))


@functools.lru_cache(maxsize=None)
def _jdecode(jcfg):
    return jax.jit(lambda p, c, t, m, k: JM.decode_step(p, jcfg, c, t, memory=m, cross_kvs=k))


# ---------------------------------------------------------------------------
# Config and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduced,scan", [(False, True), (True, False), (True, True)],
                         ids=["full", "reduced", "reduced-scanned"])
def test_model_defs_equal_the_reference_and_the_tree_carries(reduced, scan):
    """Config field by field; the "encoder" subtree's keys and shapes (stacked
    when scanned) equal the reference's; at the reduced sizes the reference's
    initialised params cross through params_from_jax leaf for leaf."""
    assert NAME in ARCH_NAMES
    jcfg = jget_config(NAME, reduced=reduced, scan_layers=scan)
    tcfg = tget_config(NAME, reduced=reduced, scan_layers=scan)
    assert_config_matches_reference(jcfg, tcfg)
    jdefs = jax.tree_util.tree_flatten_with_path(
        JM.model_defs(jcfg), is_leaf=lambda x: hasattr(x, "shape"))[0]
    tdefs = _tree.flatten_with_path(TM.model_defs(tcfg))
    assert [jax.tree_util.keystr(p) for p, _ in jdefs] == \
        ["".join(f"[{k!r}]" for k in p) for p, _ in tdefs]
    assert [d.shape for _, d in jdefs] == [tuple(d.shape) for _, d in tdefs]
    enc = TM.model_defs(tcfg)["encoder"]
    assert isinstance(enc["layers"], list) != (scan and tcfg.encoder_layers > 1)
    if reduced:
        jp = JM.init(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        for (path, d), t, j in zip(tdefs, _tree.leaves(tp), jax.tree.leaves(jp)):
            assert tuple(t.shape) == d.shape, path
            assert np.array_equal(t.numpy(), np.asarray(j)), path


# ---------------------------------------------------------------------------
# The encoder, training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("long", [False, True], ids=["64-frames", "2048-frames"])
def test_encode_matches(long, monkeypatch):
    """encode() on both routes against the reference's: dense at 64 frames;
    at 2048 frames blockwise (the default) and the flash op (flash=True,
    its plain version here), both against the reference's blockwise."""
    jcfg, tcfg, jp, tp = _pair(**(LONG if long else {}))
    enc, _ = _inputs(tcfg, 2, 1, seed=1)
    want = _jencode(jcfg)(jp, jnp.asarray(enc))
    calls = _counting_flash(monkeypatch)
    _close(TM.encode(tp, tcfg, torch.from_numpy(enc)), want)
    assert calls == []
    _close(TM.encode(tp, tcfg, torch.from_numpy(enc), flash=True), want)
    assert calls == ([False] * tcfg.encoder_layers if long else [])


@pytest.mark.parametrize("scan", [False, True], ids=["list", "scanned"])
def test_loss_and_every_gradient_match(scan, monkeypatch):
    """loss_fn encodes batch["enc_embeds"]; the decoder's cross-attention
    projects the memory itself. The flash op is never called."""
    jcfg, tcfg, jp, tp = _pair(scan_layers=scan)
    enc, toks = _inputs(tcfg, 2, 17, seed=2)
    jl, jg = jax.jit(jax.value_and_grad(lambda p: JM.loss_fn(
        p, jcfg, {"tokens": jnp.asarray(toks), "enc_embeds": jnp.asarray(enc)})))(jp)
    calls = _counting_flash(monkeypatch)
    tg, tl = torch.func.grad_and_value(lambda p: TM.loss_fn(
        p, tcfg, {"tokens": torch.from_numpy(toks), "enc_embeds": torch.from_numpy(enc)}))(tp)
    assert calls == []
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    tflat = _tree.flatten_with_path(tg)
    assert len(jflat) == len(tflat)
    for (_, a), (tpath, b) in zip(jflat, tflat):
        assert tuple(b.shape) == a.shape, tpath
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL,
                                   err_msg=str(tpath))


# ---------------------------------------------------------------------------
# Serving: prefill + decode, generate, the batchers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["list", "scanned", "2048-frames"])
def test_prefill_and_three_decode_steps_match(case, monkeypatch):
    """prefill's four values (last logits, caches, cross_kvs, memory), then
    three decode steps reading the memory and cross K/V. At 2048 frames the
    port's encoder goes through the flash op once per layer."""
    overrides = {"list": {}, "scanned": {"scan_layers": True}, "2048-frames": LONG}[case]
    jcfg, tcfg, jp, tp = _pair(seed=3, **overrides)
    B, Lp, steps = 2, 12, 3
    enc, toks = _inputs(tcfg, B, Lp, seed=4)
    jl, jc, jk, jm = _jprefill(jcfg, Lp + steps)(jp, jnp.asarray(toks), jnp.asarray(enc))
    calls = _counting_flash(monkeypatch)
    tl, tc, tk, tm = TM.prefill(tp, tcfg, torch.from_numpy(toks), max_len=Lp + steps,
                                enc_embeds=torch.from_numpy(enc))
    assert calls == ([False] * tcfg.encoder_layers if case == "2048-frames" else [])
    _close(tl, jl)
    _check_tree(tc, jc, Lp)
    _check_tree(tk, jk)
    _close(tm, jm)
    for step in range(steps):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1))[:, None].astype(np.int32)
        jl, jc = _jdecode(jcfg)(jp, jc, jnp.asarray(nxt), jm, jk)
        tl, tc = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt), memory=tm, cross_kvs=tk)
        _close(tl, jl)
        _check_tree(tc, jc, Lp + step + 1)
    assert len(calls) == (tcfg.encoder_layers if case == "2048-frames" else 0)


def test_decoder_only_prefill_returns_no_memory():
    """The four-tuple for every config: a decoder-only model's cross_kvs and
    memory are None; an encoder-decoder's prefill without frames raises."""
    tcfg = tget_config("granite-3-2b", reduced=True)
    tp = TM.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    logits, caches, cross_kvs, memory = TM.prefill(tp, tcfg, torch.zeros((1, 4), dtype=torch.long))
    assert tuple(logits.shape) == (1, 1, tcfg.vocab_size) and len(caches) == 1
    assert cross_kvs is None and memory is None
    _, scfg, _, sp = _pair()
    with pytest.raises(ValueError, match="enc_embeds"):
        TM.prefill(sp, scfg, torch.zeros((1, 4), dtype=torch.long))


def test_generate_greedy_matches():
    jcfg, tcfg, jp, tp = _pair(seed=5, n_layers=1, encoder_layers=1)
    enc, toks = _inputs(tcfg, 2, 9, seed=6)
    ref = jgenerate(jp, jcfg, jnp.asarray(toks), n_new=6, enc_embeds=jnp.asarray(enc))
    got = generate(tp, tcfg, toks, n_new=6, enc_embeds=enc)
    assert np.array_equal(got.tokens, np.asarray(ref.tokens))
    np.testing.assert_allclose(got.logprobs, np.asarray(ref.logprobs), atol=ATOL_OUT, rtol=0)


def test_continuous_batcher_refuses_as_the_reference():
    jcfg, tcfg, jp, tp = _pair()
    with pytest.raises(ValueError, match="use WaveBatcher") as jerr:
        JContinuousBatcher(jp, jcfg, 2, 32, page_size=4)
    with pytest.raises(ValueError, match="use WaveBatcher") as terr:
        ContinuousBatcher(tp, tcfg, 2, 32, page_size=4)
    assert str(terr.value) == str(jerr.value)
    assert "encoder-decoder cross attention" in str(terr.value)


# ---------------------------------------------------------------------------
# Training: one decentralized step
# ---------------------------------------------------------------------------


def test_fused_train_step_with_frames_matches_reference():
    """One step of eq. (3) on the 2-worker clique (one neighbour
    permutation: gossip_mix's k = 1), momentum SGD, "enc_embeds" in the
    batch beside "tokens", through the fused bus, against the reference's."""
    M = 2
    jcfg, tcfg, jp, _ = _pair(seed=7, n_layers=1, encoder_layers=1)
    p0 = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(8)
    batch = {"tokens": rng.integers(0, tcfg.vocab_size, size=(M, 2, 17)).astype(np.int32),
             "enc_embeds": rng.normal(size=(M, 2, tcfg.encoder_seq, tcfg.d_model))
                              .astype(np.float32)}
    jopt, topt = joptim.momentum_sgd(0.05, 0.9), toptim.momentum_sgd(0.05, 0.9)
    jstep = jax.jit(j_make_train_step(
        lambda p, b: JM.loss_fn(p, jcfg, b), jopt,
        gossip=JSpec(topology=JT.make("clique", M), backend="fused")))
    tstep = t_make_train_step(
        lambda p, b: TM.loss_fn(p, tcfg, b), topt,
        gossip=TSpec(topology=TT.make("clique", M), backend="fused"))
    jst = j_init_state(j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt)
    tst = t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M), topt)
    jst, jm = jstep(jst, jax.tree.map(jnp.asarray, batch))
    before = flash_attention.launches
    tst, tm = tstep(tst, convert.to_device(batch, "cpu"))
    assert flash_attention.launches == before
    for a, b in zip(jax.tree.leaves(jst.params), _tree.leaves(tst.params)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
    for name, a, b in zip(tm._fields, jm, tm):
        np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL, err_msg=name)
