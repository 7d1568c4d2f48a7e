"""The port's continuous-batching plane against the JAX reference.

Paged KV cache, paged decode attention and ``ContinuousBatcher`` on the
CPU, on the reference's own weights (``convert.params_from_jax``). Config:
reduced granite in float32, list segments, and a 2-layer ``scan_layers``
override whose paged caches are stacked on a leading layer dim.

Tolerances: the paged functions atol 1e-6 (float32, small sums in another
order), decode logits atol 1e-5 as ``tests/test_torch_serving.py`` holds
them, logprobs atol 1e-5; greedy tokens must be equal. The dump page's
content is garbage by design (the reference keeps whichever duplicate
write lands last), so cache comparisons leave it out. Sampled decoding
draws from a ``torch.Generator``, so it is held to determinism under a
seed, not to the reference's tokens.
"""
import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving import generate as jgenerate  # noqa: E402
from repro.serving import kvcache as jkv  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import (ContinuousBatcher, PagePool, WaveBatcher, generate,  # noqa: E402
                                  supports_paged)
from repro_torch.serving import kvcache as tkv  # noqa: E402
from repro_torch.serving.batcher import default_buckets  # noqa: E402

ATOL_FN = 1e-6
ATOL = 1e-5


@pytest.fixture(scope="module")
def ref_params():
    """The reference's weights, made once (list segments)."""
    jcfg = jget_config("granite-3-2b", reduced=True)
    return JM.init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module", params=[False, True], ids=["list", "scanned"])
def pair(request, ref_params):
    """(jax cfg, torch cfg, jax params, torch params); scanned = the 2-layer
    scan_layers override, its layers the list weights stacked."""
    scanned = request.param
    jcfg = jget_config("granite-3-2b", reduced=True, scan_layers=scanned)
    tcfg = tget_config("granite-3-2b", reduced=True, scan_layers=scanned)
    jp = dict(ref_params)
    if scanned:
        jp["segments"] = [jax.tree.map(lambda *xs: jnp.stack(xs), *ref_params["segments"][0])]
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def ref_generate(ref_params):
    """The reference's unbatched generate() on the list weights, memoized:
    its tokens do not depend on how the port stacks the same weights."""
    jcfg = jget_config("granite-3-2b", reduced=True)
    memo = {}

    def run(p, n):
        key = (p.tobytes(), n)
        if key not in memo:
            memo[key] = jgenerate(ref_params, jcfg, jnp.asarray(p[None]), n_new=n,
                                  max_len=len(p) + n)
        return memo[key]

    return run


def _requests(cfg, n, max_prompt=10, max_new=8, seed=3):
    """tests/test_serving.py's ragged request mix."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size,
                          size=int(rng.integers(2, max_prompt + 1)))
             .astype(np.int32),
             int(rng.integers(1, max_new + 1))) for _ in range(n)]


def _run(tcfg, tp, reqs, slots=4, max_len=32, page=4, max_new=8, **kw):
    cb = ContinuousBatcher(tp, tcfg, slots, max_len, page_size=page, max_new=max_new, **kw)
    cb.warmup()
    rids = [cb.submit(p, n) for p, n in reqs]
    cb.run_until_done()
    return cb, rids


def _close(t, j, atol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32),
                               atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# PagePool
# ---------------------------------------------------------------------------


def test_pagepool_admit_retire_invariants():
    pool = PagePool(slots=3, max_len=16, page_size=4)
    assert pool.nb == 4 and pool.n_pages == 13 and pool.dump == 12
    row = pool.admit(0, 6)                     # 2 pages, tail = dump
    assert (row[:2] != pool.dump).all() and (row[2:] == pool.dump).all()
    assert np.array_equal(pool.tables[0], row)
    with pytest.raises(RuntimeError):
        pool.admit(0, 4)                       # double admission
    with pytest.raises(ValueError):
        pool.admit(1, 17)                      # > max_len
    used = set(row[:2].tolist())
    pool.retire(0)
    assert (pool.tables[0] == pool.dump).all()
    assert used <= set(pool.free)              # pages returned for reuse
    rows = [pool.admit(s, 16) for s in range(3)]
    ids = [p for r in rows for p in r.tolist()]
    assert len(ids) == len(set(ids)) == 12 and pool.dump not in ids


def test_pagepool_tables_equal_reference_pool():
    """One admit/retire sequence through both pools: the same rows, tables
    and free lists at every step."""
    tp, jp = PagePool(4, 20, 4), jkv.PagePool(4, 20, 4)
    seq = [("admit", 0, 7), ("admit", 1, 20), ("admit", 2, 1), ("retire", 1, 0),
           ("admit", 3, 13), ("retire", 0, 0), ("admit", 1, 9), ("admit", 0, 4),
           ("retire", 2, 0), ("retire", 3, 0)]
    for op, slot, n in seq:
        if op == "admit":
            assert np.array_equal(tp.admit(slot, n), jp.admit(slot, n))
        else:
            tp.retire(slot)
            jp.retire(slot)
        assert np.array_equal(tp.tables, jp.tables)
        assert tp.free == jp.free and tp.owned == jp.owned
    assert default_buckets(16, 2048) == [16, 32, 64, 128, 256, 512, 1024, 2048]


# ---------------------------------------------------------------------------
# Paged functions against the reference's
# ---------------------------------------------------------------------------

# S = 3 slots, page 4, NB = 3 blocks, P = 10 pages (9 + the dump page, 9)
PAGE, NB, DUMP = 4, 3, 9
TABLES = np.asarray([[4, 0, DUMP], [2, 7, 5], [8, DUMP, DUMP]], np.int32)


def _pools(Kh=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = (DUMP + 1, PAGE, Kh, hd)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


def test_paged_write_matches_reference():
    """Slots 0-1 write into their own pages, slot 2 (retired: its row all
    dump, length 0) into the dump page."""
    k, _ = _pools()
    tables = TABLES.copy()
    tables[2] = DUMP
    lengths = np.asarray([5, 11, 0], np.int32)
    new = np.random.default_rng(1).normal(size=(3, 1, 2, 8)).astype(np.float32)
    ref = JA._paged_write(jnp.asarray(k), jnp.asarray(tables), jnp.asarray(lengths),
                          jnp.asarray(new))
    got = torch.from_numpy(k.copy())
    TA._paged_write(got, torch.from_numpy(tables), torch.from_numpy(lengths),
                    torch.from_numpy(new))
    _close(got, ref, ATOL_FN)
    assert not np.array_equal(got.numpy(), k)


@pytest.mark.parametrize("G", [1, 2])
def test_paged_decode_attention_matches_reference(G):
    """Kh 2, hd 8; the tables hold dump entries past each slot's pages, and
    lengths stop inside the last allocated page (slot 1 on its very last
    position)."""
    Kh, hd = 2, 8
    kp, vp = _pools(Kh, hd)
    q = np.random.default_rng(2).normal(size=(3, 1, Kh * G, hd)).astype(np.float32)
    lengths = np.asarray([5, 11, 2], np.int32)
    ref = JA.paged_decode_attention(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                    jnp.asarray(TABLES), jnp.asarray(lengths))
    got = TA.paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp, vp, TABLES,
                                                                    lengths)))
    assert got.shape == (3, 1, Kh * G, hd)
    _close(got, ref, ATOL_FN)
    # the dump page's content is never read
    kp2, vp2 = kp.copy(), vp.copy()
    kp2[DUMP], vp2[DUMP] = 1e3, -1e3
    again = TA.paged_decode_attention(*(torch.from_numpy(a) for a in (q, kp2, vp2, TABLES,
                                                                      lengths)))
    assert torch.equal(got, again)


def _both_paged(jcfg, tcfg, slots, max_len, page):
    jpool, tpool = jkv.PagePool(slots, max_len, page), PagePool(slots, max_len, page)
    return (jpool, jkv.init_paged_caches(jcfg, jpool),
            tpool, tkv.init_paged_caches(tcfg, tpool, "cpu"))


def _check_paged(tcaches, jcaches, dump, atol=ATOL_FN):
    """Every layer's pools (the dump page left out), tables and lengths."""
    tl, jl = _tree.leaves(tcaches), jax.tree.leaves(jcaches)
    assert len(tl) == len(jl) == 4 * (1 if isinstance(tcaches[0], tuple) else len(tcaches[0]))
    for t, j in zip(tl, jl):
        j = np.asarray(j)
        assert tuple(t.shape) == j.shape
        if t.dtype == torch.int32:
            assert np.array_equal(t.numpy(), j)
        else:
            keep = [i for i in range(t.shape[-4]) if i != dump]
            _close(t[..., keep, :, :, :], j[..., keep, :, :, :], atol)


def test_scatter_retire_bump_match_reference(pair):
    """A group of 2 admissions (one short prompt padded onto the dump page),
    a bump, a retire, a bump: the caches equal the reference's after each."""
    jcfg, tcfg, _, _ = pair
    page, Lb = 4, 8
    jpool, jc, tpool, tc = _both_paged(jcfg, tcfg, 3, 16, page)
    if tcfg.scan_layers:
        assert tc[0].k_pages.shape[0] == tcfg.n_layers
        assert tc[0].k_pages[0].data_ptr() != tc[0].k_pages[1].data_ptr()
    rng = np.random.default_rng(4)
    slots, lens, n_new = [2, 0], np.asarray([7, 3], np.int32), [5, 1]
    rows = np.stack([tpool.admit(s, n + m) for s, n, m in zip(slots, lens, n_new)])
    for s, n, m in zip(slots, lens, n_new):
        jpool.admit(s, n + m)
    ids = rows[:, :Lb // page]
    assert (ids == tpool.dump).any()
    shape = (2, Lb, tcfg.n_kv_heads, tcfg.head_dim)
    dense_np = [(rng.normal(size=shape).astype(np.float32),
                 rng.normal(size=shape).astype(np.float32)) for _ in range(tcfg.n_layers)]
    if tcfg.scan_layers:
        k = np.stack([d[0] for d in dense_np])
        v = np.stack([d[1] for d in dense_np])
        jd = [JA.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(Lb))]
        td = [TA.KVCache(torch.from_numpy(k), torch.from_numpy(v), Lb)]
    else:
        jd = [[JA.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.int32(Lb))
               for k, v in dense_np]]
        td = [[TA.KVCache(torch.from_numpy(k), torch.from_numpy(v), Lb) for k, v in dense_np]]
    jc = jkv.scatter_prefill(jcfg, jc, jd, jnp.asarray(slots, jnp.int32), jnp.asarray(ids),
                             jnp.asarray(rows), jnp.asarray(lens))
    tkv.scatter_prefill(tcfg, tc, td, torch.tensor(slots), torch.from_numpy(ids).long(),
                        torch.from_numpy(rows), torch.from_numpy(lens))
    _check_paged(tc, jc, tpool.dump)
    inc = np.asarray([1, 0, 1], np.int32)
    jc = jkv.bump_lengths(jcfg, jc, jnp.asarray(inc))
    tkv.bump_lengths(tcfg, tc, torch.from_numpy(inc))
    _check_paged(tc, jc, tpool.dump)
    jc = jkv.retire_slot(jcfg, jc, jnp.int32(2), jpool.dump)
    tkv.retire_slot(tcfg, tc, 2, tpool.dump)
    _check_paged(tc, jc, tpool.dump)
    jc = jkv.bump_lengths(jcfg, jc, jnp.asarray(inc))
    tkv.bump_lengths(tcfg, tc, torch.from_numpy(inc))
    _check_paged(tc, jc, tpool.dump)


def test_paged_decode_steps_match_reference(pair):
    """The whole paged path through the model: a ragged 3-request admission
    (the reference's prefill + scatter on both sides), then three
    decode_step calls on the paged caches with per-step bumps: logits and
    caches against the reference's."""
    jcfg, tcfg, jp, tp = pair
    page, Lb, S = 4, 8, 3
    jpool, jc, tpool, tc = _both_paged(jcfg, tcfg, S, 16, page)
    rng = np.random.default_rng(5)
    lens = np.asarray([8, 2, 5], np.int32)
    prompts = np.zeros((S, Lb), np.int32)
    for i, n in enumerate(lens):
        prompts[i, :n] = rng.integers(0, tcfg.vocab_size, size=n)
    rows = np.stack([tpool.admit(s, int(n) + 4) for s, n in enumerate(lens)])
    for s, n in enumerate(lens):
        jpool.admit(s, int(n) + 4)
    ids = rows[:, :Lb // page]
    jl, jd, *_ = JM.prefill(jp, jcfg, jnp.asarray(prompts), max_len=Lb,
                            lengths=jnp.asarray(lens))
    tl, td, *_ = TM.prefill(tp, tcfg, torch.from_numpy(prompts), max_len=Lb,
                        lengths=torch.from_numpy(lens))
    _close(tl, jl, ATOL)
    slots = np.arange(S)
    jc = jkv.scatter_prefill(jcfg, jc, jd, jnp.asarray(slots, jnp.int32), jnp.asarray(ids),
                             jnp.asarray(rows), jnp.asarray(lens))
    tkv.scatter_prefill(tcfg, tc, td, torch.from_numpy(slots), torch.from_numpy(ids).long(),
                        torch.from_numpy(rows), torch.from_numpy(lens))
    nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    inc = np.ones((S,), np.int32)
    for _ in range(3):
        jl, jc = JM.decode_step(jp, jcfg, jc, jnp.asarray(nxt))
        tl, tc2 = TM.decode_step(tp, tcfg, tc, torch.from_numpy(nxt))
        assert all(a is b for a, b in zip(_tree.leaves(tc2), _tree.leaves(tc)))  # in place
        _close(tl, jl, ATOL)
        jc = jkv.bump_lengths(jcfg, jc, jnp.asarray(inc))
        tkv.bump_lengths(tcfg, tc, torch.from_numpy(inc))
        nxt = np.array(jnp.argmax(jl[:, -1], axis=-1), np.int32)[:, None]
    _check_paged(tc, jc, tpool.dump, ATOL)      # model activations, as the serving tests
    with pytest.raises(ValueError, match="decode-only"):
        TM.forward(tp, tcfg, torch.from_numpy(prompts[:, :2]), caches=tc)


# ---------------------------------------------------------------------------
# ContinuousBatcher
# ---------------------------------------------------------------------------


def test_continuous_greedy_matches_reference_generate(pair, ref_generate):
    _, tcfg, _, tp = pair
    reqs = _requests(tcfg, 3, seed=11)
    cb, rids = _run(tcfg, tp, reqs, slots=2)
    for rid, (p, n) in zip(rids, reqs):
        ref = ref_generate(p, n)
        assert np.array_equal(cb.done[rid], np.asarray(ref.tokens[0])), rid
        np.testing.assert_allclose(cb.done_logprobs[rid], np.asarray(ref.logprobs[0]),
                                   atol=ATOL, rtol=0)


def test_continuous_matches_own_generate(pair):
    """8 ragged requests through 4 slots (page 4, max_len 32): each
    request's tokens equal the port's unbatched generate(), logprobs 1e-5."""
    _, tcfg, _, tp = pair
    reqs = _requests(tcfg, 8)
    cb, rids = _run(tcfg, tp, reqs)
    assert len(cb.done) == len(reqs)
    for rid, (p, n) in zip(rids, reqs):
        ref = generate(tp, tcfg, p[None], n_new=n, max_len=len(p) + n)
        assert np.array_equal(ref.tokens[0], cb.done[rid]), rid
        assert cb.done_logprobs[rid].shape == (n,)
        np.testing.assert_allclose(cb.done_logprobs[rid], ref.logprobs[0], atol=ATOL, rtol=0)


def test_no_rebuilds_after_warmup(pair):
    """tests/test_serving.py's gates: ONE decode program, every (group
    size, bucket) admission shape met in warmup, and no shape missed after
    it; every decode since warmup went the one route (eager on the CPU)."""
    _, tcfg, _, tp = pair
    reqs = _requests(tcfg, 17, max_prompt=14, max_new=8, seed=9)
    cb, _ = _run(tcfg, tp, reqs, slots=4, max_len=32)
    st = cb.stats()
    assert st["decode_traces"] == 1 and st["decode"] == "eager"     # on the CPU
    assert st["eager_decodes"] == len(cb._occupancy) > 0 and st["decode_replays"] == 0
    assert st["retire_traces"] == 1
    assert st["bucket_misses"] == 0
    assert st["bucket_hits"] > 0
    assert all(v == 1 for v in st["admit_traces"].values()), st
    sizes = {int(k.split("x")[0]) for k in st["admit_traces"]}
    assert sizes == set(cb.admit_sizes) == {4, 2, 1}


def test_slot_refill_keeps_occupancy_high(pair):
    _, tcfg, _, tp = pair
    reqs = [(np.ones((4,), np.int32), 6) for _ in range(12)]
    cb, _ = _run(tcfg, tp, reqs, slots=4, max_len=16)
    assert len(cb.done) == 12
    assert cb.stats()["mean_occupancy"] > 0.9
    assert all(v is None for v in cb.slots)    # drained clean


def test_reset_keeps_the_state_storage(pair):
    """warmup() zeroes the slot state in place: the storage a decode graph
    reads stays the same, and it is back to the empty state."""
    _, tcfg, _, tp = pair
    cb = ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, max_new=4)
    ptrs = [t.data_ptr() for t in _tree.leaves(cb.state())]
    cb.warmup()
    assert [t.data_ptr() for t in _tree.leaves(cb.state())] == ptrs
    caches, cur, n_gen, n_target, out_toks, out_lps = cb.state()
    for c in _tree.leaves(caches):
        if c.dtype == torch.int32 and c.shape[-1] == cb.pool.nb:
            assert (c == cb.pool.dump).all()
        else:
            assert not c.any()
    assert not any(t.any() for t in (cur, n_gen, n_target, out_toks, out_lps))


def test_warmup_refuses_a_busy_batcher(pair):
    """warmup() with a request in flight or queued raises before it touches
    the page pool or the slot state; once drained, it runs."""
    _, tcfg, _, tp = pair
    cb = ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, max_new=4)
    cb.submit(np.ones((3,), np.int32), 4)
    cb.step()
    cb.submit(np.ones((5,), np.int32), 3)
    cb.submit(np.ones((2,), np.int32), 2)
    cb.submit(np.ones((4,), np.int32), 4)
    tables, free = cb.pool.tables.copy(), list(cb.pool.free)
    state = _tree.map(torch.clone, cb.state())
    with pytest.raises(RuntimeError, match="idle batcher: 1 requests in flight, 3 queued"):
        cb.warmup()
    assert np.array_equal(cb.pool.tables, tables) and cb.pool.free == free
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(cb.state()), _tree.leaves(state)))
    cb.run_until_done()
    assert len(cb.done) == 4
    cb.warmup()
    assert cb.stats()["bucket_misses"] == 0


def test_generate_marks_the_first_token_before_any_decode(pair, monkeypatch):
    """generate() calls on_first_token once, after the prefill and before
    the first decode step: WaveBatcher's time-to-first-token mark."""
    _, tcfg, _, tp = pair
    real, calls, seen = TM.decode_step, [], []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TM, "decode_step", counted)
    generate(tp, tcfg, np.ones((2, 5), np.int32), n_new=4,
             on_first_token=lambda: seen.append(len(calls)))
    assert seen == [0] and len(calls) == 3


def test_both_batchers_time_the_first_token(pair):
    """Both batchers record every request's time to first token: positive,
    inside the run, and later for requests served later (a later admission
    group, a later wave)."""
    _, tcfg, _, tp = pair
    reqs = [(np.full((5,), i + 1, np.int32), 6) for i in range(4)]
    cb = ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, max_new=8)
    wb = WaveBatcher(tp, tcfg, 2, 16)
    for b in (cb, wb):
        t0 = time.perf_counter()
        rids = [b.submit(p, n) for p, n in reqs]
        b.run_until_done()
        wall = time.perf_counter() - t0
        ttft = [b.ttft[r] for r in rids]
        assert all(0 < t < wall for t in ttft), (type(b).__name__, ttft, wall)
        assert max(ttft[:2]) < min(ttft[2:]), (type(b).__name__, ttft)


def test_sampled_tokens_are_deterministic_per_seed(pair):
    _, tcfg, _, tp = pair
    reqs = _requests(tcfg, 5, seed=13)

    def run(seed):
        cb, rids = _run(tcfg, tp, reqs, temperature=1.0, seed=seed)
        return [cb.done[r] for r in rids], [cb.done_logprobs[r] for r in rids]

    a, b, c = run(3), run(3), run(4)
    assert all(np.array_equal(x, y) for x, y in zip(a[0], b[0]))
    assert all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
    assert not all(np.array_equal(x, y) for x, y in zip(a[0], c[0]))
    assert all(np.isfinite(x).all() and (x <= 0).all() for x in a[1])


def test_continuous_rejects_window_config_and_mesh():
    cfg = tget_config("granite-3-2b", reduced=True, window=8)
    assert not supports_paged(cfg)
    with pytest.raises(ValueError, match="use WaveBatcher"):
        ContinuousBatcher({"embed": torch.zeros(1)}, cfg, 2, 16, page_size=4)
    tcfg = tget_config("granite-3-2b", reduced=True)
    tp = TM.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    with pytest.raises(TypeError, match="serves over a live mesh"):
        ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, mesh=object())
    with pytest.raises(ValueError, match="multiples of page_size"):
        ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, buckets=[6, 16])


def test_continuous_validates_request_bounds():
    tcfg = tget_config("granite-3-2b", reduced=True)
    tp = TM.init(torch.Generator().manual_seed(0), tcfg, device="cpu")
    cb = ContinuousBatcher(tp, tcfg, 2, 16, page_size=4, max_new=4)
    with pytest.raises(ValueError, match="max_new"):
        cb.submit(np.ones((3,), np.int32), 5)
    with pytest.raises(ValueError, match="max_len"):
        cb.submit(np.ones((14,), np.int32), 4)
