"""The paper's three problems end to end, the gossip_mix ops and History,
against the JAX reference.

``problems.run_dsm`` is held against ``benchmarks/common.run_dsm`` on ring,
clique and torus, for the three problems, with random and by-label splits,
from the reference's own initial weights (``convert.params_from_jax``). Both
sides run float32 with sums in different orders; over the steps below the
global-loss curves agree to ≤ 1.5e-6 relative (rtol 1e-5 here) and the
gradient statistics, whose spread term cancels, to ≤ 1.4e-5 (rtol 1e-4,
atol 1e-6, the train-step tolerance of ``tests/test_torch_train.py``). The
data, labels and partitions are the same numpy draws, compared exactly.
The benchmark's own step counts (Fig. 2: 150 and 60 steps) run under
``-m slow``.
"""
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from benchmarks import common  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.kernels.gossip_mix import ops as jops  # noqa: E402
from repro.train.loop import History as JHistory  # noqa: E402
from repro.train.loop import train as j_train  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro import optim as joptim  # noqa: E402
from repro_torch import _tree, convert, problems  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_leaf, gossip_mix_pytree  # noqa: E402
from repro_torch.train import History, train as t_train  # noqa: E402

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These steps are thousands of tiny ops: one intra-op thread runs them
    faster than a pool that several test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STAT_RTOL, STAT_ATOL = 1e-4, 1e-6

# name: (constructor, small kwargs, steps, per-worker batch, lr)
PROBLEMS = {
    "linear": ("problem_linear", dict(S=256, n=16), 20, 16, 0.05),
    "mlp": ("problem_classifier", dict(S=256, n=16), 20, 16, 0.3),
    "lm": ("problem_lm", dict(S=64, seq=16), 10, 4, 0.3),
}
TOPOS = [("ring", 8), ("clique", 8), ("torus", 4)]


def _pair(make, **kw):
    """(reference problem, port problem started from the reference's weights)."""
    jp = getattr(common, make)(**kw)
    tp = getattr(problems, make)(**kw)
    for a, b in zip(jp[0], tp[0]):
        np.testing.assert_array_equal(np.asarray(a), b)
    np.testing.assert_array_equal(np.asarray(jp[1]), tp[1])
    assert jp[4] == tp[4]
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, jp[2]), device="cpu")
    return jp, (tp[0], tp[1], p0, tp[3], tp[4])


def _check_run(jp, tp, topo, M, **kw):
    jl, js, jparts = common.run_dsm(jp, JT.make(topo, M), collect_grad_stats=True, **kw)
    tl, ts, tparts = problems.run_dsm(tp, TT.make(topo, M), collect_grad_stats=True,
                                      device="cpu", **kw)
    np.testing.assert_array_equal(tparts, jparts)
    np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL, err_msg="global-loss curve")
    np.testing.assert_allclose(np.asarray(ts), np.asarray(js), rtol=STAT_RTOL,
                               atol=STAT_ATOL, err_msg="(E, E_sp, H) per step")
    assert np.isfinite(tl).all() and tl[-1] < tl[0]


@pytest.mark.parametrize("split", ["random", "by_label"])
@pytest.mark.parametrize("topo,M", TOPOS)
@pytest.mark.parametrize("name", list(PROBLEMS))
def test_run_dsm_curves_match_reference(name, topo, M, split):
    make, kw, steps, B, lr = PROBLEMS[name]
    jp, tp = _pair(make, **kw)
    _check_run(jp, tp, topo, M, steps=steps, lr=lr, B=B, split=split)


@pytest.mark.slow
@pytest.mark.parametrize("split", ["random", "by_label"])
@pytest.mark.parametrize("make,steps,lr", [("problem_classifier", 150, 0.5),
                                           ("problem_lm", 60, 0.1)])
def test_run_dsm_fig2_step_counts_match_reference(make, steps, lr, split):
    """bench_fig2's settings: M = 8 on the ring, default problem sizes."""
    jp, tp = _pair(make)
    _check_run(jp, tp, "ring", 8, steps=steps, lr=lr, split=split)


def test_run_dsm_momentum_matches_reference():
    jp, tp = _pair("problem_linear", S=256, n=16)
    _check_run(jp, tp, "ring", 8, steps=15, lr=0.02, momentum=0.9)


def test_run_sim_matches_run_dsm_under_ideal_times():
    """The synchronous simulator on unit compute times is the same
    trajectory as run_dsm: the final eval equals run_dsm's last global loss."""
    tp = problems.problem_linear(S=256, n=16)
    losses, _, _ = problems.run_dsm(tp, TT.undirected_ring(4), steps=12, lr=0.05,
                                    device="cpu")
    run = problems.run_sim(tp, TT.undirected_ring(4), rounds=12, lr=0.05, device="cpu")
    _, ev = run.eval_curve()
    assert len(ev) == 12
    assert ev[-1] == losses[-1]


def test_problem_port_inits_are_seeded():
    """The port draws its own initial weights from a seeded generator."""
    a, b = problems.problem_classifier(S=64, seed=3), problems.problem_classifier(S=64, seed=3)
    for x, y in zip(_tree.leaves(a[2]), _tree.leaves(b[2])):
        assert torch.equal(x, y)
    lm = problems.problem_lm(S=8, seq=8)
    assert all(torch.isfinite(x).all() for x in _tree.leaves(lm[2]))


def test_split_by_label_is_exported():
    from repro.data import split_by_label as j_split
    from repro_torch.data import split_by_label

    labels = np.random.default_rng(0).integers(0, 10, size=200)
    for got, want in zip(split_by_label(labels, 4, seed=2), j_split(labels, 4, seed=2)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# gossip_mix ops, as tests/test_kernels.py drives the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(64,), (37, 129), (3, 3)])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_gossip_mix_leaf_matches_reference(shape, k):
    rng = np.random.default_rng(k)
    w = rng.normal(size=shape).astype(np.float32)
    nb = rng.normal(size=(k,) + shape).astype(np.float32)
    wt = rng.random(k + 1).astype(np.float32)
    wt /= wt.sum()
    up = rng.normal(size=shape).astype(np.float32)
    want = jops.gossip_mix_leaf(jnp.asarray(w), jnp.asarray(nb), jnp.asarray(wt),
                                jnp.asarray(up), 0.1)
    got = gossip_mix_leaf(torch.from_numpy(w), torch.from_numpy(nb), wt,
                          torch.from_numpy(up), 0.1)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_gossip_mix_pytree_matches_reference():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(10, 7)).astype(np.float32),
              "b": {"c": np.arange(5.0, dtype=np.float32)},
              "h": rng.normal(size=(3, 2)).astype(np.float32)}
    nbrs = [jax.tree.map(lambda x: x * (i + 2.0), params) for i in range(2)]
    upd = jax.tree.map(lambda x: np.ones_like(x), params)
    wt = np.asarray([0.5, 0.25, 0.25], np.float32)
    want = jops.gossip_mix_pytree(jax.tree.map(jnp.asarray, params),
                                  [jax.tree.map(jnp.asarray, n) for n in nbrs],
                                  jnp.asarray(wt), jax.tree.map(jnp.asarray, upd), eta=0.1)
    t = lambda tree: convert.params_from_jax(tree, device="cpu")
    got = gossip_mix_pytree(t(params), [t(n) for n in nbrs], wt, t(upd), eta=0.1)
    for x, y in zip(_tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-6)
    # a: 0.5·a + 0.25·2a + 0.25·3a − 0.1·1
    np.testing.assert_allclose(got["a"].numpy(), 1.75 * params["a"] - 0.1, atol=1e-5)


def test_gossip_mix_pytree_one_launch_per_dtype_group(monkeypatch):
    from repro_torch.kernels.gossip_mix import ops

    calls = []
    real = ops.gossip_mix_2d
    monkeypatch.setattr(ops, "gossip_mix_2d", lambda *a, **k: calls.append(a) or real(*a, **k))
    tree = {"f": torch.ones(5, 3), "g": torch.ones(7), "b": torch.ones(4, dtype=torch.bfloat16)}
    out = gossip_mix_pytree(tree, [tree], [0.5, 0.5], _tree.map(torch.zeros_like, tree), 0.0)
    assert len(calls) == 2
    assert all(torch.equal(out[k], tree[k]) for k in tree)


# ---------------------------------------------------------------------------
# History
# ---------------------------------------------------------------------------


def test_history_as_arrays_matches_reference():
    arrays, _, p0, _, _ = common.problem_linear(S=256, n=16)
    _, _, _, tloss, _ = problems.problem_linear(S=256, n=16)
    p0 = jax.tree.map(np.asarray, p0)
    M, steps = 4, 6
    parts = pad_to_equal(random_split(len(arrays[0]), M))
    jb = WorkerBatcher(arrays, parts, batch_size=8, seed=1)
    tb = WorkerBatcher(arrays, parts, batch_size=8, seed=1)
    _, jh = j_train(common.problem_linear(S=256, n=16)[3],
                    j_replicate(jax.tree.map(jnp.asarray, p0), M), joptim.sgd(0.05),
                    (tuple(jnp.asarray(a) for a in jb.next()) for _ in range(steps)),
                    steps=steps, gossip=JSpec(topology=JT.undirected_ring(M), backend="einsum"),
                    log_every=2, verbose=False)
    _, th = t_train(tloss, t_replicate(convert.params_from_jax(p0, device="cpu"), M),
                    toptim.sgd(0.05), (tb.next() for _ in range(steps)), steps=steps,
                    gossip=TSpec(topology=TT.undirected_ring(M), backend="einsum"),
                    log_every=2, device="cpu", verbose=False)
    ja, ta = jh.as_arrays(), th.as_arrays()
    assert set(ja) <= set(ta)
    for k in ja:
        assert ta[k].shape == ja[k].shape == (steps,), k
        if k != "step_time":
            np.testing.assert_allclose(ta[k], ja[k], rtol=STAT_RTOL, atol=STAT_ATOL, err_msg=k)

    # append: one step's metrics, each field a host float
    h, jh2 = History(), JHistory()
    from repro.core.decentralized import StepMetrics as JM
    from repro_torch.core.decentralized import StepMetrics as TM

    vals = (1.5, 2.0, 0.25, 3.0, 0.125)
    h.append(TM(*map(torch.tensor, vals)), 0.01)
    jh2.append(JM(*map(jnp.asarray, vals)), 0.01)
    assert {k: list(v) for k, v in h.as_arrays().items() if k in jh2.as_arrays()} == \
        {k: list(v) for k, v in jh2.as_arrays().items()}
