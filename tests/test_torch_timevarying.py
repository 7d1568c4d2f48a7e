"""The port's time-varying gossip, gradient accumulation and survivor mixing
against the JAX reference.

* The topology additions (star, random regular, expander, survivor repair,
  hierarchical re-planning, edge classes, the one-peer exponential graph,
  energy fractions and α) are numpy on both sides and must be bit-equal.
* One-peer time-varying mixing, einsum and fused, must reach exact consensus
  after log2(M) rounds (as ``tests/test_decentralized.py`` checks for the
  reference) and match the reference round by round.
* K = 4 train steps with ``time_varying='one_peer_exp'`` and with
  ``microbatch`` > 1, and the survivor mixes, are compared in float32 at
  ``tests/test_torch_train.py``'s rtol 1e-4 / atol 1e-6.
"""
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from repro import optim as joptim  # noqa: E402
from repro.core import bus as JB  # noqa: E402
from repro.core import gossip as JG  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import init_state as j_init_state  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core import bus as TB  # noqa: E402
from repro_torch.core import gossip as TG  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state as t_init_state  # noqa: E402
from repro_torch.core.decentralized import make_train_step as t_make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_2d  # noqa: E402

from test_torch_train import ATOL, RTOL, _assert_trees_close, _problem  # noqa: E402

K = 4


# ---------------------------------------------------------------------------
# Topology additions, bit-equal
# ---------------------------------------------------------------------------


def _same_topology(j, t):
    assert t.name == j.name and t.directed == j.directed
    assert t.circulant_offsets == j.circulant_offsets and t.group_of == j.group_of
    assert t.A.dtype == j.A.dtype and np.array_equal(t.A, j.A)
    assert t.in_degree == j.in_degree
    for i in range(j.M):
        assert np.array_equal(t.neighbors_in(i), j.neighbors_in(i))
        assert np.array_equal(t.neighbors_out(i), j.neighbors_out(i))
    for (wj, pj), (wt, pt) in zip(j.permutations(), t.permutations(), strict=True):
        assert wj == wt and np.array_equal(pj, pt)


@pytest.mark.parametrize("name,M,kw", [
    ("star", 7, {}),
    ("random_regular", 10, dict(d=3, seed=4)),
    ("random_regular", 16, dict(d=4, seed=0)),
    ("expander", 12, dict(d=4, seed=1, n_candidates=8)),
    ("expander", 8, dict(d=2)),
    ("expander", 6, dict(d=5)),
    ("ring", 6, {}),
    ("hypercube", 8, {}),
])
def test_topology_builders_bit_equal(name, M, kw):
    _same_topology(JT.make(name, M, **kw), TT.make(name, M, **kw))


@pytest.mark.parametrize("M", [2, 4, 8, 16])
def test_one_peer_exponential_bit_equal(M):
    for k in range(2 * int(np.log2(M)) + 1):
        _same_topology(JT.one_peer_exponential(M, k), TT.one_peer_exponential(M, k))
    with pytest.raises(ValueError, match="power of two"):
        TT.one_peer_exponential(6, 0)


def _masks(M, rng, n=6):
    out = [np.ones(M, bool)]
    while len(out) < n:
        m = rng.random(M) < 0.6
        if m.any():
            out.append(m)
    return out


@pytest.mark.parametrize("mode", ["reabsorb", "renormalize"])
def test_survivor_repair_bit_equal(mode, rng):
    for jt, tt in [(JT.undirected_ring(6), TT.undirected_ring(6)),
                   (JT.directed_ring_lattice(5, 2), TT.directed_ring_lattice(5, 2)),
                   (JT.star(5), TT.star(5)), (JT.torus_2d(3, 3), TT.torus_2d(3, 3))]:
        for alive in _masks(jt.M, rng):
            assert np.array_equal(TT.survivor_matrix(tt.A, alive, mode),
                                  JT.survivor_matrix(jt.A, alive, mode))
            for j in range(jt.M):
                assert np.array_equal(TT.survivor_column(tt.A[:, j], j, alive, mode),
                                      JT.survivor_column(jt.A[:, j], j, alive, mode))
    with pytest.raises(ValueError):
        TT.survivor_matrix(np.eye(3), np.zeros(3, bool))
    with pytest.raises(ValueError):
        TT.survivor_column(np.ones(3) / 3, 0, np.array([1, 0, 1], bool), "nope")


@pytest.mark.parametrize("P,s,outer", [(2, 2, "ring"), (4, 2, "ring"), (5, 2, "ring"),
                                       (3, 3, "clique"), (4, 2, "directed_ring_lattice")])
def test_repair_hier_stages_bit_equal(P, s, outer, rng):
    kw = {"d": 1} if outer == "directed_ring_lattice" else {}
    jt = JT.kronecker(JT.make(outer, P, **kw), JT.clique(s))
    tt = TT.kronecker(TT.make(outer, P, **kw), TT.clique(s))
    _same_topology(jt, tt)
    masks = _masks(jt.M, rng)
    dead_pod = np.ones(jt.M, bool)
    dead_pod[s:2 * s] = False               # every member of pod 1
    for alive in masks + [dead_pod]:
        for mode in ("reabsorb", "renormalize"):
            for a, b in zip(TT.repair_hier_stages(tt, alive, mode),
                            JT.repair_hier_stages(jt, alive, mode), strict=True):
                assert np.array_equal(a, b)
    adj = JT.undirected_ring(6).A > 0
    np.fill_diagonal(adj, False)
    node_alive = np.array([1, 0, 0, 1, 1, 0], bool)
    assert np.array_equal(TT._bridge_adjacency(adj, node_alive),
                          JT._bridge_adjacency(adj, node_alive))


def test_edge_classes_and_energy_bit_equal(rng):
    for jt, tt in [(JT.hier(2, 4), TT.hier(2, 4)),
                   (JT.undirected_ring(5), TT.undirected_ring(5))]:
        assert TT.edge_classes(tt) == JT.edge_classes(jt)
        g = [j % 2 for j in range(jt.M)]
        assert TT.edge_classes(tt, g) == JT.edge_classes(jt, g)
    for jt, tt in [(JT.undirected_ring(8), TT.undirected_ring(8)),
                   (JT.torus_2d(3, 3), TT.torus_2d(3, 3)),
                   (JT.directed_ring_lattice(6, 2), TT.directed_ring_lattice(6, 2))]:
        G = rng.normal(size=(5, jt.M))
        D = G - G.mean(1, keepdims=True)
        e_j, e_t = JT.energy_fractions(D, jt.A), TT.energy_fractions(D, tt.A)
        assert np.array_equal(e_t, e_j)
        lam, _ = JT.spectral_projectors(jt.A)
        assert TT.alpha_from_fractions(e_t, lam) == JT.alpha_from_fractions(e_j, lam)
        assert np.array_equal(TT.energy_fractions(np.zeros_like(D), tt.A),
                              JT.energy_fractions(np.zeros_like(D), jt.A))


# ---------------------------------------------------------------------------
# One-peer time-varying mixing
# ---------------------------------------------------------------------------


def _stack(M, rng, dtype=np.float32):
    """A worker-stacked tree as (JAX tree, port tree) with the same values."""
    p = {"a": rng.normal(size=(M, 5, 7)), "b": [rng.normal(size=(M, 129))]}
    jtree = jax.tree.map(lambda x: jnp.asarray(x, dtype), p)
    return jtree, convert.params_from_jax(jtree, device="cpu")


@pytest.mark.parametrize("M", [4, 8])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_one_peer_mix_exact_consensus(M, backend, rng):
    """log2(M) one-peer rounds average exactly; each round matches the
    reference's mix_pytree_time_varying."""
    jspec = JG.GossipSpec(topology=JT.undirected_ring(M), backend=backend,
                          time_varying="one_peer_exp")
    tspec = TG.GossipSpec(topology=TT.undirected_ring(M), backend=backend,
                          time_varying="one_peer_exp")
    jx, tx = _stack(M, rng)
    jcur, tcur = jx, tx
    for k in range(int(np.log2(M))):
        jcur = JG.mix_pytree_time_varying(jcur, jspec, jnp.asarray(k), None)
        tcur = TG.mix_pytree_time_varying(tcur, tspec, k)
        _assert_trees_close(jcur, tcur, f"round {k}")
    for x0, x in zip(_tree.leaves(tx), _tree.leaves(tcur)):
        np.testing.assert_allclose(x.numpy(), np.broadcast_to(x0.numpy().mean(0), x.shape),
                                   atol=1e-5)
    assert len(tspec.one_peer_specs) == int(np.log2(M))
    assert tspec.one_peer_specs is tspec.one_peer_specs      # built once


@pytest.mark.parametrize("M", [4, 8])
def test_fused_time_varying_update_matches_reference(M, rng):
    """bus.mix_and_update_time_varying at every round: one k = 1 launch of
    the kernel's plain version per dtype group, the reference's values."""
    jspec = JG.GossipSpec(topology=JT.undirected_ring(M), backend="fused",
                          time_varying="one_peer_exp")
    tspec = TG.GossipSpec(topology=TT.undirected_ring(M), backend="fused",
                          time_varying="one_peer_exp")
    jx, tx = _stack(M, rng)
    ju, tu = _stack(M, rng)
    for k in range(2 * int(np.log2(M)) + 1):
        want = JB.mix_and_update_time_varying(jx, jspec, ju, jnp.asarray(k), None, eta=-1.0)
        got = TB.mix_and_update_time_varying(tx, tspec, tu, k, eta=-1.0)
        _assert_trees_close(want, got, f"step {k}")
    others = TB._split_perms(tspec.one_peer_specs[1])[1]
    assert len(others) == 1 and np.array_equal(others[0][1], (np.arange(M) - 2) % M)
    with pytest.raises(ValueError, match="time_varying"):
        TG.GossipSpec(topology=TT.undirected_ring(M), time_varying="two_peer")
    with pytest.raises(ValueError, match="power of two"):
        TG.GossipSpec(topology=TT.undirected_ring(6), time_varying="one_peer_exp").one_peer_specs


# ---------------------------------------------------------------------------
# Train steps: time-varying and microbatched, against the reference
# ---------------------------------------------------------------------------


def _opts(kind):
    if kind == "sgd":
        return joptim.sgd(0.05), toptim.sgd(0.05)
    if kind == "momentum":
        return joptim.momentum_sgd(0.05, 0.9), toptim.momentum_sgd(0.05, 0.9)
    return (joptim.adam(joptim.warmup_cosine(1e-3, 2, K)),
            toptim.adam(toptim.warmup_cosine(1e-3, 2, K)))


def _run_steps(problem, M, opt, mode="gossip", spec_kw=None, step_kw=None):
    arrays, p0, jloss, tloss = _problem(problem)
    jopt, topt = _opts(opt)
    step_kw = dict(step_kw or {}, mode=mode)
    kw_j, kw_t = dict(step_kw), dict(step_kw)
    if mode == "gossip":
        kw_j["gossip"] = JG.GossipSpec(topology=JT.undirected_ring(M), **spec_kw)
        kw_t["gossip"] = TG.GossipSpec(topology=TT.undirected_ring(M), **spec_kw)
        jp0 = j_replicate(jax.tree.map(jnp.asarray, p0), M)
        tp0 = t_replicate(convert.params_from_jax(p0, device="cpu"), M)
    else:
        jp0, tp0 = jax.tree.map(jnp.asarray, p0), convert.params_from_jax(p0, device="cpu")
    jstep = jax.jit(j_make_train_step(jloss, jopt, **kw_j))
    tstep = t_make_train_step(tloss, topt, **kw_t)
    jst, tst = j_init_state(jp0, jopt), t_init_state(tp0, topt)
    batcher = WorkerBatcher(arrays, pad_to_equal(random_split(len(arrays[0]), M)),
                            batch_size=4, seed=0)
    for k in range(K):
        batch = batcher.next()
        if mode == "allreduce":
            batch = tuple(a.reshape((-1,) + a.shape[2:]) for a in batch)
        jst, jm = jstep(jst, tuple(jnp.asarray(a) for a in batch))
        tst, tm = tstep(tst, convert.to_device(batch, "cpu"))
        assert tst.step == int(jst.step) == k + 1
        _assert_trees_close(jst.params, tst.params, f"params after step {k}")
        _assert_trees_close(jst.opt_state, tst.opt_state, f"opt state after step {k}")
        for name, a, b in zip(tm._fields, jm, tm):
            np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} at step {k}")
    return tst


TV_CASES = [
    # problem, M, backend, mix_first, period, optimizer
    ("linear", 4, "fused", True, 1, "momentum"),
    ("linear", 8, "einsum", True, 2, "sgd"),
    ("mlp", 8, "fused", True, 2, "momentum"),
    ("mlp", 4, "einsum", False, 1, "momentum"),   # the static-topology quirk
    ("mlp", 8, "fused", False, 2, "sgd"),
    ("lm", 4, "fused", True, 1, "momentum"),
    ("lm", 4, "einsum", False, 2, "sgd"),
]


@pytest.mark.parametrize("problem,M,backend,mix_first,period,opt", TV_CASES)
def test_time_varying_train_steps_match_reference(problem, M, backend, mix_first,
                                                  period, opt, monkeypatch):
    ks = []

    def counting(w, neighbors, *a, **kw):
        ks.append(neighbors.shape[0])
        return gossip_mix_2d(w, neighbors, *a, **kw)

    monkeypatch.setattr(TB, "gossip_mix_2d", counting)
    _run_steps(problem, M, opt,
               spec_kw=dict(backend=backend, period=period, time_varying="one_peer_exp"),
               step_kw=dict(mix_first=mix_first))
    if backend == "fused":
        # one k = 1 pass per mixing step (one dtype group), except under the
        # static-topology quirk (mix_first=False, period 1): the ring's k = 2
        mixes = sum(1 for k in range(K) if k % period == 0)
        assert ks == [2 if (not mix_first and period == 1) else 1] * mixes
    else:
        assert ks == []


MB_CASES = [
    # problem, mode, M, backend, microbatch, optimizer
    ("linear", "gossip", 4, "fused", 2, "momentum"),
    ("mlp", "gossip", 8, "einsum", 4, "sgd"),
    ("mlp", "gossip", 4, "fused", 2, "adam"),
    ("lm", "gossip", 4, "fused", 2, "momentum"),
    ("linear", "allreduce", 4, None, 4, "momentum"),
    ("mlp", "allreduce", 4, None, 2, "sgd"),
    ("lm", "allreduce", 4, None, 4, "sgd"),
]


@pytest.mark.parametrize("problem,mode,M,backend,mb,opt", MB_CASES)
def test_microbatched_train_steps_match_reference(problem, mode, M, backend, mb, opt):
    spec_kw = dict(backend=backend) if mode == "gossip" else None
    tst = _run_steps(problem, M, opt, mode=mode, spec_kw=spec_kw,
                     step_kw=dict(microbatch=mb))
    assert all(x.dtype == torch.float32 for x in _tree.leaves(tst.params))


def test_microbatched_grads_are_float32_chunk_means():
    """The accumulated grads stay float32 and are the mean of the chunks'
    grads (each chunk is a contiguous block of rows)."""
    from repro_torch.core.decentralized import _microbatched

    def vg(params, batch):
        return {"w": batch.sum(0).to(torch.bfloat16)}, batch.mean()

    batch = torch.arange(8, dtype=torch.float32)[:, None].repeat(1, 3)
    grads, loss = _microbatched(vg, 4, 0)({"w": None}, batch)
    assert grads["w"].dtype == torch.float32
    want = torch.stack([batch[2 * i:2 * i + 2].sum(0) for i in range(4)]).mean(0)
    torch.testing.assert_close(grads["w"], want)
    assert loss.item() == batch.mean().item()


# ---------------------------------------------------------------------------
# Survivor mixing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_survivor_mix_matches_reference(dtype, rng):
    for jt, tt, alive, mode in [
            (JT.undirected_ring(4), TT.undirected_ring(4), [1, 1, 0, 1], "reabsorb"),
            (JT.torus_2d(3, 3), TT.torus_2d(3, 3), [1, 0, 1, 1, 0, 1, 1, 1, 1], "renormalize"),
            (JT.clique(5), TT.clique(5), [1] * 5, "reabsorb")]:
        jx, tx = _stack(jt.M, rng, dtype)
        want = JG.survivor_mix(jx, jt, np.asarray(alive, bool), mode)
        got = TG.survivor_mix(tx, tt, np.asarray(alive, bool), mode)
        _close_or_bf16(want, got)
        for x0, x in zip(_tree.leaves(tx), _tree.leaves(got)):
            for j in np.nonzero(~np.asarray(alive, bool))[0]:
                assert torch.equal(x[j], x0[j])        # dead slices pass through


@pytest.mark.parametrize("P,s,alive", [
    (2, 2, [1, 1, 0, 1]),
    (4, 2, [1, 1, 0, 0, 1, 1, 1, 0]),       # a whole pod dead: the ring bridges
    (3, 2, [1, 1, 1, 1, 1, 1]),
])
def test_survivor_hierarchical_mix_matches_reference(P, s, alive, rng):
    jt, tt = JT.hier(P, s), TT.hier(P, s)
    jx, tx = _stack(jt.M, rng)
    mask = np.asarray(alive, bool)
    want = JG.survivor_hierarchical_mix(jx, jt, mask)
    got = TG.survivor_hierarchical_mix(tx, tt, mask)
    _assert_trees_close(want, got, "survivor hierarchical mix")
    for x0, x in zip(_tree.leaves(tx), _tree.leaves(got)):
        for j in np.nonzero(~mask)[0]:
            assert torch.equal(x[j], x0[j])


def _close_or_bf16(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), _tree.leaves(ttree), strict=True):
        if b.dtype == torch.bfloat16:
            # bf16 einsum: both sides round one float32 sum; tolerance of a
            # bf16 ulp where the sum orders differ
            np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                       rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL, atol=ATOL)
