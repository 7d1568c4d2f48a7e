"""The port's hierarchical (multi-pod) gossip against the JAX reference:
the Kronecker builders and their two-stage split, ``mix_pytree`` with
``GossipSpec(hierarchical=True)``, ``hierarchical_mix_compressed`` over
several rounds of error feedback, and K=3 hierarchical train steps.

Tolerances: topologies are numpy on both sides and pinned bit for bit.
Mixes: float32 atol 1e-5 (the gossip_mix kernel tests' float32 tolerance);
``dci_dtype=None`` is bit-identical to ``hierarchical_mix``. Train steps:
rtol 1e-4 / atol 1e-6, as tests/test_torch_train.py (same float32
arithmetic, matmuls and reductions summed in other orders).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jgossip  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import init_state as j_init_state  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state as t_init_state  # noqa: E402
from repro_torch.core.decentralized import make_train_step as t_make_train_step  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_2d  # noqa: E402
from repro_torch.kernels.quant_pack import quantize_pack_2d  # noqa: E402
from test_torch_train import ATOL, RTOL, _assert_trees_close, _optimizers, _problem  # noqa: E402

F32_TOL = 1e-5
TOPOLOGIES = {
    "hier2x2": lambda m: m.hier(2, 2),
    "hier2x4": lambda m: m.hier(2, 4),
    "hier4x2-ring": lambda m: m.hier(4, 2, inner="ring"),
    "kron-clique2-ring8": lambda m: m.kronecker(m.clique(2), m.undirected_ring(8)),
}


def _assert_topologies_equal(j, t):
    assert t.name == j.name and t.directed == j.directed
    assert t.group_of == j.group_of
    assert t.A.dtype == j.A.dtype and np.array_equal(t.A, j.A)
    jp, tp = j.permutations(), t.permutations()
    assert len(jp) == len(tp)
    for (jw, jperm), (tw, tperm) in zip(jp, tp):
        assert jw == tw and np.array_equal(jperm, tperm)


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_kronecker_topologies_and_split_match_reference(name):
    j, t = TOPOLOGIES[name](JT), TOPOLOGIES[name](TT)
    _assert_topologies_equal(j, t)
    for js, ts in zip(JT.split_kronecker(j), TT.split_kronecker(t)):
        _assert_topologies_equal(js, ts)
    for ja, ta in zip(JT.kronecker_factors(j), TT.kronecker_factors(t)):
        assert np.array_equal(ja, ta)
    intra, inter = TT.split_kronecker(t)
    np.testing.assert_allclose(inter.A @ intra.A, t.A, atol=1e-9)


def test_kronecker_split_rejects_what_is_not_a_kronecker():
    with pytest.raises(ValueError, match="group"):
        TT.split_kronecker(TT.undirected_ring(8))
    with pytest.raises(ValueError, match="contiguous"):
        TT.split_kronecker(TT.Topology("x", np.eye(4), group_of=(0, 1, 0, 1)))
    with pytest.raises(ValueError, match="assign all"):
        TT.Topology("x", np.eye(4), group_of=(0, 1))


def _tree_np(M, seed=3):
    """The trees of tests/test_dci_compress.py (float32 (M,127), (M,33,5))
    from numpy, plus an int32 leaf."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, 127)).astype(np.float32),
            "b": rng.normal(size=(M, 33, 5)).astype(np.float32),
            "steps": rng.integers(-1000, 1000, size=(M, 300)).astype(np.int32)}


def _specs(name, backend, hierarchical=True):
    j, t = TOPOLOGIES[name](JT), TOPOLOGIES[name](TT)
    return (jgossip.GossipSpec(topology=j, backend=backend, hierarchical=hierarchical),
            tgossip.GossipSpec(topology=t, backend=backend, hierarchical=hierarchical))


def _assert_close(jtree, ttree, atol, what=""):
    jl, tl = jax.tree.leaves(jtree), _tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert convert.params_to_numpy(b).dtype == np.asarray(a).dtype
        np.testing.assert_allclose(b.double().numpy(), np.asarray(a, np.float64),
                                   atol=atol, rtol=0, err_msg=what)


@pytest.mark.parametrize("name", ["hier2x4", "hier4x2-ring"])
@pytest.mark.parametrize("backend", ["einsum", "fused"])
def test_hierarchical_mix_pytree_matches_reference(name, backend):
    jspec, tspec = _specs(name, backend)
    t = {k: v for k, v in _tree_np(jspec.topology.M).items() if k != "steps"}
    got = tgossip.mix_pytree(convert.params_from_jax(t, device="cpu"), tspec)
    want = jgossip.mix_pytree(jax.tree.map(jnp.asarray, t), jspec)
    _assert_close(want, got, F32_TOL)
    dense = jgossip.mix_pytree_reference(jax.tree.map(jnp.asarray, t), jspec.topology.A)
    _assert_close(dense, got, F32_TOL)
    # the split stages of the flat spec compose to the same mix
    intra, inter = tgossip.split_hierarchical(_specs(name, backend, False)[1])
    assert intra.backend == inter.backend == backend
    staged = tgossip.hierarchical_mix(convert.params_from_jax(t, device="cpu"), intra, inter)
    for a, b in zip(_tree.leaves(staged), _tree.leaves(got)):
        assert torch.equal(a, b)


def _compressed_rounds(jx, tx, jstages, tstages, dci, rounds):
    jres = tres = None
    for r in range(rounds):
        jx, jres = jgossip.hierarchical_mix_compressed(jx, *jstages, dci_dtype=dci,
                                                        residual=jres)
        tx, tres = tgossip.hierarchical_mix_compressed(tx, *tstages, dci_dtype=dci,
                                                        residual=tres)
        _assert_close(jx, tx, F32_TOL, f"round {r}")
        if dci is None:
            assert jres is None and tres is None
            continue
        assert [r_ is None for r_ in jres] == [r_ is None for r_ in tres]
        for a, b in zip(jres, tres):
            if a is not None:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_TOL,
                                           rtol=0, err_msg=f"residual, round {r}")
    return jx, tx


@pytest.mark.parametrize("dci", [None, "bfloat16", "int8"])
def test_hierarchical_mix_compressed_matches_reference(dci):
    jspec, tspec = _specs("hier2x4", "fused", hierarchical=False)
    jstages = jgossip.split_hierarchical(jspec)
    tstages = tgossip.split_hierarchical(tspec)
    t = _tree_np(8)
    jx, tx = jax.tree.map(jnp.asarray, t), convert.params_from_jax(t, device="cpu")
    launches = quantize_pack_2d.launches, gossip_mix_2d.launches
    _, out = _compressed_rounds(jx, tx, jstages, tstages, dci, rounds=5)
    assert (quantize_pack_2d.launches, gossip_mix_2d.launches) == launches  # CPU: plain
    if dci is None:   # bit-identical to the exact two-stage mix
        want = tx
        for _ in range(5):
            want = tgossip.hierarchical_mix(want, *tstages)
        for a, b in zip(_tree.leaves(out), _tree.leaves(want)):
            assert torch.equal(a, b)


HIER_STEP_CASES = [
    # problem, backend, mix_first, optimizer
    ("linear", "fused", True, "momentum"),
    ("mlp", "fused", True, "sgd"),
    ("lm", "fused", True, "momentum"),
    ("mlp", "einsum", False, "nesterov"),
]


@pytest.mark.parametrize("problem,backend,mix_first,opt", HIER_STEP_CASES)
def test_hierarchical_train_step_matches_reference(problem, backend, mix_first, opt):
    M = 8
    arrays, p0, jloss, tloss = _problem(problem)
    jopt, topt = _optimizers(opt)
    jspec, tspec = _specs("hier2x4", backend)
    jstep = jax.jit(j_make_train_step(jloss, jopt, gossip=jspec, mix_first=mix_first))
    tstep = t_make_train_step(tloss, topt, gossip=tspec, mix_first=mix_first)
    jst = j_init_state(j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt)
    tst = t_init_state(t_replicate(convert.params_from_jax(p0, device="cpu"), M), topt)
    batcher = WorkerBatcher(arrays, pad_to_equal(random_split(len(arrays[0]), M)),
                            batch_size=4, seed=0)
    for k in range(3):
        batch = batcher.next()
        jst, jm = jstep(jst, tuple(jnp.asarray(a) for a in batch))
        tst, tm = tstep(tst, convert.to_device(batch, "cpu"))
        _assert_trees_close(jst.params, tst.params, f"params after step {k}")
        _assert_trees_close(jst.opt_state, tst.opt_state, f"opt state after step {k}")
        for name, a, b in zip(tm._fields, jm, tm):
            np.testing.assert_allclose(b.item(), float(a), rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} at step {k}")


def test_train_loop_takes_a_hierarchical_spec():
    """``train()`` runs a hierarchical spec as it is: same history as the
    reference's loop."""
    from repro.train.loop import train as j_train
    from repro_torch.train import train as t_train

    M, steps = 8, 4
    arrays, p0, jloss, tloss = _problem("linear")
    jopt, topt = _optimizers("momentum")
    jspec, tspec = _specs("hier2x4", "fused")
    parts = pad_to_equal(random_split(len(arrays[0]), M))
    jb = WorkerBatcher(arrays, parts, batch_size=4, seed=1)
    tb = WorkerBatcher(arrays, parts, batch_size=4, seed=1)
    _, jh = j_train(jloss, j_replicate(jax.tree.map(jnp.asarray, p0), M), jopt,
                    (tuple(jnp.asarray(a) for a in jb.next()) for _ in range(steps)),
                    steps=steps, gossip=jspec, log_every=2, verbose=False)
    tstate, th = t_train(tloss, t_replicate(convert.params_from_jax(p0, device="cpu"), M),
                         topt, (tb.next() for _ in range(steps)), steps=steps, gossip=tspec,
                         log_every=2, device="cpu", verbose=False)
    assert tstate.step == steps
    for name in ("loss", "grad_energy", "grad_spread", "mean_grad_norm", "param_spread"):
        np.testing.assert_allclose(getattr(th, name), getattr(jh, name), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
