"""The port's event-driven simulator, recovery and straggler model against the
JAX reference, on the scenarios of ``tests/test_sim_engine.py``,
``tests/test_faults.py`` and ``tests/test_commit_paths.py`` at M ≤ 8.

What must be equal, and what close:

* The event schedule is numpy-only on both sides (seeded per-worker streams,
  the same heap order), so every trace record's (seq, t, kind, worker, src,
  round) must be EQUAL to the reference's, and the timing-only runs'
  signatures equal outright.
* The losses a trace records and the final parameters come from float32
  training in two frameworks whose sums run in different orders: losses
  within rtol 1e-5 and params within rtol 1e-5 / atol 1e-6 (observed
  ≲ 1e-6 over these runs).
* Within the port, the reference's own claims hold bit for bit on the CPU at
  M ≤ 8: per-slice commits equal full commits, batched commits equal
  single ones, and the deterministic-times sync run equals ``train()``.
"""
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.core import straggler as JS  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.decentralized import replicate_for_workers as j_replicate  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.sim import Engine as JEngine  # noqa: E402
from repro.sim import SyncGossip as JSync  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro.train.loop import RecoveryPolicy as JPolicy  # noqa: E402
from repro.train.loop import run_simulated as j_run  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.core import straggler as TS  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers as t_replicate  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.sim import (BatchCache, Engine, MeshSpec, SyncGossip,  # noqa: E402
                             TrainExecutor, scenarios)
from repro_torch.train.loop import RecoveryPolicy, run_simulated, train  # noqa: E402

LOSS_RTOL = 1e-5
P_RTOL, P_ATOL = 1e-5, 1e-6


# ---------------------------------------------------------------------------
# One problem, two packages
# ---------------------------------------------------------------------------


def _data(n=8, S_=256, seed=0):
    """The reference tests' linear problem, as float32 numpy."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S_, n))
    w_true = rng.normal(size=n)
    y = X @ w_true + 0.1 * rng.normal(size=S_)
    return X.astype(np.float32), y.astype(np.float32)


def _jloss(params, batch):
    bx, by = batch
    return jnp.mean((bx @ params["w"] - by) ** 2)


def _tloss(params, batch):
    bx, by = batch
    return torch.mean((bx @ params["w"] - by) ** 2)


def _batches(X, y, M, batch_size=16, seed=0, wrap=lambda a: a):
    parts = pad_to_equal(random_split(len(X), M, seed=seed))
    batcher = WorkerBatcher((X, y), parts, batch_size=batch_size, seed=seed)
    while True:
        yield tuple(wrap(a) for a in batcher.next())


def _opts(name, lr):
    if name == "sgd":
        return joptim.sgd(lr), toptim.sgd(lr)
    return joptim.momentum_sgd(lr, 0.9), toptim.momentum_sgd(lr, 0.9)


def _port(topo, protocol="sync", *, rounds, scenario=None, opt="sgd", lr=0.1,
          eval_every=0, n=8, recovery=None, **kw):
    X, y = _data(n)
    full = (torch.from_numpy(X), torch.from_numpy(y))
    return run_simulated(
        _tloss, t_replicate({"w": torch.zeros(n)}, topo.M), _opts(opt, lr)[1],
        _batches(X, y, topo.M), gossip=TSpec(topology=topo, backend="einsum"),
        protocol=protocol, scenario=scenario, rounds=rounds,
        eval_fn=(lambda p: float(_tloss(p, full))) if eval_every else None,
        eval_every=eval_every, recovery=recovery and RecoveryPolicy(**recovery),
        device="cpu", **kw)


def _ref(topo, protocol="sync", *, rounds, scenario=None, opt="sgd", lr=0.1,
         eval_every=0, n=8, recovery=None, **kw):
    X, y = _data(n)
    full = (jnp.asarray(X), jnp.asarray(y))
    return j_run(
        _jloss, j_replicate({"w": jnp.zeros(n)}, topo.M), _opts(opt, lr)[0],
        _batches(X, y, topo.M, wrap=jnp.asarray),
        gossip=JSpec(topology=topo, backend="einsum"),
        protocol=protocol, scenario=scenario, rounds=rounds,
        eval_fn=(lambda p: float(_jloss(p, full))) if eval_every else None,
        eval_every=eval_every, recovery=recovery and JPolicy(**recovery), **kw)


def _topos(name, *args):
    return getattr(JT, name)(*args), getattr(TT, name)(*args)


def _scen(make, *args, **kw):
    return getattr(jscen, make)(*args, **kw), getattr(scenarios, make)(*args, **kw)


def _assert_same_run(j, t):
    js, ts = j.trace.signature(), t.trace.signature()
    assert [r[:6] for r in ts] == [r[:6] for r in js], "event schedules differ"
    jl = [r[6] for r in js]
    tl = [r[6] for r in ts]
    assert [x is None for x in tl] == [x is None for x in jl]
    np.testing.assert_allclose([x for x in tl if x is not None],
                               [x for x in jl if x is not None], rtol=LOSS_RTOL)
    np.testing.assert_allclose(t.params["w"].numpy(), np.asarray(j.params["w"]),
                               rtol=P_RTOL, atol=P_ATOL)
    np.testing.assert_array_equal(t.rounds, j.rounds)
    assert t.virtual_time == j.virtual_time
    je, te = j.trace.eval_curve(), t.trace.eval_curve()
    np.testing.assert_array_equal(te[0], je[0])
    np.testing.assert_allclose(te[1], je[1], rtol=LOSS_RTOL)


def _both(topos, protocol="sync", *, scen=None, **kw):
    jt, tt = topos
    js, ts = scen if scen is not None else (None, None)
    j = _ref(jt, protocol, scenario=js, **kw)
    t = _port(tt, protocol, scenario=ts, **kw)
    _assert_same_run(j, t)
    return j, t


def _bit_equal_runs(a, b):
    assert a.trace.signature() == b.trace.signature()
    for x, y in zip(_tree.leaves((a.params, a.opt_state)), _tree.leaves((b.params, b.opt_state))):
        assert torch.equal(x, y)
    np.testing.assert_array_equal(a.rounds, b.rounds)


# ---------------------------------------------------------------------------
# Timing-only engine and the straggler model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm_delay", [0.0, 0.5])
def test_straggler_simulate_equals_reference(comm_delay):
    for name, args in (("undirected_ring", (8,)), ("clique", (8,)), ("ring_lattice", (16, 4))):
        jt, tt = _topos(name, *args)
        want = JS.simulate(jt, 60, JS.spark_like(), comm_delay=comm_delay, seed=7)
        got = TS.simulate(tt, 60, TS.spark_like(), comm_delay=comm_delay, seed=7)
        np.testing.assert_array_equal(got.completion, want.completion)
        assert got.throughput == want.throughput


def test_loss_vs_time_and_throughput_by_degree_equal_reference():
    jt, tt = _topos("undirected_ring", 8)
    loss = np.linspace(1.0, 0.1, 61)
    jr = JS.simulate(jt, 60, JS.exponential(1.0), seed=0)
    tr = TS.simulate(tt, 60, TS.exponential(1.0), seed=0)
    for a, b in zip(TS.loss_vs_time(loss, tr), JS.loss_vs_time(loss, jr)):
        np.testing.assert_array_equal(a, b)
    want = JS.throughput_by_degree(lambda d: JT.ring_lattice(16, d), [2, 4, 8], 100,
                                   JS.spark_like(), seed=1)
    got = TS.throughput_by_degree(lambda d: TT.ring_lattice(16, d), [2, 4, 8], 100,
                                  TS.spark_like(), seed=1)
    assert got == want and got[2] >= got[4] >= got[8]


def test_timing_only_engine_trace_equals_reference():
    jt, tt = _topos("ring_lattice", 8, 4)
    js, ts = _scen("heavy_tail", "asciq", seed=11)
    je, te = JEngine(jt, js), Engine(tt, ts)
    je.run(JSync(executor=None), until_round=30)
    te.run(SyncGossip(executor=None), until_round=30)
    assert te.trace.signature() == je.trace.signature()
    assert len(te.trace.signature()) > 8 * 30


# ---------------------------------------------------------------------------
# The four protocols with real values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("protocol", ["sync", "async", "stale"])
def test_protocols_match_reference(protocol):
    _, t = _both(_topos("undirected_ring", 4), protocol, rounds=12,
                 scen=_scen("heavy_tail", "spark", seed=3), eval_every=4)
    # determinism within the port: the same seed, the same trace and params
    t2 = _port(TT.undirected_ring(4), protocol, rounds=12,
               scenario=scenarios.heavy_tail("spark", seed=3), eval_every=4)
    _bit_equal_runs(t, t2)


def test_hier_matches_reference_under_dci_penalty():
    jt, tt = _topos("hier", 2, 4)
    js = jscen.Scenario(name="dci", compute=jscen.sampled(jscen.uniform()),
                        link_classes=jscen.two_class_links(dci_latency=4.0), seed=2)
    ts = scenarios.Scenario(name="dci", compute=scenarios.sampled(scenarios.uniform()),
                            link_classes=scenarios.two_class_links(dci_latency=4.0), seed=2)
    j, t = _both((jt, tt), "hier", scen=(js, ts), rounds=10, mesh="topology",
                 eval_every=5)
    assert t.trace.link_accounting() == j.trace.link_accounting()
    assert t.trace.link_accounting()["dci"]["messages"] > 0


@pytest.mark.parametrize("dci_dtype", ["int8", "bfloat16"])
def test_hier_compressed_dci_matches_reference(dci_dtype):
    jt, tt = _topos("hier", 2, 2)
    js = jscen.Scenario(name="dci", link_classes=jscen.two_class_links(dci_latency=1.5))
    ts = scenarios.Scenario(name="dci",
                            link_classes=scenarios.two_class_links(dci_latency=1.5))
    j, t = _both((jt, tt), "hier", scen=(js, ts), rounds=8, mesh="topology",
                 dci_dtype=dci_dtype)
    jg = [(g.t, g.name) for g in j.trace.gauges]
    assert [(g.t, g.name) for g in t.trace.gauges] == jg
    np.testing.assert_allclose([g.value for g in t.trace.gauges],
                               [g.value for g in j.trace.gauges], rtol=1e-4, atol=1e-7)
    assert t.trace.meta["mesh"] == j.trace.meta["mesh"]


def test_mesh_equal_link_classes_bitmatch_meshless():
    topo = TT.undirected_ring(8)
    flat = _port(topo, rounds=10, scenario=scenarios.Scenario(
        name="flat", link_delay=scenarios.constant_delay(0.25)))
    meshy = _port(topo, rounds=10, scenario=scenarios.Scenario(
        name="two-class", link_classes=scenarios.two_class_links(
            ici_latency=0.25, dci_latency=0.25)), mesh=MeshSpec.pods(8, 2, payload_bytes=4096))
    _bit_equal_runs(flat, meshy)
    acct = meshy.trace.link_accounting()
    assert acct["dci"]["bytes"] == acct["dci"]["messages"] * 4096


def test_mesh_topology_payload_is_the_bus_plan():
    """mesh='topology' charges the bus layout plan's padded bytes, as the
    reference does."""
    jt, tt = _topos("hier", 2, 2)
    js = jscen.Scenario(name="bw", link_classes=jscen.two_class_links(dci_bw=1e3))
    ts = scenarios.Scenario(name="bw", link_classes=scenarios.two_class_links(dci_bw=1e3))
    j, t = _both((jt, tt), "sync", scen=(js, ts), rounds=4, mesh="topology", n=300, lr=0.001)
    assert t.trace.meta["mesh"]["payload_bytes"] == j.trace.meta["mesh"]["payload_bytes"] > 0


def test_mesh_spec_ensure_refuses_a_device_mesh():
    """A MeshSpec and None pass through, a topology's pods are adopted, a
    WorkerMesh is mirrored field by field as the reference mirrors its own,
    and anything else raises the reference's TypeError."""
    from types import SimpleNamespace

    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.launch.mesh import WorkerMesh as JWorkerMesh
    from repro.sim.scenarios import MeshSpec as JMeshSpec
    from repro_torch.launch.mesh import AbstractMesh, WorkerMesh

    topo = TT.undirected_ring(4)
    assert MeshSpec.ensure(None, topo) is None
    spec = MeshSpec.pods(4, 2)
    assert MeshSpec.ensure(spec, topo) is spec
    hier = TT.hier(2, 2)
    assert MeshSpec.ensure(hier, hier).group_of == tuple(hier.group_of)
    template = {"w": torch.empty(64, 96, device="meta"),
                "b": torch.empty(33, dtype=torch.bfloat16, device="meta")}
    jtemplate = {"w": jax.ShapeDtypeStruct((64, 96), jnp.float32),
                 "b": jax.ShapeDtypeStruct((33,), jnp.bfloat16)}
    shape, names = (2, 2, 2), ("pod", "data", "model")
    got = MeshSpec.ensure(WorkerMesh.from_mesh(AbstractMesh(shape, names)), topo,
                          params_template=template)
    want = JMeshSpec.ensure(JWorkerMesh.from_mesh(JAbstractMesh(shape, names)), JT.undirected_ring(4),
                            params_template=jtemplate)
    assert got.payload_bytes > 0
    for field in ("group_of", "payload_bytes", "dci_payload_bytes", "name"):
        assert getattr(got, field) == getattr(want, field), field
    device_mesh = SimpleNamespace(axis_names=("data",), shape={"data": 4})
    with pytest.raises(TypeError) as jerr:
        JMeshSpec.ensure(device_mesh, JT.undirected_ring(4))
    with pytest.raises(TypeError, match="cannot build a MeshSpec from SimpleNamespace") as err:
        MeshSpec.ensure(device_mesh, topo)
    assert str(err.value) == str(jerr.value)
    with pytest.raises(TypeError, match="cannot build a MeshSpec"):
        _port(topo, rounds=2, mesh=device_mesh)


# ---------------------------------------------------------------------------
# Churn, barrier timeouts and link faults
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["reabsorb", "renormalize"])
def test_sync_rides_through_permanent_failure_like_reference(mode):
    j, t = _both(_topos("undirected_ring", 6), rounds=10,
                 scen=_scen("flaky_workers", 6, fail_times={2: 3.0}, seed=4),
                 barrier_timeout=1.5, degrade_mode=mode, eval_every=2)
    done = t.trace.rounds_completed()
    assert np.all(np.delete(done, 2) == 10) and done[2] < 10


@pytest.mark.parametrize("protocol", ["sync", "hier"])
def test_preemption_wave_matches_reference(protocol):
    jt, tt = _topos("undirected_ring", 8) if protocol == "sync" else _topos("hier", 2, 4)
    kw = dict(mesh="topology") if protocol == "hier" else {}
    _, t = _both((jt, tt), protocol, rounds=12, barrier_timeout=2.0,
                 scen=_scen("preemption_wave", 8, start=3.0, interval=0.7, count=2,
                            down_for=5.0, seed=3), **kw)
    kinds = {r.kind for r in t.trace.records}
    assert {"fail", "join", "timeout"} <= kinds


@pytest.mark.parametrize("protocol", ["async", "stale"])
def test_async_protocols_churn_and_outage_match_reference(protocol):
    _both(_topos("undirected_ring", 6), protocol, rounds=12,
          scen=_scen("flaky_workers", 6, fail_times={2: 3.0}, rejoin_after=4.0, seed=0))
    _both(_topos("hier", 2, 3), protocol, rounds=8, mesh="topology",
          scen=_scen("regional_outage", pod=1, start=3.0, duration=5.0,
                     dci_latency=0.5, seed=6))


def test_barrier_timeout_nofault_bitmatch():
    kw = dict(rounds=10, scenario=scenarios.heavy_tail("spark", seed=5))
    base = _port(TT.undirected_ring(6), **kw)
    timed = _port(TT.undirected_ring(6), barrier_timeout=4.0, **kw)
    _bit_equal_runs(base, timed)


def test_knob_validation():
    with pytest.raises(ValueError, match="barrier_timeout"):
        SyncGossip(barrier_timeout=0.0)
    with pytest.raises(ValueError, match="degrade_mode"):
        SyncGossip(barrier_timeout=1.0, degrade_mode="drop")
    with pytest.raises(ValueError, match="barrier"):
        _port(TT.undirected_ring(4), "async", rounds=2, barrier_timeout=1.0)
    with pytest.raises(ValueError, match="commit"):
        _port(TT.undirected_ring(4), "async", rounds=2, commit="full")
    with pytest.raises(NotImplementedError, match="barrier_timeout"):
        _port(TT.undirected_ring(6), rounds=4,
              scenario=scenarios.preemption_wave(6, start=2.0, count=2, seed=1))
    with pytest.raises(ValueError):
        _port(TT.undirected_ring(8), "hier", rounds=2)     # no pod metadata
    with pytest.raises(ValueError, match="couples"):   # adafactor factors across workers
        TrainExecutor(_tloss, toptim.adafactor_like(0.1), t_replicate({"w": torch.zeros(3)}, 4),
                      iter(()), TSpec(topology=TT.undirected_ring(4)))
    for bad in (dict(max_retries=-1), dict(backoff_base=0.0), dict(backoff_factor=0.5),
                dict(ckpt_every=0)):
        with pytest.raises(ValueError):
            RecoveryPolicy(**bad)


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------


def _inject(worker, rnd, n_fail):
    def inject(j, k, attempt):
        return j == worker and k == rnd and attempt < n_fail
    return inject


def test_retry_with_backoff_matches_reference():
    j, t = _both(_topos("undirected_ring", 6), rounds=10,
                 scen=_scen("heavy_tail", "spark", seed=2), fault_inject=_inject(3, 5, 2),
                 recovery=dict(max_retries=3, backoff_base=0.2))
    assert t.trace.meta["recovery"] == j.trace.meta["recovery"]
    st = t.trace.meta["recovery"]
    assert st["step_failures"] == 2 and st["retries"] == 2 and st["restores"] == 0
    flagged = [r for r in t.trace.records if r.retried and r.kind == "compute_done"]
    assert len(flagged) == 2


def test_exhausted_retries_restore_from_checkpoint_like_reference(tmp_path):
    def rec(side):
        return dict(max_retries=2, backoff_base=0.1, ckpt_every=6,
                    ckpt_path=os.path.join(tmp_path, side, "ck.npz"))

    jt, tt = _topos("undirected_ring", 6)
    js, ts = _scen("heavy_tail", "spark", seed=2)
    j = _ref(jt, rounds=10, scenario=js, fault_inject=_inject(1, 8, 9), recovery=rec("j"))
    t = _port(tt, rounds=10, scenario=ts, fault_inject=_inject(1, 8, 9), recovery=rec("t"))
    _assert_same_run(j, t)
    st = t.trace.meta["recovery"]
    assert st == j.trace.meta["recovery"]
    assert st["retries"] == 2 and st["restores"] == 1 and st["checkpoints"] >= 1
    assert os.path.exists(os.path.join(tmp_path, "t", "ck.meta.json"))


def test_restore_writes_the_checkpoint_consensus_bit_for_bit(tmp_path):
    """Right after the restore, worker 1's slice IS the consensus of the
    checkpoint on disk (the run's recovery gate on the card)."""
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop

    seen = {}
    real = loop._RecoveryManager._restore

    def spy(self, j):
        real(self, j)
        like = _tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                         self.executor.W)
        want = ckpt.consensus_params(ckpt.restore(self.policy.ckpt_path, like, device="cpu"))
        seen[j] = all(torch.equal(a[j], b) for a, b in
                      zip(_tree.leaves(self.executor.W), _tree.leaves(want)))

    loop._RecoveryManager._restore = spy
    try:
        _port(TT.undirected_ring(4), rounds=4, fault_inject=_inject(1, 3, 9),
              recovery=dict(max_retries=1, backoff_base=0.1, ckpt_every=2,
                            ckpt_path=os.path.join(tmp_path, "ck")))
    finally:
        loop._RecoveryManager._restore = real
    assert seen == {1: True}


def test_rejoin_restores_consensus_like_reference(tmp_path):
    jt, tt = _topos("undirected_ring", 6)
    js, ts = _scen("flaky_workers", 6, fail_times={4: 4.0}, rejoin_after=3.0, seed=1)
    kw = dict(rounds=12)
    j = _ref(jt, "stale", scenario=js, recovery=dict(
        ckpt_path=os.path.join(tmp_path, "j", "ck.npz"), ckpt_every=8), **kw)
    t = _port(tt, "stale", scenario=ts, recovery=dict(
        ckpt_path=os.path.join(tmp_path, "t", "ck.npz"), ckpt_every=8), **kw)
    _assert_same_run(j, t)
    assert t.trace.meta["recovery"] == j.trace.meta["recovery"]
    assert t.trace.meta["recovery"]["rejoins"] == 1


def test_recovery_without_checkpoint_uses_live_mean_like_reference():
    j, t = _both(_topos("undirected_ring", 6), "async", rounds=10,
                 scen=_scen("heavy_tail", "spark", seed=7), fault_inject=_inject(0, 6, 3),
                 recovery=dict(max_retries=1, backoff_base=0.1))
    st = t.trace.meta["recovery"]
    assert st == j.trace.meta["recovery"] and st["restores"] >= 1 and st["checkpoints"] == 0


# ---------------------------------------------------------------------------
# Commit paths within the port (the reference's claims, at M <= 8)
# ---------------------------------------------------------------------------

_KRON8 = TT.kronecker(TT.undirected_ring(4), TT.clique(2))


@pytest.mark.parametrize("topo,opt,scen", [
    (TT.undirected_ring(8), "sgd", None),
    (TT.undirected_ring(8), "momentum", scenarios.heavy_tail("asciq", seed=3)),
    (_KRON8, "sgd", scenarios.heavy_tail("spark", seed=1)),
], ids=["ring8", "ring8-mom-tail", "kron8-tail"])
def test_sync_slice_equals_full(topo, opt, scen):
    kw = dict(rounds=6, opt=opt, lr=0.05, scenario=scen)
    _bit_equal_runs(_port(topo, commit="slice", **kw), _port(topo, commit="full", **kw))


def test_hier_slice_equals_full():
    kw = dict(rounds=6, opt="momentum", lr=0.05, mesh="topology",
              scenario=scenarios.heavy_tail("asciq", seed=5))
    topo = TT.hier(2, 4)
    _bit_equal_runs(_port(topo, "hier", commit="slice", **kw),
                    _port(topo, "hier", commit="full", **kw))


@pytest.mark.parametrize("protocol", ["sync", "hier"])
def test_slice_equals_full_under_preemption(protocol):
    topo = TT.undirected_ring(8) if protocol == "sync" else TT.hier(2, 4)
    kw = dict(rounds=12, lr=0.05, barrier_timeout=2.0,
              scenario=scenarios.preemption_wave(8, start=3.0, interval=0.7, count=2,
                                                 down_for=5.0, seed=3))
    if protocol == "hier":
        kw["mesh"] = "topology"
    _bit_equal_runs(_port(topo, protocol, commit="slice", **kw),
                    _port(topo, protocol, commit="full", **kw))


@pytest.mark.parametrize("scen", [None, scenarios.heavy_tail("spark", seed=2)],
                         ids=["lockstep", "tail"])
def test_batched_commits_equal_unbatched(scen):
    kw = dict(rounds=6, opt="momentum", lr=0.05, scenario=scen)
    topo = TT.ring_lattice(8, 4)
    _bit_equal_runs(_port(topo, commit_batch=True, **kw),
                    _port(topo, commit_batch=False, **kw))


@pytest.mark.parametrize("opt", ["sgd", "momentum"])
def test_sync_deterministic_times_equals_train(opt):
    X, y = _data()
    M, steps = 4, 15
    spec = TSpec(topology=TT.undirected_ring(M), backend="einsum")
    stacked = t_replicate({"w": torch.zeros(8)}, M)
    state, hist = train(_tloss, stacked, _opts(opt, 0.05)[1], _batches(X, y, M),
                        steps=steps, gossip=spec, verbose=False, device="cpu")
    sim = _port(TT.undirected_ring(M), rounds=steps, opt=opt, lr=0.05,
                scenario=scenarios.heavy_tail("asciq", seed=5))
    assert torch.equal(state.params["w"], sim.params["w"])
    assert sim.virtual_time > steps


def test_full_commit_reaches_the_fused_bus():
    """commit='full' on a fused GossipSpec mixes through gossip_mix once per
    commit (its CPU plain version here), and matches the einsum slice run."""
    from repro_torch.core import bus

    calls = []
    real = bus.gossip_mix_2d
    bus.gossip_mix_2d = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        X, y = _data()
        M, rounds = 4, 5
        fused = run_simulated(
            _tloss, t_replicate({"w": torch.zeros(8)}, M), toptim.sgd(0.05),
            _batches(X, y, M), gossip=TSpec(topology=TT.undirected_ring(M), backend="fused"),
            rounds=rounds, commit="full", device="cpu")
    finally:
        bus.gossip_mix_2d = real
    assert len(calls) == M * rounds
    sliced = _port(TT.undirected_ring(M), rounds=rounds, lr=0.05)
    np.testing.assert_allclose(fused.params["w"].numpy(), sliced.params["w"].numpy(),
                               rtol=1e-5, atol=1e-6)
    assert [r[:6] for r in fused.trace.signature()] == \
        [r[:6] for r in sliced.trace.signature()]


def test_commit_writes_rows_in_place():
    """Commits write W, opt and the planes in place: no stacked tensor is
    reallocated across a run."""
    X, y = _data()
    ex = TrainExecutor(_tloss, toptim.momentum_sgd(0.05, 0.9),
                       t_replicate({"w": torch.zeros(8)}, 4), _batches(X, y, 4),
                       TSpec(topology=TT.undirected_ring(4), backend="einsum"))
    proto = SyncGossip(executor=ex)
    eng = Engine(TT.undirected_ring(4), scenarios.heavy_tail("spark", seed=1))
    ptrs = [x.data_ptr() for x in _tree.leaves((ex.W, ex.opt))]
    orig = proto.bind

    def bind(engine, stop_round=None):
        orig(engine, stop_round)
        ptrs.extend(x.data_ptr() for p in proto._snaps.planes for x in _tree.leaves(p))

    proto.bind = bind
    eng.run(proto, until_round=6)
    after = [x.data_ptr() for x in _tree.leaves((ex.W, ex.opt))] + \
        [x.data_ptr() for p in proto._snaps.planes for x in _tree.leaves(p)]
    assert after == ptrs
    assert proto.rounds.min() == 6


# ---------------------------------------------------------------------------
# BatchCache retirement
# ---------------------------------------------------------------------------


def _counting_batches():
    k = 0
    while True:
        yield {"x": torch.full((2,), float(k))}
        k += 1


def test_batch_cache_retired_steps_raise():
    cache = BatchCache(_counting_batches())
    for k in range(6):
        assert float(cache.get(k)["x"][0]) == float(k)
    assert len(cache) == 6 and cache.floor == 0
    cache.retire_below(3)
    assert cache.floor == 3 and len(cache) == 3
    with pytest.raises(RuntimeError, match="retired"):
        cache.get(2)
    assert float(cache.get(7)["x"][0]) == 7.0
    cache.retire_below(1)
    assert cache.floor == 3
    with pytest.raises(RuntimeError):
        cache.slice(0, 0)


def test_watermark_advances_during_sync_run():
    X, y = _data()
    topo = TT.undirected_ring(8)
    ex = TrainExecutor(_tloss, toptim.sgd(0.05), t_replicate({"w": torch.zeros(8)}, 8),
                       _batches(X, y, 8), TSpec(topology=topo, backend="einsum"))
    proto = SyncGossip(executor=ex)
    Engine(topo, scenarios.heavy_tail("asciq", seed=1)).run(proto, until_round=20)
    assert proto.rounds.min() >= 20
    assert ex.batches.floor >= 18 and len(ex.batches) <= 4
    with pytest.raises(RuntimeError, match="retired"):
        ex.batches.get(0)


def test_patched_rows_are_written_in_one_copy():
    """``TrainExecutor.patched``: a copy of the stacked tree with the given
    rows written in (a row given twice keeps its last value, as row-by-row
    writes leave it), the source untouched; no rows return the source."""
    from repro_torch.sim.protocols import TrainExecutor

    M = 6
    T = {"b": torch.arange(M * 2, dtype=torch.float32).reshape(M, 2),
         "w": torch.arange(M * 6, dtype=torch.bfloat16).reshape(M, 2, 3)}
    ex = TrainExecutor(lambda p, b: p["b"].sum(), toptim.sgd(0.1), T, iter([]),
                       TSpec(topology=TT.undirected_ring(M), backend="einsum"))
    before = _tree.map(torch.clone, T)
    row = lambda v: {"b": torch.full((2,), v), "w": torch.full((2, 3), v)}
    S = ex.patched(T, [(4, row(7.0)), (1, row(-1.0)), (4, row(9.0))])
    want = _tree.map(torch.clone, T)
    for i, v in ((1, -1.0), (4, 9.0)):
        ex.set_slice_(want, i, row(v))
    for a, b in zip(_tree.leaves(S), _tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves(T), _tree.leaves(before)))
    assert ex.patched(T, []) is T
