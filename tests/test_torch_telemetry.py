"""The port's telemetry plane against the JAX reference, mirroring
``tests/test_telemetry.py``.

Health gauges are numpy on both sides and must agree to 1e-12. With the
null sink the instrumented code must give bit-identical params; with a sink
the bus counters, the train window and the spans must appear, as ranges of
a ``torch.profiler`` trace too. The port runs eagerly, so its bus counters
count calls (one per step), where the reference's count compiles of its
jitted step.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro import telemetry as jtel  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.sim.trace import Trace as JTrace  # noqa: E402
from repro_torch import _tree, telemetry  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import replicate_for_workers  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.sim import scenarios  # noqa: E402
from repro_torch.sim.trace import Trace, TraceRecord  # noqa: E402
from repro_torch.train.loop import run_simulated, train  # noqa: E402

TOL = 1e-12


def _linear_problem(n=6, S_=128, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(S_, n))
    y = X @ rng.normal(size=n) + 0.1 * rng.normal(size=S_)

    def loss(params, batch):
        bx, by = batch
        return torch.mean((bx @ params["w"] - by) ** 2)

    return X.astype(np.float32), y.astype(np.float32), {"w": torch.zeros(n)}, loss


def _batches(X, y, M, seed=0):
    parts = pad_to_equal(random_split(len(X), M, seed=seed))
    batcher = WorkerBatcher((X, y), parts, batch_size=16, seed=seed)
    while True:
        yield batcher.next()


def _sim(protocol, topo, *, rounds, scenario, seed=0, **kw):
    X, y, params0, loss = _linear_problem(seed=seed)
    return run_simulated(
        loss, replicate_for_workers(params0, topo.M), sgd(0.1), _batches(X, y, topo.M, seed),
        gossip=GossipSpec(topology=topo, backend="einsum"), protocol=protocol,
        scenario=scenario, rounds=rounds, device="cpu", **kw)


# ---------------------------------------------------------------------------
# Health gauges against the reference
# ---------------------------------------------------------------------------

_TOPOS = [("undirected_ring", (8,)), ("clique", (8,)), ("hier", (4, 4)),
          ("ring_lattice", (16, 4)), ("star", (7,))]


@pytest.mark.parametrize("gamma", [0.5, 0.9, 0.99])
@pytest.mark.parametrize("name,args", _TOPOS)
def test_health_gauges_equal_reference(name, args, gamma):
    A = getattr(TT, name)(*args).A
    np.testing.assert_array_equal(A, getattr(JT, name)(*args).A)
    got, want = telemetry.health_gauges(A, gamma), jtel.health_gauges(A, gamma)
    assert set(got) == set(want) == {"spectral_gap", "lambda2", "effective_neighbors"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=TOL, abs=TOL), k


@pytest.mark.parametrize("mode", ["reabsorb", "renormalize"])
def test_active_matrix_and_repaired_gauges_equal_reference(mode):
    for name, args, dead in (("undirected_ring", (8,), [2, 5]), ("hier", (4, 4), [4, 5, 6, 7])):
        tt, jt = getattr(TT, name)(*args), getattr(JT, name)(*args)
        alive = np.ones(tt.M, bool)
        alive[dead] = False
        blocked = lambda i, j: (i, j) == (1, 0)
        for hier in (False, True):
            got = telemetry.active_matrix(tt, alive, mode=mode, hier=hier, blocked=blocked)
            want = jtel.active_matrix(jt, alive, mode=mode, hier=hier, blocked=blocked)
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
            assert telemetry.effective_neighbors(got, 0.9) == pytest.approx(
                jtel.effective_neighbors(want, 0.9), rel=TOL)
        np.testing.assert_array_equal(telemetry.active_matrix(tt), tt.A)


def test_effective_neighbors_extremes():
    M = 12
    assert telemetry.effective_neighbors(np.eye(M)) == pytest.approx(1.0)
    assert telemetry.effective_neighbors(np.ones((M, M)) / M) == pytest.approx(M)
    assert telemetry.effective_neighbors(np.ones((1, 1))) == 1.0
    with pytest.raises(ValueError):
        telemetry.HealthConfig(gamma=1.0)


def test_round_bytes_by_class_equal_reference():
    tt, jt = TT.hier(4, 4), JT.hier(4, 4)
    got = telemetry.round_bytes_by_class(tt, 1000, tt.group_of)
    assert got == jtel.round_bytes_by_class(jt, 1000, jt.group_of)
    assert got["ici"] > 0 and got["dci"] > 0


# ---------------------------------------------------------------------------
# Instrumented code: off is bit-identical, on records
# ---------------------------------------------------------------------------


def test_disabled_telemetry_train_bit_match():
    X, y, params0, loss = _linear_problem()
    M = 4
    spec = GossipSpec(topology=TT.undirected_ring(M), backend="fused")
    p0 = replicate_for_workers(params0, M)
    s1, h1 = train(loss, p0, sgd(0.05), _batches(X, y, M), steps=12, gossip=spec,
                   log_every=4, verbose=False, device="cpu")
    with telemetry.run() as tel:
        s2, h2 = train(loss, p0, sgd(0.05), _batches(X, y, M), steps=12, gossip=spec,
                       log_every=4, verbose=False, device="cpu")
    assert torch.equal(s1.params["w"], s2.params["w"])
    assert h1.loss == h2.loss
    assert tel.counters["train.steps"] == 12
    assert tel.counters["bus.mix_calls"] == 12        # one fused mix per step
    assert tel.counters["bus.collectives"] == 12 * 2  # ring: two permutations
    windows = [s for s in tel.spans if s["name"] == "train.window"]
    assert [w["attrs"]["steps"] for w in windows] == [1, 4, 4, 3]
    assert any(s["name"] == "train.host_sync" for s in tel.spans)
    assert tel.gauges[-1]["name"] == "train.loss" and tel.gauges[-1]["value"] == h2.loss[-1]
    assert telemetry.get() is telemetry.NULL


def test_train_checkpoint_counter(tmp_path):
    X, y, params0, loss = _linear_problem()
    with telemetry.run() as tel:
        train(loss, replicate_for_workers(params0, 4), sgd(0.05), _batches(X, y, 4), steps=5,
              gossip=GossipSpec(topology=TT.undirected_ring(4), backend="einsum"),
              ckpt_path=str(tmp_path / "ck"), ckpt_every=2, verbose=False, device="cpu")
    assert tel.counters["train.checkpoints"] == 3


def test_bus_counters_match_bulk_formula():
    from repro_torch.core.bus import bulk_collectives_per_step, mix_bus

    spec = GossipSpec(topology=TT.ring_lattice(8, 4))
    params = {"w": torch.ones((8, 40)), "b": torch.ones((8, 3))}
    with telemetry.run() as tel:
        mix_bus(params, spec, nchunks=2)
    assert tel.counters["bus.collectives"] == bulk_collectives_per_step(spec, 2) == 4 * 2
    assert tel.counters["bus.mix_calls"] == 1
    assert tel.gauges[0]["name"] == "bus.padded_bytes" and tel.gauges[0]["value"] > 0


def test_compressed_bus_gauges():
    from repro_torch.core.bus import mix_bus_compressed

    spec = GossipSpec(topology=TT.undirected_ring(4))
    params = {"w": torch.randn((4, 300)), "i": torch.ones((4, 3), dtype=torch.int32)}
    with telemetry.run() as tel:
        mix_bus_compressed(params, spec, wire_dtype="int8")
    assert tel.counters["bus.mix_calls"] == 1
    # float group: values + scales per permutation; the int group rides exact
    assert tel.counters["bus.collectives"] == 2 * (2 + 1)
    g = {x["name"]: x["value"] for x in tel.gauges}
    assert g["bus.dci_bytes_ratio"] > 1.0 and g["bus.dci_padded_bytes"] > 0


def test_disabled_hooks_record_nothing():
    from repro_torch.core.bus import mix_bus

    assert telemetry.get() is telemetry.NULL
    out = mix_bus({"w": torch.ones((4, 5))}, GossipSpec(topology=TT.undirected_ring(4)))
    assert torch.equal(out["w"], torch.ones((4, 5)))


def test_fused_mix_annotation_in_profiler_trace():
    """With a sink active, a torch.profiler trace shows the bus.fused_mix
    range around the mix; with the null sink there is no such range."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.bus import mix_bus

    spec = GossipSpec(topology=TT.undirected_ring(4))
    params = {"w": torch.ones((4, 50))}

    def names():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            mix_bus(params, spec)
        return {e.key for e in prof.key_averages()}

    assert "bus.fused_mix" not in names()
    with telemetry.run():
        assert "bus.fused_mix" in names()


# ---------------------------------------------------------------------------
# Spans and counters of the train step and the bus
# ---------------------------------------------------------------------------

# span -> its parent in the sink (the innermost span open where it opens)
_STEP_SPANS = {"train.step": None, "train.grad": "train.step", "train.forward": "train.grad",
               "model.remat.recompute": "train.grad", "train.optim": "train.step",
               "train.stats": "train.step", "bus.mix": "train.step", "bus.pack": "bus.mix",
               "bus.fused_mix": "bus.mix", "bus.kernel": "bus.fused_mix",
               "bus.unpack": "bus.mix"}


@pytest.fixture(scope="module")
def traced_remat_step():
    """One fused-bus step of a tiny remat decoder on a 4-ring: with the null
    sink, then from the same state with a sink under a CPU profile."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd

    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(), remat=True, d_model=64,
                              n_heads=2, n_kv_heads=1, head_dim=32, d_ff=128, vocab_size=97)
    M = 4
    params = replicate_for_workers(Mo.init(torch.Generator().manual_seed(0), cfg, "cpu"), M)
    opt = momentum_sgd(0.01, 0.9)
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt,
                           gossip=GossipSpec(topology=TT.undirected_ring(M), backend="fused"))
    state = init_state(params, opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (M, 2, 17),
                                     generator=torch.Generator().manual_seed(1))}
    off = step(state, batch)
    with telemetry.run() as tel:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            on = step(state, batch)
    return dict(cfg=cfg, params=params, off=off, on=on, tel=tel, events=prof.events(),
                trace_start_ns=prof.profiler.kineto_results.trace_start_ns())


def test_sink_leaves_the_step_bit_identical(traced_remat_step):
    (s_off, m_off), (s_on, m_on) = traced_remat_step["off"], traced_remat_step["on"]
    assert s_off.step == s_on.step == 1
    for a, b in zip(_tree.leaves((s_off.params, s_off.opt_state)),
                    _tree.leaves((s_on.params, s_on.opt_state))):
        assert torch.equal(a, b)
    for a, b in zip(m_off, m_on):
        assert torch.equal(a, b)


def test_step_spans_nest_in_the_sink_and_the_profile(traced_remat_step):
    t, layers = traced_remat_step, traced_remat_step["cfg"].n_layers
    spans = t["tel"].spans
    counts = {n: sum(1 for s in spans if s["name"] == n) for n in _STEP_SPANS}
    assert counts == {n: layers if n == "model.remat.recompute" else 1 for n in _STEP_SPANS}
    assert {s["name"]: s["parent"] for s in spans} == _STEP_SPANS
    ranges = [e for e in t["events"] if e.name in _STEP_SPANS]
    assert sorted(e.name for e in ranges) == sorted(
        n for n in _STEP_SPANS for _ in range(counts[n]))

    def enclosing(e):
        up = e.cpu_parent
        while up is not None and up.name not in _STEP_SPANS:
            up = up.cpu_parent
        return None if up is None else up.name

    assert {e.name: enclosing(e) for e in ranges} == _STEP_SPANS
    for e in ranges:
        if e.name == "model.remat.recompute":
            inside = []
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                inside.append(c.name)
                stack.extend(c.cpu_children)
            assert "aten::mm" in inside or "aten::matmul" in inside
            assert not any("Backward" in n for n in inside)


def test_bus_byte_counters_match_the_layout(traced_remat_step):
    from repro_torch.core.bus import plan_layout

    t = traced_remat_step
    layout, k = plan_layout(t["params"]), 2            # the ring: two permutations
    M = _tree.leaves(t["params"])[0].shape[0]
    leaf_b = sum(x.numel() * x.element_size() for x in _tree.leaves(t["params"]))
    buf_b = M * layout.padded_bytes()
    # params and updates share the bf16 group: each packed (read + write),
    # k neighbour stacks gathered, the kernel reads w, k stacks, the update
    # and writes the result; unpack hands out views
    c = t["tel"].counters
    assert {n: c[n] for n in ("bus.bytes_packed", "bus.bytes_gathered", "bus.bytes_kernel",
                              "bus.bytes_unpacked")} == {
        "bus.bytes_packed": 2 * (leaf_b + buf_b), "bus.bytes_gathered": 2 * k * buf_b,
        "bus.bytes_kernel": (k + 3) * buf_b, "bus.bytes_unpacked": 0}


def test_stats_counters_count_the_plain_leaves_on_cpu(traced_remat_step):
    """On the CPU the statistics take the plain version: every gradient and
    new-param leaf counted in ``stats.plain_leaves``, nothing read by the
    kernel, no ``stats.kernel`` span (the span test above)."""
    t = traced_remat_step
    c = t["tel"].counters
    n = len(_tree.leaves(t["params"]))
    assert {k: c[k] for k in ("stats.bytes_kernel", "stats.plain_leaves",
                              "stats.reread_columns")} == {
        "stats.bytes_kernel": 0, "stats.plain_leaves": 2 * n, "stats.reread_columns": 0}


def test_span_intervals_lie_on_the_profile_clock(traced_remat_step):
    """Shifted by the saved origin, a span's interval lies on its profiler
    range: each overlaps it, and their starts and ends agree within 1 ms at
    the median (a host descheduled between the two clock reads moves one
    pair apart, and the first range of a process pays a one-time cost)."""
    t = traced_remat_step
    clock = t["tel"].to_json()["clock"]
    ranges = {}
    for e in t["events"]:
        if e.name in _STEP_SPANS:
            ranges.setdefault(e.name, []).append(e)
    gaps_ms = []
    for s in t["tel"].spans:
        e = min(ranges[s["name"]],
                key=lambda e: abs(e.time_range.start * 1e3 + t["trace_start_ns"]
                                  - clock["unix_ns"] - s["ts"] * 1e9))
        lo = (t["trace_start_ns"] - clock["unix_ns"]) / 1e6 + e.time_range.start / 1e3
        hi = lo + (e.time_range.end - e.time_range.start) / 1e3
        start, end = s["ts"] * 1e3, (s["ts"] + s["dur"]) * 1e3
        assert start < hi and lo < end, s["name"]
        gaps_ms += [abs(start - lo), abs(end - hi)]
    assert sorted(gaps_ms)[len(gaps_ms) // 2] < 1.0, gaps_ms
    assert all(s["parent"] == "train.grad" for s in t["tel"].spans
               if s["name"] == "model.remat.recompute")


def test_health_gauges_do_not_perturb_trace_signature():
    topo = TT.undirected_ring(4)
    scen = scenarios.heavy_tail("spark", seed=3)
    r_off = _sim("sync", topo, rounds=10, scenario=scen)
    r_on = _sim("sync", topo, rounds=10, scenario=scen, health=True)
    assert r_off.trace.signature() == r_on.trace.signature()
    assert torch.equal(r_off.params["w"], r_on.params["w"])
    assert len(r_off.trace.gauges) == 0 and len(r_on.trace.gauges) == 3


# ---------------------------------------------------------------------------
# Trace gauges, the traced run bundle, Perfetto and the report
# ---------------------------------------------------------------------------


def test_trace_gauge_json_roundtrip_across_packages(tmp_path):
    tr = Trace(2)
    tr.record(TraceRecord(0, 0.5, "compute_done", 0, round=1, loss=1.0))
    tr.record_gauge(0.0, "health.spectral_gap", 0.25)
    tr.record_gauge(1.5, "health.effective_neighbors", 3.5)
    path = tr.save(str(tmp_path / "trace.json"))
    for cls in (Trace, JTrace):
        back = cls.load(path)
        assert [(g.t, g.name, g.value) for g in back.gauges] == \
            [(0.0, "health.spectral_gap", 0.25), (1.5, "health.effective_neighbors", 3.5)]
        assert back.signature() == tr.signature()
    bare = Trace(1)
    assert "gauges" not in bare.to_json()


@pytest.fixture(scope="module")
def traced_outage_run(tmp_path_factory):
    run_dir = str(tmp_path_factory.mktemp("outage-run"))
    topo = TT.hier(2, 2)
    scen = scenarios.regional_outage(pod=1, start=2.0, duration=4.0, seed=3)
    with telemetry.run(run_dir):
        r = _sim("hier", topo, rounds=10, scenario=scen, mesh="topology",
                 barrier_timeout=1.5, health=True, run_dir=run_dir)
    return run_dir, r


def test_traced_run_emits_bundle(traced_outage_run):
    run_dir, r = traced_outage_run
    for f in ("trace.json", "perfetto.json", "telemetry.json"):
        assert os.path.exists(os.path.join(run_dir, f)), f
    prov = json.load(open(os.path.join(run_dir, "trace.json")))["meta"]["provenance"]
    assert prov["schema_version"] == telemetry.SCHEMA_VERSION
    assert "config_digest" in prov and prov["writer"] == "run_simulated"
    gaps = [g.value for g in r.trace.gauges if g.name == "health.spectral_gap"]
    assert len(gaps) >= 3
    assert min(gaps) < gaps[0] and gaps[-1] == pytest.approx(gaps[0])


def test_perfetto_export_equals_reference_rendering(traced_outage_run):
    """The port's exporter renders the run's trace exactly as the
    reference's exporter renders the same trace file."""
    run_dir, r = traced_outage_run
    doc = json.load(open(os.path.join(run_dir, "perfetto.json")))
    assert telemetry.validate_chrome_trace(doc) == []
    want = jtel.trace_to_perfetto(JTrace.load(os.path.join(run_dir, "trace.json")))
    got = telemetry.trace_to_perfetto(Trace.load(os.path.join(run_dir, "trace.json")))
    assert json.loads(json.dumps(got, default=float)) == json.loads(json.dumps(want, default=float))
    evs = doc["traceEvents"]
    n_rounds = sum(1 for e in evs if e["ph"] == "X" and e["name"].startswith("round "))
    assert n_rounds == sum(1 for rec in r.trace.records
                           if rec.kind == "compute_done" and not rec.retried)
    assert any(e["ph"] == "C" and e["name"] == "health.spectral_gap" for e in evs)


def test_validate_chrome_trace_rejects_malformed():
    assert telemetry.validate_chrome_trace([]) != []
    bad = {"traceEvents": [{"ph": "X", "name": "x", "pid": 1, "tid": 0, "ts": -5, "dur": 1}]}
    assert any("bad ts" in e for e in telemetry.validate_chrome_trace(bad))
    good = {"traceEvents": [{"ph": "i", "s": "t", "name": "ok", "pid": 1, "tid": 0,
                             "ts": 0.0}]}
    assert telemetry.validate_chrome_trace(good) == []


def test_report_summarize_and_check(traced_outage_run, capsys):
    from repro.telemetry import report as jreport
    from repro_torch.telemetry import report

    run_dir, r = traced_outage_run
    summary = report.summarize(run_dir)
    want = jreport.summarize(run_dir)
    summary.pop("provenance"), want.pop("provenance")
    assert summary == want
    assert summary["workers"] == r.trace.M and summary["links"]
    assert summary["gauges"]["health.spectral_gap"]["n"] >= 3
    assert "health.spectral_gap" in report.render(summary)
    assert report.main([run_dir, "--check"]) == 0
    assert os.path.exists(os.path.join(run_dir, "report.json"))
    assert "perfetto.json OK" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        report.summarize(os.path.join(run_dir, "missing"))


# ---------------------------------------------------------------------------
# Provenance and sink mechanics
# ---------------------------------------------------------------------------


def test_provenance_header_and_digest_equal_reference():
    cfg = {"a": 1, "b": [2, 3]}
    p = telemetry.provenance(config=cfg, writer="t")
    assert p["schema_version"] == jtel.SCHEMA_VERSION
    assert p["config_digest"] == jtel.config_digest(cfg) == telemetry.config_digest(
        {"b": [2, 3], "a": 1})
    assert isinstance(p["git_sha"], str) and p["git_sha"] and p["writer"] == "t"
    payload = {"x": 1}
    telemetry.stamp(payload, writer="w1")
    first = payload["provenance"]
    telemetry.stamp(payload, writer="w2")
    assert payload["provenance"] is first and telemetry.stamp([1, 2]) == [1, 2]


def test_null_sink_is_inert_and_reusable():
    tel = telemetry.NULL
    assert tel.active is False
    with tel.span("x") as s:
        assert s is None
    assert tel.span("y") is tel.span("z", tag=1)   # one shared context, no allocation
    assert not hasattr(tel, "annotate")
    tel.counter("c")
    tel.gauge("g", 1.0)
    tel.save()


def test_run_context_installs_saves_and_restores(tmp_path):
    run_dir = str(tmp_path / "rd")
    assert telemetry.get() is telemetry.NULL
    with telemetry.run(run_dir, meta={"k": "v"}) as tel:
        assert telemetry.get() is tel and telemetry.enabled()
        tel.counter("n", 2)
        tel.counter("n", 3)
        with tel.span("work", tag="a"):
            pass
        tel.instant("evt")
    assert telemetry.get() is telemetry.NULL
    blob = json.load(open(os.path.join(run_dir, "telemetry.json")))
    assert blob["meta"] == {"k": "v"} and blob["counters"] == {"n": 5}
    assert blob["spans"][0]["name"] == "work" and blob["spans"][0]["attrs"] == {"tag": "a"}
    assert blob["instants"][0]["name"] == "evt"


def test_recovery_counters_reach_the_sink():
    def inject(j, k, attempt):
        return j == 1 and k == 3 and attempt < 1

    with telemetry.run() as tel:
        r = _sim("sync", TT.undirected_ring(4), rounds=5, scenario=scenarios.ideal(),
                 fault_inject=inject)
    assert tel.counters["recovery.step_failures"] == 1 == r.trace.meta["recovery"]["retries"]
    assert all(torch.isfinite(x).all() for x in _tree.leaves(r.params))
