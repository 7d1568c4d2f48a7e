"""The simulator examples of ``repro_torch.examples`` against the repository's
``examples/`` scripts: fig5_realloss, straggler_wallclock, hier_wallclock,
outage_wallclock (with ``--trace``), dci_compress_wallclock and
fleet_wallclock, at ``--quick``, on the CPU.

Each reference script is imported by path, its ``RESULTS`` pointed at a
temporary directory, and run; the port's module runs the same problem from
the reference's initial weights (``convert.params_from_jax``). Both
simulators draw every virtual time from the same numpy streams, so the
virtual-time axes are equal exactly; the loss curves agree to rtol 1e-4;
every boolean of ``summary`` is equal; each time to target and crossing
time lies within one evaluation interval of the reference's.
fleet_wallclock's parity (M = 512, the reference alone ~76 s) runs under
``-m slow``; tier-1 holds its refusal of a missing card, as it holds every
module's ``main(["--device", "cuda"])``.
"""
import importlib
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the scripts' own path entries: the repository root (benchmarks) and src
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from benchmarks import common  # noqa: E402
from repro_torch import convert, problems  # noqa: E402

LOSS_RTOL = 1e-4
# dci_compress_wallclock's bf16 and int8 lanes: a float32 ulp between the two
# packages' mixes can move a value across a rounding boundary of the lossy
# wire, which then carries a whole quantization step; from the 8th point on
# the curves part by up to 1.6e-4 (bf16) and 4.6e-4 (int8) relative, the
# exact lane by 2.1e-7, and every time and byte count to target stays equal.
WIRE_RTOL = 1e-3
EXAMPLES = ("quickstart", "train_100m", "serve_demo", "topology_matters", "fig5_realloss",
            "straggler_wallclock", "hier_wallclock", "outage_wallclock",
            "dci_compress_wallclock", "fleet_wallclock")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Thousands of tiny steps: one intra-op thread runs them faster than a
    pool that several test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference(name: str):
    """``examples/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_problem(make: str, **kw):
    """The port's problem started from the reference's initial weights."""
    jp, tp = getattr(common, make)(**kw), getattr(problems, make)(**kw)
    for a, b in zip(jp[0], tp[0]):
        np.testing.assert_array_equal(np.asarray(a), b)
    p0 = convert.params_from_jax(jax.tree.map(np.asarray, jp[2]), device="cpu")
    return (tp[0], tp[1], p0, tp[3], tp[4])


def within_one_interval(t_axis, got: float, want: float, what: str) -> None:
    """``got`` within one evaluation interval of ``want`` on ``t_axis``."""
    if np.isinf(want) or np.isinf(got):
        assert got == want, what
        return
    t = np.asarray(t_axis)
    i = int(np.clip(np.searchsorted(t, want), 1, len(t) - 1))
    gap = max(np.diff(t)[max(i - 2, 0):i + 1])
    assert abs(got - want) <= gap * (1 + 1e-9), (what, got, want, gap)


def same_curves(got: dict, want: dict, what: str) -> None:
    np.testing.assert_array_equal(got["vtime"], want["vtime"], err_msg=f"{what}: vtime")
    rtol = WIRE_RTOL if got.get("dci_dtype") else LOSS_RTOL
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=rtol,
                               err_msg=f"{what}: loss curve")


def same_summary(got: dict, want: dict, curves: dict, rtol: float = LOSS_RTOL) -> None:
    """Booleans and numbers of ``summary``: booleans equal, times to target
    within one interval of the run's curve, the other floats to ``rtol``."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, bool):
            assert g == w, key
        elif key.endswith("_time_to_target"):
            within_one_interval(curves[key[:-len("_time_to_target")]]["vtime"], g, w, key)
        elif isinstance(w, float) and not key.endswith("_rounds_per_sec"):
            np.testing.assert_allclose(g, w, rtol=rtol, err_msg=key)
        elif not key.endswith("_rounds_per_sec"):
            assert g == w, key


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """``pair(name, make, problem args, **run keywords)``: (reference output,
    port output, the port's module, the port's results directory) of
    ``run(quick=True)``, each example run once per module."""
    cache = {}

    def get(name, make, problem_kw, **kw):
        if name not in cache:
            ref = reference(name)
            ref.RESULTS = str(tmp_path_factory.mktemp(f"reference_{name}"))
            port = importlib.import_module(f"repro_torch.examples.{name}")
            where = str(tmp_path_factory.mktemp(f"port_{name}"))
            saved, port.RESULTS = port.RESULTS, where
            try:
                want = ref.run(True, **kw)
                got = port.run(True, device="cpu", problem=port_problem(make, **problem_kw),
                               **kw)
            finally:
                port.RESULTS = saved
            cache[name] = (want, got, port, where)
        return cache[name]

    return get


def sim_pair(pair, name: str):
    make, kw, run_kw, _ = SIM[name]
    return pair(name, make, kw, **run_kw)


SIM = {  # name: (problem, its args at --quick, run keywords, the runs of its record)
    "fig5_realloss": ("problem_classifier", {}, {}, ("ring", "clique")),
    "hier_wallclock": ("problem_classifier", {}, {}, ("ring", "clique", "hier")),
    "outage_wallclock": ("problem_classifier", {}, {"trace": True},
                         ("ring-nofault", "ring-outage", "hier-outage")),
    "dci_compress_wallclock": ("problem_classifier", {"S": 512}, {},
                               ("fp32-exact", "bf16", "int8")),
}


@pytest.mark.parametrize("name", list(SIM))
def test_sim_example_curves_match_reference(pair, name):
    want, got, _, _ = sim_pair(pair, name)
    for job in SIM[name][3]:
        same_curves(got[job], want[job], f"{name} {job}")


@pytest.mark.parametrize("name", list(SIM))
def test_sim_example_summary_matches_reference(pair, name):
    want, got, _, _ = sim_pair(pair, name)
    same_summary(got["summary"], want["summary"], got,
                 WIRE_RTOL if name == "dci_compress_wallclock" else LOSS_RTOL)


def test_hier_crossing_within_one_interval(pair):
    want, got, port, _ = sim_pair(pair, "hier_wallclock")
    key = "hier_crosses_ring_at_vtime"
    within_one_interval(got["hier"]["vtime"], got["summary"][key], want["summary"][key], key)
    # the port's crossing_time is the reference's on the same curves
    ref = reference("hier_wallclock")
    curves = [np.asarray(want[j][k]) for j in ("hier", "ring") for k in ("vtime", "loss")]
    assert port.crossing_time(*curves) == ref.crossing_time(*curves)


def test_dci_compress_byte_columns_match_reference(pair):
    want, got, _, _ = sim_pair(pair, "dci_compress_wallclock")
    for job in ("fp32-exact", "bf16", "int8"):
        assert got[job]["dci_payload_bytes"] == want[job]["dci_payload_bytes"]
        assert got[job]["cum_dci_bytes"] == want[job]["cum_dci_bytes"]
        assert got[job]["link_accounting"] == want[job]["link_accounting"]
    # the residual norms follow the flips above; both stay bounded alike
    g, w = (np.asarray(o["int8"]["ef_residual_norms"]) for o in (got, want))
    assert g.shape == w.shape and np.isfinite(g).all() and g.max() <= 2 * w.max()


def test_outage_bundles_read_by_the_report(pair, capsys):
    """``--trace``'s bundles under the port's results directory: each one
    summarized and checked by ``python -m repro_torch.telemetry.report``."""
    from repro_torch.telemetry import report

    _, got, _, where = sim_pair(pair, "outage_wallclock")
    for job in SIM["outage_wallclock"][3]:
        run_dir = os.path.join(where, "runs", "outage", job)
        assert report.main([run_dir, "--check"]) == 0, job
        with open(os.path.join(run_dir, "report.json")) as fp:
            assert json.load(fp)["provenance"]
    assert capsys.readouterr().out.count("perfetto.json OK") == 3


def test_straggler_matches_reference(monkeypatch, capsys, tmp_path):
    ref = reference("straggler_wallclock")
    runs = {}
    simulate = ref.simulate_degree
    monkeypatch.setattr(ref, "simulate_degree",
                        lambda problem, d, **kw: runs.setdefault(d, simulate(problem, d, **kw)))
    ref.main(quick=True)
    want = capsys.readouterr().out
    from repro_torch.examples import straggler_wallclock as port

    # the port's main(), its run() given the reference's initial weights
    outs, run = [], port.run
    monkeypatch.setattr(port, "run", lambda quick, **kw: outs.append(
        run(quick, problem=port_problem("problem_classifier"), **kw)) or outs[-1])
    monkeypatch.setattr(port, "RESULTS", str(tmp_path))
    assert port.main(["--quick", "--device", "cpu"]) == 0
    (got,) = outs
    with open(tmp_path / "straggler_wallclock.json") as fp:
        record = json.load(fp)
    assert record["summary"]["target"] == got["target"] and record["provenance"]
    for d in port.DEGREES:
        t, f = got["curves"][d]
        row = record[f"degree {d}"]
        assert row["time_to_target"] == ref.time_to_target(t, f, got["target"])
        assert row["rounds"] == got["steps"] and row["wall_s"] == got["wall_s"][d] > 0
    assert sorted(got["runs"]) == sorted(runs) == port.DEGREES
    jt = {d: r.eval_curve() for d, r in runs.items()}
    target = max(c[1].min() for c in jt.values()) + 0.05
    np.testing.assert_allclose(got["target"], target, rtol=LOSS_RTOL)
    for d in port.DEGREES:
        (t, f), (jt_d, jf_d) = got["curves"][d], jt[d]
        np.testing.assert_array_equal(t, np.asarray(jt_d))
        np.testing.assert_allclose(f, np.asarray(jf_d), rtol=LOSS_RTOL)
        np.testing.assert_array_equal(got["runs"][d].trace.completion_matrix(got["steps"]),
                                      np.asarray(runs[d].trace.completion_matrix(40)))
        within_one_interval(t, ref.time_to_target(t, f, got["target"]),
                            ref.time_to_target(jt_d, jf_d, target), f"degree {d}")
    assert "sparser degree" in want


def test_fleet_run_refuses_a_missing_card(monkeypatch):
    from repro_torch.examples import fleet_wallclock

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fleet_wallclock.run(True)
    assert fleet_wallclock.M == 512 and fleet_wallclock.PODS == 8


@pytest.mark.slow
def test_fleet_matches_reference(pair):
    want, got, _, _ = pair("fleet_wallclock", "problem_linear", {"S": 8 * 512, "n": 16, "seed": 0})
    for job in ("ring-fleet", "hier-fleet"):
        same_curves(got[job], want[job], f"fleet {job}")
        assert got[job]["min_rounds_completed"] == want[job]["min_rounds_completed"]
    same_summary(got["summary"], want["summary"], got)


@pytest.mark.parametrize("name", EXAMPLES)
def test_main_refuses_a_missing_card(monkeypatch, tmp_path, name):
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(mod, "RESULTS", str(tmp_path), raising=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mod.main(["--device", "cuda"])
    assert not os.listdir(tmp_path)
