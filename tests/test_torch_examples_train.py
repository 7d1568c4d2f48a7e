"""The training and serving examples of ``repro_torch.examples`` against the
repository's ``examples/`` scripts, on the CPU: quickstart, train_100m
(its ``small`` preset for 3 steps, meshless and on a world-size-1 gloo
mesh), serve_demo from a gossip checkpoint, and topology_matters.

Each reference script is imported by path (its ``RESULTS``, where it has
one, pointed at a temporary directory) and driven through its ``main``;
its ``train`` or ``run_dsm`` is wrapped to keep what it returns. The
port's module runs from the reference's initial weights
(``convert.params_from_jax``). Held: train_100m's Smith test picks the
same grid point and its 3 steps' losses agree to rtol 1e-5 / atol 1e-6;
each package's checkpoint loads through the other's
``load_consensus_params`` with equal leaves; greedy tokens served from one
consensus are equal (sampled ones differ by design: the port draws from a
``torch.Generator``); quickstart's and topology_matters' curves agree to
rtol 1e-4, and topology_matters prints the same verdicts. Also: no module
of ``repro_torch.examples`` imports JAX, the reference or ``benchmarks``.
"""
import importlib
import importlib.util
import json
import os
import re
import subprocess
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
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import load_consensus_params as j_load  # noqa: E402
from repro_torch import _tree, convert, problems  # noqa: E402
from repro_torch.serving.engine import load_consensus_params as t_load  # noqa: E402

STEP_RTOL, STEP_ATOL = 1e-5, 1e-6
CURVE_RTOL = 1e-4
TRAIN_STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def reference(name: str):
    """``examples/<name>.py``, imported by path."""
    spec = importlib.util.spec_from_file_location(f"reference_example_{name}",
                                                  os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def keep_returns(monkeypatch, mod, attr: str, into: list):
    """Wrap ``mod.attr`` so each call's return value lands in ``into``."""
    fn = getattr(mod, attr)

    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        into.append(out)
        return out

    monkeypatch.setattr(mod, attr, wrapped)


def jax_params(tree):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def test_quickstart_matches_reference(monkeypatch, capsys):
    ref = reference("quickstart")
    hists = []
    keep_returns(monkeypatch, ref, "train", hists)
    ref.main()
    from repro_torch.examples import quickstart

    cfg = quickstart.make_config()
    jcfg = ref.dataclasses.replace(
        ref.get_config("granite-3-2b", reduced=True), n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)
    assert (cfg.d_model, cfg.n_layers, cfg.vocab_size) == (jcfg.d_model, jcfg.n_layers,
                                                          jcfg.vocab_size)
    topo, hist = quickstart.run(device="cpu",
                                params0=jax_params(JM.init(jax.random.PRNGKey(0), jcfg)))
    want = hists[0][1]
    assert len(hist.loss) == len(want.loss) == quickstart.STEPS
    np.testing.assert_allclose(hist.loss, want.loss, rtol=CURVE_RTOL)
    np.testing.assert_allclose(hist.grad_energy, want.grad_energy, rtol=10 * CURVE_RTOL)
    assert "loss:" in capsys.readouterr().out and topo.name == "ring-4"


# ---------------------------------------------------------------------------
# train_100m and serve_demo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """train_100m --preset small --steps 3 by the reference and by the port
    from the reference's weights: ((reference lr, History), port record,
    checkpoint paths)."""
    mp = pytest.MonkeyPatch()
    tmp = tmp_path_factory.mktemp("train_100m")
    try:
        ref = reference("train_100m")
        lrs, hists = [], []
        keep_returns(mp, ref, "smith_lr_range_test", lrs)
        keep_returns(mp, ref, "train", hists)
        ckpt = {"reference": str(tmp / "reference.npz"), "port": str(tmp / "port.npz")}
        mp.setattr(sys, "argv", ["train_100m.py", "--preset", "small", "--steps",
                                 str(TRAIN_STEPS), "--ckpt", ckpt["reference"]])
        ref.main()
        from repro_torch.examples import train_100m

        mp.setattr(train_100m, "RESULTS", str(tmp))
        jcfg, _ = ref.make_config("small")
        p0 = jax_params(JM.init(jax.random.PRNGKey(0), jcfg))
        rec = train_100m.train_run("small", steps=TRAIN_STEPS, ckpt=ckpt["port"],
                                   device="cpu", params0=p0)
    finally:
        mp.undo()
    return (lrs[0], hists[0][1]), rec, ckpt, p0


def test_train_100m_smith_test_picks_the_reference_grid_point(trained):
    (want, _), rec, _, _ = trained
    lr, lrs, losses = want
    np.testing.assert_array_equal(rec["smith_lrs"], np.asarray(lrs))
    assert rec["lr"] == pytest.approx(0.3 * lr, rel=1e-12)
    finite = np.isfinite(np.asarray(losses))
    assert np.isfinite(rec["smith_losses"]).tolist() == finite.tolist()
    np.testing.assert_allclose(np.asarray(rec["smith_losses"])[finite],
                               np.asarray(losses)[finite], rtol=STEP_RTOL, atol=STEP_ATOL)


def test_train_100m_losses_match_reference(trained):
    (_, hist), rec, _, _ = trained
    assert len(rec["loss"]) == len(hist.loss) == TRAIN_STEPS
    np.testing.assert_allclose(rec["loss"], hist.loss, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert rec["n_params"] == 4_327_680 and rec["peak_gb"] is None


def test_train_100m_checkpoints_load_across_packages(trained):
    _, _, ckpt, _ = trained
    from repro_torch.examples.train_100m import make_config

    ref = reference("train_100m")
    jcfg, _ = ref.make_config("small")
    cfg, _ = make_config("small")
    for path in ckpt.values():
        got = t_load(path, cfg, device="cpu")
        want = j_load(path, jcfg)
        g, w = _tree.leaves(got), jax.tree.leaves(want)
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_train_100m_on_a_world_size_one_mesh(trained, tmp_path, monkeypatch):
    """--mesh on the CPU: a gloo world of size 1 holding the 4 workers, the
    fused bus; the losses those of the meshless run."""
    _, rec, _, p0 = trained
    from repro_torch.examples import train_100m

    monkeypatch.setattr(train_100m, "RESULTS", str(tmp_path))
    mesh = train_100m.train_run("small", steps=2, ckpt=str(tmp_path / "mesh.npz"),
                                mesh=True, device="cpu", params0=p0)
    assert not torch.distributed.is_initialized()
    assert mesh["lr"] == rec["lr"] and os.path.exists(tmp_path / "mesh.npz")
    np.testing.assert_allclose(mesh["loss"], rec["loss"][:2], rtol=STEP_RTOL, atol=STEP_ATOL)


def _served(text: str) -> dict:
    return {int(r): json.loads(t) for r, t in
            re.findall(r"^request (\d+): generated tokens (\[.*\])$", text, re.M)}


@pytest.mark.parametrize("batcher", ["continuous", "wave"])
def test_serve_demo_greedy_tokens_match_reference(trained, batcher, tmp_path, monkeypatch,
                                                  capsys):
    _, _, ckpt, _ = trained
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))   # its train_100m import
    ref = reference("serve_demo")
    monkeypatch.setattr(sys, "argv", ["serve_demo.py", "--gossip-ckpt", ckpt["port"],
                                      "--preset", "small", "--batcher", batcher])
    ref.main()
    want = _served(capsys.readouterr().out)
    from repro_torch.examples import serve_demo

    monkeypatch.setattr(serve_demo, "RESULTS", str(tmp_path))
    assert serve_demo.main(["--gossip-ckpt", ckpt["port"], "--preset", "small",
                            "--batcher", batcher, "--device", "cpu"]) == 0
    got = _served(capsys.readouterr().out)
    with open(tmp_path / "serve_demo.json") as fp:
        rec = json.load(fp)
    assert len(want) == 6 and got == want
    assert {int(k): v for k, v in rec["tokens"].items()} == want and rec["batcher"] == batcher
    assert np.asarray(rec["sampled"]).shape == (2, 6)


def test_serve_demo_falls_back_to_waves_where_the_reference_does(tmp_path, monkeypatch,
                                                                 capsys):
    from repro_torch.examples import serve_demo

    monkeypatch.setattr(serve_demo, "RESULTS", str(tmp_path))
    assert serve_demo.main(["--arch", "mamba2-2.7b", "--requests", "2", "--device",
                            "cpu"]) == 0
    assert "falling back to the wave baseline" in capsys.readouterr().out
    with open(tmp_path / "serve_demo.json") as fp:
        rec = json.load(fp)
    assert rec["batcher"] == "wave" and all(len(t) == 8 for t in rec["tokens"].values())


# ---------------------------------------------------------------------------
# topology_matters
# ---------------------------------------------------------------------------


def test_topology_matters_matches_reference(monkeypatch, tmp_path, capsys):
    ref = reference("topology_matters")
    runs = []
    keep_returns(monkeypatch, common, "run_dsm", runs)
    ref.main()
    want_out = capsys.readouterr().out
    from repro_torch.examples import topology_matters

    jp = common.problem_classifier(S=1024, n_classes=16)
    tp = problems.problem_classifier(S=1024, n_classes=16)
    monkeypatch.setattr(topology_matters, "RESULTS", str(tmp_path))
    monkeypatch.setattr(topology_matters, "run", lambda device, _run=topology_matters.run:
                        _run(device=device, problem=(tp[0], tp[1], jax_params(jp[2]),
                                                     tp[3], tp[4])))
    assert topology_matters.main(["--device", "cpu"]) == 0
    got_out = capsys.readouterr().out
    with open(tmp_path / "topology_matters.json") as fp:
        got = json.load(fp)
    # the reference's order: per split, ring then clique
    for (split, name), (losses, _, _) in zip(
            [(s, n) for s in topology_matters.SPLITS for n in ("ring", "clique")], runs):
        np.testing.assert_allclose(got[split][name], losses, rtol=CURVE_RTOL,
                                   err_msg=f"{split} {name}")
    verdicts = lambda text: re.findall(r"-> (.*)$", text, re.M)
    assert verdicts(got_out) == verdicts(want_out) and len(verdicts(want_out)) == 2


# ---------------------------------------------------------------------------
# Isolation
# ---------------------------------------------------------------------------


def test_examples_import_neither_jax_nor_reference_nor_benchmarks():
    import repro_torch.examples as tex

    names = sorted(n[:-3] for n in os.listdir(os.path.dirname(tex.__file__))
                   if n.endswith(".py") and n != "__init__.py")
    assert len(names) == 10
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    importlib.import_module('repro_torch.examples.' + n)\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro', 'benchmarks'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|repro|benchmarks)\b", re.M)
    for n in names:
        with open(os.path.join(os.path.dirname(tex.__file__), n + ".py")) as fp:
            assert not pattern.findall(fp.read()), n
