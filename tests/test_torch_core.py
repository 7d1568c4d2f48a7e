"""Parity of the port's numpy-level pieces with the JAX reference: topologies,
data, leaf order, bus layout, array conversion; plus the port's isolation
from JAX and its refusal to run on a missing card."""
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import data as jdata  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import bus as jbus  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import data as tdata  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core import bus as tbus  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")

TOPOLOGIES = [("ring", 4), ("ring", 8), ("clique", 5), ("torus", 9),
              ("torus", 16), ("hypercube", 8)]


# ---------------------------------------------------------------------------
# Topology: bit-equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,M", TOPOLOGIES)
def test_topology_matrix_and_permutations_bit_equal(name, M):
    j, t = JT.make(name, M), TT.make(name, M)
    assert t.name == j.name and t.circulant_offsets == j.circulant_offsets
    np.testing.assert_array_equal(t.A, j.A)
    jp, tp = j.permutations(), t.permutations()
    assert len(tp) == len(jp)
    for (wj, pj), (wt, pt) in zip(jp, tp):
        assert wt == wj
        np.testing.assert_array_equal(pt, pj)
    assert t.spectral_gap == j.spectral_gap
    np.testing.assert_array_equal(TT.permutation_decomposition(t.A)[0][1],
                                  JT.permutation_decomposition(j.A)[0][1])


# ---------------------------------------------------------------------------
# Data: bit-equal for a seed
# ---------------------------------------------------------------------------


def test_generators_and_worker_batches_bit_equal():
    for jf, tf, kw in [(jdata.linear_regression_data, tdata.linear_regression_data, dict(S=256, n=8)),
                       (jdata.classification_data, tdata.classification_data, dict(S=256, n=8)),
                       (jdata.token_stream, tdata.token_stream, dict(S=64, seq_len=16, vocab=97))]:
        for a, b in zip(jf(seed=3, **kw), tf(seed=3, **kw)):
            np.testing.assert_array_equal(a, b)
    toks, _ = tdata.token_stream(S=64, seq_len=16, vocab=97, seed=1)
    jparts = jdata.pad_to_equal(jdata.random_split(len(toks) - 3, 4, seed=2), seed=2)
    tparts = tdata.pad_to_equal(tdata.random_split(len(toks) - 3, 4, seed=2), seed=2)
    np.testing.assert_array_equal(tparts, jparts)
    jb = jdata.WorkerBatcher((toks,), jparts, batch_size=5, seed=7)
    tb = tdata.WorkerBatcher((toks,), tparts, batch_size=5, seed=7)
    for _ in range(3):
        np.testing.assert_array_equal(tb.next()[0], jb.next()[0])


def test_worker_batcher_full_local_bit_equal():
    X, y = tdata.classification_data(S=96, n=5, seed=4)
    parts = tdata.pad_to_equal(tdata.random_split(len(X), 4, seed=3), seed=3)
    got = tdata.WorkerBatcher((X, y), parts, batch_size=3).full_local()
    want = jdata.WorkerBatcher((X, y), parts, batch_size=3).full_local()
    assert [a.shape for a in got] == [(4, parts.shape[1], 5), (4, parts.shape[1])]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Leaf order and the bus layout
# ---------------------------------------------------------------------------


def _granite_pair(scanned: bool):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=96, n_layers=3)
    if scanned:   # the full config's layout: layers stacked on a leading dim
        return jget_config("granite-3-2b", **kw), tget_config("granite-3-2b", **kw)
    return (jget_config("granite-3-2b", reduced=True, **kw),
            tget_config("granite-3-2b", reduced=True, **kw))


def _jax_path(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


@pytest.mark.parametrize("scanned", [True, False])
def test_tree_order_matches_jax(scanned):
    jcfg, tcfg = _granite_pair(scanned)
    assert jcfg.scan_layers == tcfg.scan_layers == scanned
    jflat, _ = jax.tree_util.tree_flatten_with_path(JM.model_defs(jcfg))
    tflat = _tree.flatten_with_path(TM.model_defs(tcfg))
    assert [p for p, _ in tflat] == [_jax_path(p) for p, _ in jflat]
    assert [d.shape for _, d in tflat] == [d.shape for _, d in jflat]
    # unflatten(flatten(t)) is the identity, and map keeps the structure
    tree = TM.model_defs(tcfg)
    leaves, treedef = _tree.flatten(tree)
    assert _tree.unflatten(treedef, leaves) == tree
    assert _tree.flatten(_tree.map(lambda d: d.shape[0], tree))[1] == treedef


def _layout_fields(layout, dtype_name):
    return (
        layout.shapes,
        [(dtype_name(g.dtype), [dataclasses.astuple(s) for s in g.slots], g.n,
          g.rows, g.cols, g.block_r, g.split_off, g.split_end) for g in layout.groups],
        layout.padded_bytes(), layout.padded_elements(), layout.payload_elements(),
        layout.n_buffers, layout.shards)


def _mixed_tree(rng):
    return {"b": {"w": rng.normal(size=(3, 37, 5)).astype(np.float32),
                  "h": rng.normal(size=(3, 300)).astype(np.float32)},
            "a": [rng.normal(size=(3, 7)).astype(jnp.bfloat16),
                  rng.normal(size=(3, 2, 129)).astype(jnp.bfloat16)],
            "c": rng.normal(size=(3, 1)).astype(np.float32)}


def _reduced_granite_params(M=4):
    """Worker-stacked float32 values in the reduced granite tree's shapes."""
    rng = np.random.default_rng(0)
    defs = JM.model_defs(jget_config("granite-3-2b", reduced=True))
    return jax.tree.map(lambda d: rng.normal(size=(M,) + d.shape).astype(np.float32), defs)


@pytest.mark.parametrize("which", ["granite", "mixed"])
def test_plan_layout_matches_reference(which, rng):
    tree = _reduced_granite_params() if which == "granite" else _mixed_tree(rng)
    jl = jbus.plan_layout(jax.tree.map(jnp.asarray, tree))
    tl = tbus.plan_layout(convert.params_from_jax(tree, device="cpu"))
    assert _layout_fields(tl, lambda d: str(d).split(".")[1]) == \
        _layout_fields(jl, lambda d: jnp.dtype(d).name)


@pytest.mark.parametrize("which", ["granite", "mixed"])
def test_pack_matches_reference_and_round_trips(which, rng):
    tree = _reduced_granite_params() if which == "granite" else _mixed_tree(rng)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = convert.params_from_jax(tree, device="cpu")
    jbufs = jbus.pack(jt, jbus.plan_layout(jt))
    layout = tbus.plan_layout(tt)
    tbufs = tbus.pack(tt, layout)
    for jb, tb in zip(jbufs, tbufs):
        assert tb.dtype == {"float32": torch.float32, "bfloat16": torch.bfloat16}[jb.dtype.name]
        np.testing.assert_array_equal(tb.float().numpy(), np.asarray(jb, np.float32))
    back = tbus.unpack(tbufs, layout)
    for a, b in zip(_tree.leaves(tt), _tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Conversion
# ---------------------------------------------------------------------------


def test_params_round_trip_bit_exact(rng):
    tree = _mixed_tree(rng)
    back = convert.params_to_numpy(convert.params_from_jax(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), _tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    as_f32 = convert.params_from_jax(tree, device="cpu", dtype=torch.float32)
    assert {x.dtype for x in _tree.leaves(as_f32)} == {torch.float32}


# ---------------------------------------------------------------------------
# Isolation from JAX, and no quiet CPU fallback
# ---------------------------------------------------------------------------


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20


def test_port_sources_never_name_jax_or_reference():
    pattern = re.compile(r"^\s*(import jax|from jax)|\bimport repro\b|\bfrom repro\b|\brepro\.",
                         re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith((".py", ".cu"))]
    assert len(files) > 20
    for path in files:
        with open(path, encoding="utf-8") as f:
            hits = pattern.findall(f.read())
        assert not hits, (path, hits)


def test_entry_points_refuse_a_missing_card(monkeypatch, rng):
    from repro_torch.optim import sgd
    from repro_torch.train import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.ones(3, np.float32)}
    cfg = tget_config("granite-3-2b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.params_from_jax(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.to_device(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init(gen, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(lambda p, b: p["w"].sum(), convert.params_from_jax(tree, device="cpu"),
              sgd(0.1), iter([]), steps=1, mode="allreduce")
    assert convert.to_device(tree, device="cpu")["w"].device.type == "cpu"
    assert TM.init(gen, cfg, device="cpu")["embed"].device.type == "cpu"


# ---------------------------------------------------------------------------
# Gradient statistics and the consensus spread: the reference's public pair
# ---------------------------------------------------------------------------


def _stats_inputs():
    """tests/test_decentralized.py's inputs: its (4, 2) gradient tree, and
    the (8, 4) seeded normal params after 0 and 25 ring mixes."""
    from repro.core.gossip import mix_pytree_reference

    grads = {"a": np.asarray([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0], [0.0, 0.0]], np.float32)}
    x = {"w": jnp.asarray(np.random.default_rng(0).normal(size=(8, 4)), jnp.float32)}
    mixed, A = x, JT.undirected_ring(8).A
    for _ in range(25):
        mixed = mix_pytree_reference(mixed, A)
    return grads, [x, mixed]


def _seed_sq_norms(leaves, flags):
    """The statistics' plain arithmetic before the consensus_stats kernel
    (``core/decentralized.py``: ``_sq_norms``), kept as the oracle."""
    z = torch.zeros((), dtype=torch.float32)
    parts = [z, z]
    for x, sharded in zip(leaves, flags):
        i = 0 if sharded else 1
        parts[i] = parts[i] + torch.sum(torch.square(x.float()))
    return parts[0], parts[1]


def _seed_spread(leaves, M, flags):
    """``_spread`` as it was, meshless."""
    sizes = [x[0].numel() for x in leaves]
    flat = torch.empty(sum(sizes), dtype=torch.float32)
    means = [v.view(x.shape[1:]) for x, v in zip(leaves, flat.split(sizes))]
    for x, v in zip(leaves, means):
        torch.sum(x, 0, dtype=torch.float32, out=v)
    flat.div_(M)
    z = torch.zeros((), dtype=torch.float32)
    spread, mean_sq = [z, z], [z, z]
    for x, v, sharded in zip(leaves, means, flags):
        mean, i = v.to(x.dtype), 0 if sharded else 1
        spread[i] = spread[i] + torch.sum(torch.square((x - mean).float()))
        mean_sq[i] = mean_sq[i] + torch.sum(torch.square(mean.float()))
    return tuple(spread), tuple(mean_sq)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_statistics_equal_the_seed_composition_bit_for_bit(dtype):
    """kernels/consensus_stats/ref.py, which CPU tensors take, is the
    arithmetic step_metrics had before the kernel, bit for bit, on
    _stats_inputs' trees (with and without sharded leaves)."""
    from repro_torch.core import decentralized as tdec
    from repro_torch.kernels.consensus_stats import consensus_stats_reference

    grads, params = _stats_inputs()
    params.append({"a": grads["a"], "b": np.arange(12, dtype=np.float32).reshape(4, 3)})
    trees = [convert.params_from_jax(jax.tree.map(np.asarray, t), device="cpu")
             for t in [grads] + params]
    for tree in trees:
        leaves = [x.to(dtype) for x in _tree.leaves(tree)]
        M = leaves[0].shape[0]
        for flags in ([i == 0 for i in range(len(leaves))], [False] * len(leaves)):
            E = _seed_sq_norms(leaves, flags)
            E_sp, mean_sq = _seed_spread(leaves, M, flags)
            spread, _ = _seed_spread(leaves, M, flags)
            want = torch.stack([torch.stack(p) for p in (E, E_sp, mean_sq, spread)])
            got = consensus_stats_reference(leaves, leaves, M, grad_sharded=flags,
                                            param_sharded=flags)
            assert torch.equal(got, want)
        t = _tree.map(lambda x: x.to(dtype), tree)     # want: every leaf whole
        E, E_sp, H = tdec.gradient_stats(t)
        assert torch.equal(torch.stack([E, E_sp, H]), torch.stack(
            [want[0, 1], want[1, 1], torch.sqrt(M * want[2, 1])]))
        assert torch.equal(tdec.param_spread(t), want[3, 1])


def test_gradient_stats_and_param_spread_match_reference():
    from repro.core import decentralized as jdec
    from repro_torch.core import decentralized as tdec

    grads, params = _stats_inputs()
    params.append({"a": grads["a"], "b": np.arange(12, dtype=np.float32).reshape(4, 3)})
    for g in [grads, params[-1]] + params[:2]:
        want = [np.asarray(v) for v in jdec.gradient_stats(jax.tree.map(jnp.asarray, g))]
        got = tdec.gradient_stats(convert.params_from_jax(jax.tree.map(np.asarray, g),
                                                          device="cpu"))
        for name, a, b in zip(("E", "E_sp", "H"), got, want):
            assert a.dtype == torch.float32 and a.shape == ()
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-6, err_msg=name)
    for p in params:
        want = np.asarray(jdec.param_spread(jax.tree.map(jnp.asarray, p)))
        got = tdec.param_spread(convert.params_from_jax(jax.tree.map(np.asarray, p),
                                                        device="cpu"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert float(tdec.param_spread(convert.params_from_jax(
        jax.tree.map(np.asarray, params[1]), device="cpu"))) < float(tdec.param_spread(
        convert.params_from_jax(jax.tree.map(np.asarray, params[0]), device="cpu")))
