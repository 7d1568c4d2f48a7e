"""The port's npz checkpoints against the JAX reference's, both ways.

A checkpoint written by either package must restore in the other bit for
bit (bf16 leaves stored as their 16 bits under ``::bf16``), with the same
keys in the same order. The consensus of a worker-stacked checkpoint (the
paper's output model, averaged in float32 and cast back) must equal the
reference's bit for bit: both sum the M workers in order in float32 and
multiply by fl32(1/M) (what XLA makes of ``jnp.mean``'s division), and the
final cast rounds to nearest even on both sides. M = 3 here, where a true
division would differ in the last bit of a third of the float32 values.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.engine import load_consensus_params as jload_consensus_params  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.serving import load_consensus_params  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402


def _bits_equal(t: torch.Tensor, j) -> bool:
    """Same dtype, shape and bits (the port's tensor against a JAX array)."""
    want = np.asarray(j)
    got = convert.params_to_numpy(t.detach().cpu())
    return (got.dtype == want.dtype and got.shape == want.shape
            and np.array_equal(got.view(np.uint8), want.view(np.uint8)))


def _mixed_tree():
    """f32, bf16 (incl. subnormal, huge, ±0) and int leaves, dicts and lists."""
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.normal(size=500), [1e-40, -3e38, 0.0, -0.0]])
    return {
        "emb": jnp.asarray(vals, jnp.bfloat16).reshape(24, 21),
        "layers": [{"w": jnp.asarray(rng.normal(size=(8, 4)), jnp.float32),
                    "b": jnp.asarray(rng.normal(size=(4,)), jnp.bfloat16)}
                   for _ in range(11)],                     # index 10 sorts before 2
        "steps": jnp.arange(6, dtype=jnp.int32),
    }


def _stacked(params, Mw=3):
    """Worker-stacked copies w_j = (j + 1)·w plus a per-worker wobble, so
    the float32 mean has real rounding to do."""
    def stack(x):
        scale = jnp.arange(1, Mw + 1, dtype=jnp.float32).reshape((Mw,) + (1,) * x.ndim)
        wob = jnp.asarray(np.random.default_rng(x.size).normal(size=(Mw,) + x.shape), jnp.float32)
        return (x.astype(jnp.float32)[None] * scale + 1e-3 * wob).astype(x.dtype)
    return jax.tree.map(stack, params)


def test_jax_checkpoint_restores_bit_equal_in_the_port(tmp_path):
    tree = _mixed_tree()
    path = os.path.join(tmp_path, "jax.npz")
    JC.save(path, tree, step=7)
    like = convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu")
    back = TC.restore(path, _tree.map(torch.zeros_like, like), device="cpu")
    pairs = list(zip(_tree.flatten_with_path(back), jax.tree_util.tree_flatten_with_path(tree)[0]))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for (tp, t), (jp, j) in pairs:
        assert TC._path_key(tp) == JC._path_key(jp)
        assert _bits_equal(t, j), TC._path_key(tp)
    assert TC.latest_step(path) == 7


def test_port_checkpoint_restores_bit_equal_in_jax(tmp_path):
    tree = _mixed_tree()
    tpath, jpath = os.path.join(tmp_path, "port.npz"), os.path.join(tmp_path, "jax.npz")
    TC.save(tpath, convert.params_from_jax(jax.tree.map(np.asarray, tree), device="cpu"),
            step=3)
    JC.save(jpath, tree, step=3)
    back = JC.restore(tpath, tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8),
                                                     np.asarray(b).view(np.uint8))
    # the same file: keys in the same (JAX leaf) order, the same stored arrays
    tdata, jdata = np.load(tpath), np.load(jpath)
    assert tdata.files == jdata.files
    for f in jdata.files:
        assert tdata[f].dtype == jdata[f].dtype and np.array_equal(tdata[f], jdata[f])
    assert JC.latest_step(tpath) == 3


def test_restore_casts_and_rejects_other_trees(tmp_path):
    path = os.path.join(tmp_path, "ck.npz")
    TC.save(path, {"a": torch.ones(3, dtype=torch.bfloat16), "b": [torch.zeros(2)]})
    back = TC.restore(path, {"a": torch.empty(3), "b": [torch.empty(2, dtype=torch.bfloat16)]},
                      device="cpu")
    assert back["a"].dtype == torch.float32 and torch.equal(back["a"], torch.ones(3))
    assert back["b"][0].dtype == torch.bfloat16
    with pytest.raises(ValueError, match="differ"):
        TC.restore(path, {"a": torch.empty(3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        TC.restore(path, {"a": torch.empty(4), "b": [torch.empty(2)]}, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_export_and_load_match_jax(tmp_path, dtype):
    """A worker-stacked checkpoint of reduced granite: the port's
    load_consensus_params (stacked file), export_consensus (from the path
    and in memory) and the loader of the exported file all equal the
    reference's consensus bit for bit."""
    jcfg = jget_config("granite-3-2b", reduced=True, param_dtype=dtype)
    tcfg = tget_config("granite-3-2b", reduced=True, param_dtype=dtype)
    stacked = _stacked(JM.init(jax.random.PRNGKey(0), jcfg))
    src = os.path.join(tmp_path, "gossip.npz")
    JC.save(src, stacked, step=11)
    want = jax.tree.leaves(jload_consensus_params(src, jcfg))

    def check(tree):
        got = _tree.leaves(tree)
        assert len(got) == len(want)
        for t, j in zip(got, want):
            assert _bits_equal(t, j)

    check(load_consensus_params(src, tcfg, device="cpu"))
    dst = os.path.join(tmp_path, "serve.npz")
    mean = TC.export_consensus(src, dst, device="cpu")
    assert TC.latest_step(dst) == 11
    check(load_consensus_params(dst, tcfg, device="cpu"))
    jdst = os.path.join(tmp_path, "jserve.npz")
    JC.export_consensus(src, jdst)
    assert sorted(np.load(dst).files) == sorted(np.load(jdst).files)
    check(load_consensus_params(jdst, tcfg, device="cpu"))
    for a, b in zip(jax.tree.leaves(jload_consensus_params(dst, jcfg)), want):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8),
                                                     np.asarray(b).view(np.uint8))
    in_memory = convert.params_from_jax(jax.tree.map(np.asarray, stacked), device="cpu")
    check(TC.consensus_params(in_memory))
    assert [t.shape for t in _tree.leaves(mean)] == [t.shape for t in want]


def test_load_consensus_params_dtype_override(tmp_path):
    tcfg = tget_config("granite-3-2b", reduced=True)
    jcfg = jget_config("granite-3-2b", reduced=True)
    path = os.path.join(tmp_path, "flat.npz")
    JC.save(path, JM.init(jax.random.PRNGKey(1), jcfg))
    got = load_consensus_params(path, tcfg, dtype=torch.bfloat16, device="cpu")
    want = jload_consensus_params(path, jcfg, dtype=jnp.bfloat16)
    for t, j in zip(_tree.leaves(got), jax.tree.leaves(want)):
        assert _bits_equal(t, j)
    cfg16 = dataclasses.replace(tcfg, param_dtype="bfloat16")
    assert _tree.leaves(load_consensus_params(path, cfg16, device="cpu"))[0].dtype == torch.bfloat16


def test_sharded_checkpoints_are_not_ported_yet(tmp_path):
    from repro.configs import get_config

    params = JM.init(jax.random.PRNGKey(2), get_config("granite-3-2b", reduced=True))
    stacked = jax.tree.map(lambda x: jnp.stack([x, x]), params)
    path = os.path.join(tmp_path, "sharded.npz")
    JC.save_sharded(path, stacked, step=1)
    with pytest.raises(NotImplementedError, match="sharded"):
        TC.export_consensus(path, device="cpu")
