"""The port's npz checkpoints against the JAX reference's, both ways.

A checkpoint written by either package must restore in the other bit for
bit (bf16 leaves stored as their 16 bits under ``::bf16``), with the same
keys in the same order. The consensus of a worker-stacked checkpoint (the
paper's output model, averaged in float32 and cast back) must equal the
reference's bit for bit: both sum the M workers in order in float32 and
multiply by fl32(1/M) (what XLA makes of ``jnp.mean``'s division), and the
final cast rounds to nearest even on both sides. M = 3 here, where a true
division would differ in the last bit of a third of the float32 values.

Worker-sharded checkpoints (one npz per worker) cross between the packages
bit for bit too, and their consensus (``consensus_from_sharded``, which
divides the float32 sum by float32(M)) equals the reference's bit for bit
at M = 3 and M = 4. The asynchronous writer is held to the reference's
contract: a snapshot at ``save()``, bounded pending writes, retries of
transient IO errors and a terminal failure that surfaces on the next save.
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


def _worker_meshes(shape, names):
    """The reference's and the port's WorkerMesh on one abstract mesh."""
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.launch.mesh import WorkerMesh as JWorkerMesh
    from repro_torch.launch.mesh import AbstractMesh, WorkerMesh

    return (JWorkerMesh.from_mesh(JAbstractMesh(shape, names)),
            WorkerMesh.from_mesh(AbstractMesh(shape, names)))


def _members(path: str):
    """A file's bytes, an npz as its (member name, member bytes) list: the
    zip headers carry each write's time."""
    import zipfile

    if not path.endswith(".npz"):
        with open(path, "rb") as f:
            return f.read()
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_restore_keeps_its_values_when_the_path_is_saved_again(tmp_path, dtype):
    """Tensors restored on the CPU own their memory: saving another tree to
    the same path (a resumed run's next checkpoint) leaves them as they
    were, and the path then holds the new tree."""
    tree = {"a": torch.arange(4096).to(dtype), "b": [torch.full((3, 5), 2.0, dtype=dtype)]}
    path = os.path.join(tmp_path, "ck.npz")
    TC.save(path, tree)
    back = TC.restore(path, tree, device="cpu")
    other = _tree.map(lambda x: torch.full_like(x, -1.0), tree)
    TC.save(path, other)
    for got, want in zip(_tree.leaves(back), _tree.leaves(tree)):
        assert torch.equal(got, want)
    for got, want in zip(_tree.leaves(TC.restore(path, tree, device="cpu")),
                         _tree.leaves(other)):
        assert torch.equal(got, want)
    assert sorted(os.listdir(tmp_path)) == ["ck.npz"]


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
    """Kept under its old name: sharded checkpoints are ported now. Files
    written by either package's save_sharded restore in the other bit for
    bit (the same shard names, keys and stored arrays, bf16 tags included),
    and export_consensus of a sharded file equals the reference's."""
    from repro.configs import get_config

    params = JM.init(jax.random.PRNGKey(2), get_config("granite-3-2b", reduced=True,
                                                        param_dtype="bfloat16"))
    stacked = _stacked(params, Mw=2)
    jpath, tpath = os.path.join(tmp_path, "jax.npz"), os.path.join(tmp_path, "port")
    JC.save_sharded(jpath, stacked, step=1)
    tstacked = convert.params_from_jax(jax.tree.map(np.asarray, stacked), device="cpu")
    TC.save_sharded(tpath, tstacked, step=1)
    names = sorted(f for f in os.listdir(tmp_path) if ".shard-" in f)
    assert names == ["jax.shard-w0.npz", "jax.shard-w1.npz",
                     "port.shard-w0.npz", "port.shard-w1.npz"]
    for j in range(2):
        a, b = np.load(f"{tmp_path}/jax.shard-w{j}.npz"), np.load(f"{tmp_path}/port.shard-w{j}.npz")
        assert a.files == b.files
        for f in a.files:
            assert a[f].dtype == b[f].dtype and np.array_equal(a[f], b[f])
    like = _tree.map(torch.zeros_like, tstacked)
    for back in (TC.restore(jpath, like, device="cpu"),
                 TC.restore_sharded(jpath, like, device="cpu")):
        for t, j in zip(_tree.leaves(back), jax.tree.leaves(stacked), strict=True):
            assert _bits_equal(t, j)
    for a, b in zip(jax.tree.leaves(JC.restore(tpath, stacked)), jax.tree.leaves(stacked)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a).view(np.uint8),
                                                     np.asarray(b).view(np.uint8))
    assert TC.latest_step(tpath) == JC.latest_step(jpath[:-4]) == 1
    dst = os.path.join(tmp_path, "serve.npz")
    got = TC.export_consensus(tpath, dst, device="cpu")
    want = JC.export_consensus(jpath)
    for t, j in zip(_tree.leaves(got), jax.tree.leaves(want), strict=True):
        assert _bits_equal(t, j)
    assert TC.latest_step(dst) == 1


@pytest.mark.parametrize("Mw", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_consensus_from_sharded_matches_jax(tmp_path, Mw, dtype):
    """Shard by shard, float32 sum in shard order, true division by
    float32(M): the reference's function bit for bit, at M = 3 too, and the
    serving loader of a sharded path takes that route on both sides."""
    jcfg = jget_config("granite-3-2b", reduced=True, param_dtype=dtype)
    tcfg = tget_config("granite-3-2b", reduced=True, param_dtype=dtype)
    params = JM.init(jax.random.PRNGKey(3), jcfg)
    path = os.path.join(tmp_path, "sh.npz")
    JC.save_sharded(path, _stacked(params, Mw), step=2)
    want = jax.tree.leaves(JC.consensus_from_sharded(path, params))
    like = _tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                     convert.params_from_jax(jax.tree.map(np.asarray, params), device="cpu"))
    for got in (TC.consensus_from_sharded(path, like, device="cpu"),
                load_consensus_params(path, tcfg, device="cpu")):
        got = _tree.leaves(got)
        assert len(got) == len(want)
        for t, j in zip(got, want):
            assert _bits_equal(t, j)
    for t, j in zip(_tree.leaves(load_consensus_params(path, tcfg, device="cpu")),
                    jax.tree.leaves(jload_consensus_params(path, jcfg))):
        assert _bits_equal(t, j)


def test_sharded_save_replaces_stale_monolithic_and_one_replica_at_a_time(
        tmp_path, monkeypatch):
    path = os.path.join(tmp_path, "ck.npz")
    TC.save(path, {"w": torch.zeros(4, 3)}, step=1)
    seen = []
    real_write = TC._write_npz

    def spy(p, arrs):
        seen.append(sum(a.nbytes for a in arrs.values()))
        real_write(p, arrs)

    monkeypatch.setattr(TC, "_write_npz", spy)
    new = {"w": torch.ones(4, 3), "b": torch.arange(8, dtype=torch.bfloat16).reshape(4, 2)}
    TC.save_sharded(path, new)                       # same base, no step
    assert not os.path.exists(path)                  # the stale monolithic file is gone
    assert seen == [3 * 4 + 2 * 2] * 4               # one worker's slice per file
    back = TC.restore(path, new, device="cpu")
    assert all(torch.equal(back[k], new[k]) for k in new)
    assert TC.latest_step(path[:-len(".npz")]) is None
    with pytest.raises(ValueError, match="stacked"):
        TC.save_sharded(path, {"a": torch.ones(4, 2), "b": torch.ones(3)})
    # a mesh hosting 2 workers refuses a tree of 4 with the reference's error
    (jwm, twm) = _worker_meshes((2, 2), ("data", "model"))
    with pytest.raises(ValueError) as want:
        JC.worker_coords(jwm, 4)
    with pytest.raises(ValueError, match="mesh hosts 2 workers, tree is stacked over 4") as got:
        TC.worker_coords(twm, 4)
    assert str(got.value) == str(want.value)
    with pytest.raises(FileNotFoundError):
        TC.restore_sharded(os.path.join(tmp_path, "none"), new, device="cpu")


# ---------------------------------------------------------------------------
# The asynchronous writer (mirrors tests/test_checkpoint.py's)
# ---------------------------------------------------------------------------


def test_async_writer_roundtrip_and_sharded_path(tmp_path):
    tree = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": torch.ones(3, 5, dtype=torch.bfloat16)}
    path, spath = os.path.join(tmp_path, "async.npz"), os.path.join(tmp_path, "sh.npz")
    with TC.AsyncCheckpointWriter() as w:
        w.save(path, tree, step=3)
        w.save(spath, tree, step=4, sharded=True)
        w.wait()
        assert len(w.write_seconds) == 2 and min(w.write_seconds) >= 0
    for p in (path, spath):
        back = TC.restore(p, tree, device="cpu")
        assert all(torch.equal(back[k], tree[k]) for k in tree)
    assert TC.latest_step(path) == 3 and TC.latest_step(spath[:-4]) == 4
    assert not os.path.exists(spath)
    # a save with an (abstract) WorkerMesh is sharded and keyed by its
    # coordinates, as the reference's writer does with the same mesh
    jwm, twm = _worker_meshes((3, 1), ("data", "model"))
    tdir, jdir = os.path.join(tmp_path, "t"), os.path.join(tmp_path, "j")
    with TC.AsyncCheckpointWriter() as w:
        w.save(os.path.join(tdir, "m.npz"), tree, step=5, wmesh=twm)
    with JC.AsyncCheckpointWriter() as w:
        w.save(os.path.join(jdir, "m.npz"), convert.params_to_numpy(tree), step=5, wmesh=jwm)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir)) == [
        "m.meta.json", "m.shard-data0.npz", "m.shard-data1.npz", "m.shard-data2.npz"]
    for name in sorted(os.listdir(tdir)):
        assert _members(os.path.join(tdir, name)) == _members(os.path.join(jdir, name))


def test_async_writer_propagates_write_errors(tmp_path):
    w = TC.AsyncCheckpointWriter()
    w.save(os.path.join(tmp_path, "no", "such", "dir") + "\0bad", {"x": torch.ones(2)})
    with pytest.raises(Exception):
        w.wait()
    w.close()


def test_in_flight_save_holds_the_snapshot(tmp_path, monkeypatch):
    """save() returns before the write, and the params changed in place
    afterwards do not reach the file: it holds the values at save()."""
    import threading

    gate = threading.Event()
    real_write = TC._write_npz

    def gated_write(p, arrs):
        assert gate.wait(timeout=60), "test gate never released"
        real_write(p, arrs)

    monkeypatch.setattr(TC, "_write_npz", gated_write)
    params = {"w": torch.zeros(64, 33)}
    path = os.path.join(tmp_path, "inflight.npz")
    with TC.AsyncCheckpointWriter() as w:
        w.save(path, params, step=0)
        assert not gate.is_set()
        for _ in range(5):
            params["w"].add_(1.0)
        gate.set()
        w.wait()
    back = TC.restore(path, {"w": torch.empty(64, 33)}, device="cpu")
    assert torch.equal(back["w"], torch.zeros(64, 33))
    assert torch.equal(params["w"], torch.full((64, 33), 5.0))


def test_async_writer_bounds_pending_saves(tmp_path, monkeypatch):
    """A third save waits on the oldest write (max_pending=2); the files are
    written in order."""
    import threading

    gate = threading.Event()
    real_write = TC._write_npz
    written = []

    def gated_write(p, arrs):
        assert gate.wait(timeout=60)
        written.append(os.path.basename(p))
        real_write(p, arrs)

    monkeypatch.setattr(TC, "_write_npz", gated_write)
    tree = {"x": torch.ones(8)}
    w = TC.AsyncCheckpointWriter(max_pending=2)
    w.save(os.path.join(tmp_path, "a.npz"), tree)
    w.save(os.path.join(tmp_path, "b.npz"), tree)
    release = threading.Timer(0.2, gate.set)
    release.start()
    w.save(os.path.join(tmp_path, "c.npz"), tree)
    assert gate.is_set()                        # save() had to drain
    w.close()
    assert written == ["a.npz", "b.npz", "c.npz"]


def test_async_writer_retries_transient_io_errors(tmp_path, monkeypatch):
    real_write = TC._write_npz
    fails = {"n": 2}
    calls = []

    def flaky_write(p, arrs):
        calls.append(os.path.basename(p))
        if fails["n"] > 0:
            fails["n"] -= 1
            raise OSError("transient NFS hiccup")
        real_write(p, arrs)

    monkeypatch.setattr(TC, "_write_npz", flaky_write)
    tree = {"x": torch.arange(6, dtype=torch.float32)}
    path = os.path.join(tmp_path, "flaky.npz")
    with TC.AsyncCheckpointWriter(io_retries=3, io_backoff=0.001) as w:
        w.save(path, tree, step=4)
        w.wait()
    assert torch.equal(TC.restore(path, tree, device="cpu")["x"], tree["x"])
    assert len(calls) == 3                      # 2 failures + 1 success
    assert TC.latest_step(path) == 4


def test_async_writer_terminal_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    def broken_write(p, arrs):
        raise OSError("disk gone")

    monkeypatch.setattr(TC, "_write_npz", broken_write)
    tree = {"x": torch.ones(3)}
    w = TC.AsyncCheckpointWriter(io_retries=2, io_backoff=0.001)
    w.save(os.path.join(tmp_path, "dead.npz"), tree)
    with pytest.raises(OSError, match="disk gone"):
        w.wait()
    with pytest.raises(RuntimeError, match="terminally"):
        w.save(os.path.join(tmp_path, "next.npz"), tree)
    w.close()


def test_train_writer_error_does_not_mask_the_loop_error(tmp_path, monkeypatch):
    """A failing loop raises its own exception even when every checkpoint
    write fails too; a loop that ends well raises the writer's error."""
    from repro_torch.core import topology as TT
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.optim import sgd
    from repro_torch.train import train

    def broken_write(p, arrs):
        raise OSError("disk gone")

    monkeypatch.setattr(TC, "_write_npz", broken_write)
    loss = lambda p, b: torch.mean((b @ p["w"]) ** 2)
    p0 = {"w": torch.ones(4, 3)}
    kw = dict(gossip=GossipSpec(topology=TT.undirected_ring(4), backend="einsum"),
              device="cpu", verbose=False, ckpt_path=os.path.join(tmp_path, "ck"),
              ckpt_every=1)

    def batches(n):
        for _ in range(n):
            yield torch.ones(4, 2, 3)
        raise KeyError("the loop's own failure")

    with pytest.raises(KeyError, match="own failure"):
        train(loss, p0, sgd(0.1), batches(2), steps=4, **kw)
    # the first write's OSError, or the terminal failure it leaves behind
    with pytest.raises((OSError, RuntimeError), match="disk gone"):
        train(loss, p0, sgd(0.1), batches(2), steps=2, **kw)
