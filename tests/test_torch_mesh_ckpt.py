"""Mesh checkpoints, the simulator's mesh mirror and the retired fsdp mode
against the JAX reference, in one process on abstract meshes.

``worker_coords`` must give the reference's shard keys on the (4, 2),
(2, 2, 2) and (16, 16) meshes; shard files written with a WorkerMesh by
either package restore in the other bit for bit (and the files' npz members
are equal byte for byte); ``MeshSpec.ensure`` mirrors a WorkerMesh field by
field as the reference's does, with and without ``param_specs``;
``run_simulated(mesh=WorkerMesh)`` gives the reference's event schedule,
``Trace.link_accounting`` and mesh meta; ``mode='fsdp'`` raises the
reference's message. Live meshes run in ``tests/test_torch_train_mesh.py``.
"""
import os
import sys
import zipfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core.decentralized import make_train_step as j_make_train_step  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.launch.mesh import WorkerMesh as JWorkerMesh  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.sim.scenarios import MeshSpec as JMeshSpec  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.core.decentralized import make_train_step  # noqa: E402
from repro_torch.launch import shardings as TS  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, WorkerMesh  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.sim.scenarios import MeshSpec  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_sim as sim_tests  # noqa: E402

MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model"))]
MESH_IDS = ["4x2", "2x2x2", "16x16"]


def _worker_meshes(shape, names):
    return (JWorkerMesh.from_mesh(JAbstractMesh(shape, names)),
            WorkerMesh.from_mesh(AbstractMesh(shape, names)))


def _members(path: str):
    """An npz's (member, bytes) list; the zip headers carry each write's time."""
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_worker_coords_equal_the_reference(shape, names):
    jwm, twm = _worker_meshes(shape, names)
    M = twm.n_workers
    assert TC.worker_coords(twm, M) == JC.worker_coords(jwm, M)
    assert TC.worker_coords(None, M) == JC.worker_coords(None, M)
    for wrong in (M // 2, 2 * M):
        with pytest.raises(ValueError) as want:
            JC.worker_coords(jwm, wrong)
        with pytest.raises(ValueError, match="mesh hosts") as got:
            TC.worker_coords(twm, wrong)
        assert str(got.value) == str(want.value)


def _stacked_tree(M: int):
    """A worker-stacked tree of float32, bf16 and int leaves, from a seed."""
    rng = np.random.default_rng(5)
    return {"emb": jnp.asarray(rng.normal(size=(M, 12, 5)), jnp.bfloat16),
            "layers": [{"w": jnp.asarray(rng.normal(size=(M, 4, 3)), jnp.float32)}
                       for _ in range(11)],
            "n": jnp.asarray(rng.integers(0, 9, size=(M, 2)), jnp.int32)}


@pytest.mark.parametrize("shape,names", MESHES[:2], ids=MESH_IDS[:2])
@pytest.mark.parametrize("writer", ["port", "reference"])
def test_mesh_shard_files_cross_the_packages(tmp_path, shape, names, writer):
    """Shards keyed by the WorkerMesh coordinates: written by one package,
    restored by the other bit for bit; the files' members are the same
    bytes whichever package wrote them."""
    jwm, twm = _worker_meshes(shape, names)
    jtree = _stacked_tree(twm.n_workers)
    ttree = convert.params_from_jax(jax.tree.map(np.asarray, jtree), device="cpu")
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    TC.save_sharded(str(tdir / "ck.npz"), ttree, step=3, wmesh=twm)
    JC.save_sharded(str(jdir / "ck.npz"), jtree, step=3, wmesh=jwm)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for f in os.listdir(tdir):
        if f.endswith(".npz"):
            assert _members(str(tdir / f)) == _members(str(jdir / f)), f
    src = str((tdir if writer == "port" else jdir) / "ck.npz")
    like = _tree.map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), ttree)
    got_t = TC.restore(src, like, device="cpu")
    got_j = JC.restore(src, jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                                         jtree))
    for a, b, c in zip(_tree.leaves(got_t), jax.tree.leaves(got_j), _tree.leaves(ttree)):
        assert torch.equal(a, c)
        assert np.array_equal(convert.params_to_numpy(a).view(np.uint8),
                              np.asarray(b).view(np.uint8))


def _template(cfg, lib):
    if lib == "jax":
        return jax.tree.map(lambda d: jax.ShapeDtypeStruct(d.shape, jnp.bfloat16),
                            JM.model_defs(cfg))
    return _tree.map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"),
                     TM.model_defs(cfg))


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("with_specs", [False, True])
def test_mesh_spec_ensure_mirrors_a_worker_mesh_as_the_reference(shape, names, with_specs):
    jwm, twm = _worker_meshes(shape, names)
    jcfg = jget_config("granite-3-2b", reduced=True)
    tcfg = tget_config("granite-3-2b", reduced=True)
    kw_j = dict(params_template=_template(jcfg, "jax"))
    kw_t = dict(params_template=_template(tcfg, "torch"))
    if with_specs:
        strip = lambda sp: sp[1:]      # per-worker specs: no leading worker dim
        kw_j["param_specs"] = jax.tree.map(lambda s: type(s)(*strip(s)),
                                           JS.param_pspecs(jcfg, jwm, "gossip"),
                                           is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        kw_t["param_specs"] = _tree.map(lambda s: type(s)(*strip(s)),
                                        TS.param_pspecs(tcfg, twm, "gossip"))
    want = JMeshSpec.ensure(jwm, None, **kw_j)
    got = MeshSpec.ensure(twm, None, **kw_t)
    assert got.payload_bytes > 0
    for field in ("group_of", "payload_bytes", "dci_payload_bytes", "name"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.describe() == want.describe()


@pytest.mark.parametrize("dci_dtype", [None, "int8"])
def test_run_simulated_on_a_worker_mesh_matches_the_reference(dci_dtype):
    """The hier protocol on a (pod, data, model) = (2, 2, 2) WorkerMesh:
    the reference's event schedule, link accounting and mesh meta; each
    link class's bytes are its messages times the mesh's payload."""
    jt, tt = sim_tests._topos("hier", 2, 2)
    jwm, twm = _worker_meshes((2, 2, 2), ("pod", "data", "model"))
    js = sim_tests.jscen.Scenario(
        name="dci", link_classes=sim_tests.jscen.two_class_links(dci_latency=1.5, dci_bw=1e3))
    ts = sim_tests.scenarios.Scenario(
        name="dci", link_classes=sim_tests.scenarios.two_class_links(dci_latency=1.5,
                                                                     dci_bw=1e3))
    j = sim_tests._ref(jt, "hier", rounds=6, scenario=js, mesh=jwm, dci_dtype=dci_dtype)
    t = sim_tests._port(tt, "hier", rounds=6, scenario=ts, mesh=twm, dci_dtype=dci_dtype)
    sim_tests._assert_same_run(j, t)
    assert t.trace.link_accounting() == j.trace.link_accounting()
    assert t.trace.meta["mesh"] == j.trace.meta["mesh"]
    spec = twm.sim_spec(params_template={"w": torch.empty(8, device="meta")},
                        dci_dtype=dci_dtype)
    acct = t.trace.link_accounting()
    assert acct["dci"]["messages"] > 0 and acct["ici"]["messages"] > 0
    for cls in ("ici", "dci"):
        assert acct[cls]["bytes"] == acct[cls]["messages"] * spec.payload_for(cls)


def test_fsdp_mode_is_retired_as_in_the_reference():
    opt = toptim.sgd(0.1)
    with pytest.raises(ValueError) as want:
        j_make_train_step(lambda p, b: 0.0, None, mode="fsdp")
    with pytest.raises(ValueError, match="retired") as got:
        make_train_step(lambda p, b: torch.zeros(()), opt, mode="fsdp")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="unknown mode"):
        make_train_step(lambda p, b: torch.zeros(()), opt, mode="sharded")
