"""The port's worker mesh and sharding rules against the JAX reference.

Every spec function of ``launch/shardings.py`` (``param_pspecs`` in each
mode, ``bus_row_split_flags``, ``state_pspecs``, ``batch_pspecs``,
``cache_pspecs``, ``cross_kv_pspecs``) must equal the reference's spec for
spec, for all ten configs at their published sizes, on abstract meshes of
(4, 2), (2, 2, 2) and the production (16, 16); the reference runs on
``jax.sharding.AbstractMesh``, the port on its own ``AbstractMesh``.
``WorkerMesh``'s methods, ``sim_payload_bytes`` and ``sim_spec`` included,
must equal the reference's exactly (they are integer arithmetic). Live
meshes run in ``tests/test_torch_bus_sharded.py``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh as JAbstractMesh  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import mesh as JLM  # noqa: E402
from repro.launch import shardings as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import params as JPa  # noqa: E402
from repro.serving import kvcache as JKV  # noqa: E402
from repro_torch import _tree  # noqa: E402
from repro_torch.configs import ARCH_NAMES  # noqa: E402
from repro_torch.configs import get_config as tget_config  # noqa: E402
from repro_torch.launch import mesh as TLM  # noqa: E402
from repro_torch.launch import shardings as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import params as TPa  # noqa: E402
from repro_torch.serving import kvcache as TKV  # noqa: E402

MESHES = [((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((16, 16), ("data", "model"))]
MESH_IDS = ["4x2", "2x2x2", "16x16"]


def _meshes(shape, names):
    return JAbstractMesh(shape, names), TLM.AbstractMesh(shape, names)


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def _same_specs(jtree, ttree):
    jl, tl = _jleaves(jtree), _tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if isinstance(a, JP):
            assert isinstance(b, TPa.PartitionSpec) and tuple(b) == tuple(a), (a, b)
        else:
            assert a == b, (a, b)


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_every_spec_of_every_config_equals_the_reference(shape, names):
    jmesh, tmesh = _meshes(shape, names)
    for name in ARCH_NAMES:
        jcfg, tcfg = jget_config(name), tget_config(name)
        for mode in ("gossip", "allreduce", "fsdp"):
            _same_specs(JS.param_pspecs(jcfg, jmesh, mode), TS.param_pspecs(tcfg, tmesh, mode))
        jps = JS.param_pspecs(jcfg, jmesh, "gossip", worker_internal="dp")
        _same_specs(jps, TS.param_pspecs(tcfg, tmesh, "gossip", worker_internal="dp"))
        jps, tps = JS.param_pspecs(jcfg, jmesh), TS.param_pspecs(tcfg, tmesh)
        _same_specs(JS.bus_row_split_flags(jps, jmesh), TS.bus_row_split_flags(tps, tmesh))
        for jopt, topt in (((), ()), ({"m": 0, "v": 0}, {"m": 0, "v": 0}), (jps, tps)):
            _same_specs(JS.state_pspecs(jcfg, jmesh, jopt, jps),
                        TS.state_pspecs(tcfg, tmesh, topt, tps))
        for kind in ("train", "serve"):
            for mode in ("gossip", "allreduce"):
                for wi in ("tp", "dp"):
                    _same_specs(JS.batch_pspecs(jcfg, jmesh, kind, mode, wi),
                                TS.batch_pspecs(tcfg, tmesh, kind, mode, wi))
        for batch in (1, 8, 32):
            _same_specs(JS.cache_pspecs(jcfg, jmesh, batch), TS.cache_pspecs(tcfg, tmesh, batch))
            if tcfg.encoder_layers:
                _same_specs(JS.cross_kv_pspecs(jcfg, jmesh, batch),
                            TS.cross_kv_pspecs(tcfg, tmesh, batch))


@pytest.mark.parametrize("shape,names", MESHES + [((2, 4), ("data", "model"))],
                         ids=MESH_IDS + ["2x4"])
def test_serving_cache_specs_equal_the_reference(shape, names):
    """paged_cache_pspecs (the continuous batcher's pools) and cache_pspecs
    (the wave caches, which serving on a mesh cuts) equal the reference's,
    spec for spec, for every config, published and reduced."""
    jmesh, tmesh = _meshes(shape, names)
    for name in ARCH_NAMES:
        for reduced in (False, True):
            jcfg, tcfg = jget_config(name, reduced=reduced), tget_config(name, reduced=reduced)
            _same_specs(JKV.paged_cache_pspecs(jcfg, jmesh), TKV.paged_cache_pspecs(tcfg, tmesh))
            _same_specs(JS.cache_pspecs(jcfg, jmesh, 4), TS.cache_pspecs(tcfg, tmesh, 4))


def test_rules_and_spec_helpers_equal_the_reference():
    assert TPa.DEFAULT_RULES == JPa.DEFAULT_RULES
    sizes = {"data": 4, "model": 8}
    for shape, axes in [((64, 12), ("embed", "q_heads")), ((16, 3), ("kv_heads", None)),
                        ((4, 8, 32), ("layers", "experts", "ff"))]:
        jd, td = JPa.ParamDef(shape, axes), TPa.ParamDef(shape, axes)
        for prefix in ((), ("data",), (("pod", "data"),)):
            assert tuple(TPa.resolve_spec(td, TPa.DEFAULT_RULES, sizes, prefix)) == \
                tuple(JPa.resolve_spec(jd, JPa.DEFAULT_RULES, sizes, prefix))
    cfg = tget_config("granite-3-2b", n_layers=2)
    abstract = TPa.abstract_tree(TM.model_defs(cfg), torch.bfloat16)
    jabstract = JPa.abstract_tree(JM.model_defs(jget_config("granite-3-2b", n_layers=2)),
                                  jnp.bfloat16)
    for a, b in zip(_tree.leaves(abstract), jax.tree.leaves(jabstract)):
        assert a.device.type == "meta" and a.dtype == torch.bfloat16
        assert tuple(a.shape) == b.shape
    p = TPa.PartitionSpec("data", None)
    assert p == ("data", None) and p != ("data",) and len(p) == 2 and p[0] == "data"
    assert _tree.leaves({"a": p}) == [p]          # a leaf, not a tuple node


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
def test_worker_mesh_methods_equal_the_reference(shape, names):
    jmesh, tmesh = _meshes(shape, names)
    jw, tw = JLM.WorkerMesh.from_mesh(jmesh), TLM.WorkerMesh.from_mesh(tmesh)
    assert tw.worker_axes == jw.worker_axes and tw.model_axis == jw.model_axis
    assert (tw.n_workers, tw.model_factor, tw.wa) == (jw.n_workers, jw.model_factor, jw.wa)
    assert tw.describe() == jw.describe() and tw.shape == dict(jw.shape)
    assert tuple(tw.worker_spec(None, "model")) == tuple(jw.worker_spec(None, "model"))
    for dt in ("float32", "bfloat16", "int8"):
        assert tw.bus_row_tile(dt) == jw.bus_row_tile(dt)
    assert TLM.WorkerMesh.ensure(tw) is tw and TLM.WorkerMesh.ensure(None) is None
    assert TLM.WorkerMesh.ensure(tmesh) == tw and TLM.WorkerMesh.raw(tw) is tmesh
    assert TLM.worker_axes(tmesh) == JLM.worker_axes(jmesh)
    assert TLM.n_workers(tmesh) == JLM.n_workers(jmesh)
    flat = TLM.WorkerMesh.from_mesh(tmesh, model_axis=None)
    assert flat.model_factor == 1 and flat.worker_axes == names
    with pytest.raises(ValueError, match="abstract"):
        tw.coordinate


@pytest.mark.parametrize("shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("name", ["granite-3-2b", "mixtral-8x7b", "seamless-m4t-large-v2"])
def test_sim_payload_bytes_and_sim_spec_equal_the_reference(name, shape, names):
    jmesh, tmesh = _meshes(shape, names)
    jw, tw = JLM.WorkerMesh.from_mesh(jmesh), TLM.WorkerMesh.from_mesh(tmesh)
    jcfg, tcfg = jget_config(name), tget_config(name)
    jt = JPa.abstract_tree(JM.model_defs(jcfg), jnp.float32)
    tt = TPa.abstract_tree(TM.model_defs(tcfg), torch.float32)
    jspecs, tspecs = JS.param_pspecs(jcfg, jmesh), TS.param_pspecs(tcfg, tmesh)
    for specs in ((None, None), (jspecs, tspecs)):
        for wire in (None, "bfloat16", "int8"):
            assert tw.sim_payload_bytes(tt, specs[1], wire_dtype=wire) == \
                jw.sim_payload_bytes(jt, specs[0], wire_dtype=wire)
    js = jw.sim_spec(params_template=jt, param_specs=jspecs, dci_dtype="int8")
    ts = tw.sim_spec(params_template=tt, param_specs=tspecs, dci_dtype="int8")
    assert (ts.group_of, ts.payload_bytes, ts.dci_payload_bytes, ts.name) == \
        (js.group_of, js.payload_bytes, js.dci_payload_bytes, js.name)


def test_production_meshes_are_abstract_with_the_reference_shapes():
    for multi in (False, True):
        tm = TLM.make_production_mesh(multi_pod=multi)
        want = (JLM.MULTI_POD, ("pod", "data", "model")) if multi else \
            (JLM.SINGLE_POD, ("data", "model"))
        assert (tm.axis_sizes, tm.axis_names) == want
        wm = TLM.make_worker_mesh(multi_pod=multi)
        assert not wm.live and wm.model_factor == 16
        assert wm.n_workers == (32 if multi else 16)


def test_local_tree_cuts_every_rank_and_reassembles():
    """``local_tree`` on a (2, 2, 2) mesh: each coordinate's piece is the
    reference's ``NamedSharding`` slice (the worker dim over pod × data, pod
    major; other dims over their axes); the pieces tile the array."""
    tmesh = TLM.AbstractMesh((2, 2, 2), ("pod", "data", "model"))
    P = TPa.PartitionSpec
    x = torch.arange(4 * 6 * 4, dtype=torch.float32).reshape(4, 6, 4)
    specs = {"a": P(("pod", "data"), None, "model"), "b": P(("pod", "data"))}
    tree = {"a": x, "b": torch.arange(4 * 3).reshape(4, 3)}
    seen = torch.zeros_like(x)
    for pod in range(2):
        for data in range(2):
            for model in range(2):
                loc = TS.local_tree(tree, specs, tmesh,
                                    coordinate={"pod": pod, "data": data, "model": model})
                w = pod * 2 + data
                assert torch.equal(loc["a"], x[w:w + 1, :, 2 * model:2 * model + 2])
                assert torch.equal(loc["b"], tree["b"][w:w + 1])
                seen[w:w + 1, :, 2 * model:2 * model + 2] += loc["a"]
    assert torch.equal(seen, x)
    with pytest.raises(ValueError, match="split"):
        TS.local_tree({"a": torch.ones(3, 2)}, {"a": P("data")},
                      TLM.AbstractMesh((2, 2), ("data", "model")),
                      coordinate={"data": 0, "model": 0})


def test_state_specs_mirror_the_optimizer_state():
    tmesh = TLM.AbstractMesh((4, 2), ("data", "model"))
    cfg = tget_config("granite-3-2b", reduced=True)
    specs = TS.param_pspecs(cfg, tmesh)
    st = TS.state_pspecs(cfg, tmesh, joptim.adam(1e-3).init({"x": np.zeros(2)}), specs)
    assert st.step == TPa.PartitionSpec() and st.opt_state["m"] is specs


@pytest.mark.parametrize("dispatch, shape, refuses", [
    ("global", (4, 1), True), ("global", (1, 1), False), ("per_sequence", (4, 1), False)],
    ids=["global-4-ranks", "global-1-rank", "per-sequence-4-ranks"])
def test_a_globally_routed_moe_refuses_rows_cut_over_ranks(dispatch, shape, refuses):
    """Inside ``rows_cut_over`` an abstract mesh of several ranks, an MoE
    layer routing the whole call refuses: routing the whole call over the
    ranks' rows takes collectives over the worker groups, which only a live
    mesh has (``tests/test_torch_train_tp_moe.py`` trains it on one); one
    rank, or routing per sequence, computes the loss as without the
    context."""
    cfg = tget_config("mixtral-8x7b", reduced=True, n_layers=1, d_model=32, n_heads=2,
                      n_kv_heads=1, head_dim=16, d_ff_expert=32, vocab_size=64,
                      moe_dispatch=dispatch)
    params = TM.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = {"tokens": torch.from_numpy(np.random.default_rng(0).integers(0, 64, (2, 9)))}
    wm = TLM.WorkerMesh.from_mesh(TLM.AbstractMesh(shape, ("data", "model")))
    want = TM.loss_fn(params, cfg, batch)
    with TLM.rows_cut_over(wm):
        if refuses:
            with pytest.raises(ValueError,
                               match=r"moe_dispatch='global'.*needs a live mesh"):
                TM.loss_fn(params, cfg, batch)
        else:
            assert torch.equal(TM.loss_fn(params, cfg, batch), want)
    assert torch.equal(TM.loss_fn(params, cfg, batch), want)     # the context is left
