"""Tensor-parallel training over the model axis of live gloo meshes on the CPU.

One launch of 8 ranks for the whole file (a ``FileStore`` in a temporary
directory): this file, run as a script, is one rank. Meshes, each over all
8 ranks: (data=4, model=2), (data=2, model=4) and (pod=2, data=2,
model=2), M = 4 workers (one or two per worker group). A rank holds its
1/k shard of every leaf ``launch.shardings.param_pspecs`` shards over
``'model'`` and its workers' whole batches; the dense decoders' layers run
tensor parallel (``launch.tensor_parallel``). Models at 2 layers and
narrow widths, float32, different random weights per worker from a numpy
seed: granite-3-2b with vocab 256 (sharded) and 257 (replicated), and
with ``remat``; gemma-2b (MQA, GeGLU, scaled and tied embeddings);
deepseek-7b (MHA); chameleon-34b (qk-norm); nemotron-4-340b (squared
ReLU). At model factor 4 the 2 kv heads of granite, chameleon and
nemotron, and gemma's one at any k, stay replicated while the q heads
shard.

Step cases (``make_train_step(mesh=, param_specs=)``, two steps each): the
fused bus, ``ppermute`` and ``allreduce`` backends, ``mix_first=False``,
``microbatch=2``, ``adafactor_like`` and ``mode='allreduce'``. Loop cases
(``train(mesh=, param_specs=)`` on (4, 2)): sharded checkpoints through
the asynchronous writer, a monolithic one streamed to the first rank, and
allreduce mode; and a synchronous ``save_sharded``.

Oracles. The row-parallel sums (the output projections, the MLP's down
projection, the vocab-parallel softmax's Σexp, the embedding's rows, and
the gradients of every replicated input of a sharded product) add the
model ranks' partial sums in another order than one device does, so
nothing here is bit for bit:

* the port's meshless step (and ``train()``) on the global tree, run with
  one intra-op thread, cut to each rank by ``launch.shardings.local_tree``:
  ``tests/test_bus.py``'s rtol 1e-5 / atol 1e-6; ``StepMetrics`` within
  rtol 1e-6 (a sharded leaf's squares summed over the model group, a
  replicated leaf counted once). ``adafactor_like`` divides each element
  by its row and column statistics, which carries the float32 rounding of
  one summation order to ~1e-6 of the update itself (its meshless float32
  run is 2.4e-6 from a float64 run at this size): there a rank's params
  at their largest distance from the meshless float64 step must be within
  twice the meshless float32 step's largest distance over the same
  leaves, the rule ``chip_smoke.py`` applies to alternative routes;
* the reference's own mesh step at (data=4, model=2), in a subprocess with
  8 forced host devices (as ``tests/test_bus.py`` runs its mesh tests),
  GSPMD sharding its forward by the same specs, on its
  ``ppermute``/``allreduce`` backends and its allreduce mode (its fused
  bus does not trace under ``shard_map`` with this JAX): rtol 1e-5 /
  atol 1e-6;
* the checkpoint files equal, member for member, those a meshless save of
  the ranks' params gathered writes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import zipfile
from datetime import timedelta

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch import _tree  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import bus  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state, make_train_step  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch import tensor_parallel as tp  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, WorkerMesh, make_host_mesh  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.models import remat  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import train  # noqa: E402

WORLD = 8
RTOL, ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-6
STEPS = 2
M = 4
B, L = 4, 16                      # rows of 16 tokens per worker
LR = 0.05
WIDTHS = dict(n_layers=2, d_model=64, head_dim=8, d_ff=128, vocab_size=256,
              param_dtype="float32", compute_dtype="float32")
ARCHS = {"granite": ("granite-3-2b", dict(n_heads=8, n_kv_heads=2)),
         "granite-v257": ("granite-3-2b", dict(n_heads=8, n_kv_heads=2, vocab_size=257)),
         "granite-remat": ("granite-3-2b", dict(n_heads=8, n_kv_heads=2, remat=True)),
         "gemma": ("gemma-2b", dict(n_heads=8, n_kv_heads=1)),
         "deepseek": ("deepseek-7b", dict(n_heads=8, n_kv_heads=8)),
         "chameleon": ("chameleon-34b", dict(n_heads=8, n_kv_heads=2)),
         "nemotron": ("nemotron-4-340b", dict(n_heads=8, n_kv_heads=2))}
MESHES = {"4x2": dict(data=4, model=2), "2x4": dict(data=2, model=4),
          "2x2x2": dict(pod=2, data=2, model=2)}


def _cfg(arch: str):
    name, extra = ARCHS[arch]
    return get_config(name, reduced=True, **{**WIDTHS, **extra})


def _case(name, mesh, arch="granite", mode="gossip", backend="fused", topo="ring",
          ref=False, **opts):
    return dict(name=name, mesh=mesh, arch=arch, mode=mode, backend=backend, topo=topo,
                ref=ref, opts=opts)


CASES = [
    _case("4x2-granite-fused", "4x2"),
    _case("4x2-granite-ppermute", "4x2", backend="ppermute", ref=True),
    _case("4x2-granite-allreduce", "4x2", backend="allreduce", topo="clique", ref=True),
    _case("4x2-granite-adapt-then-combine", "4x2", mix_first=False),
    _case("4x2-granite-microbatch2", "4x2", microbatch=2),
    _case("4x2-granite-adafactor", "4x2", optimizer="adafactor"),
    _case("4x2-granite-remat", "4x2", arch="granite-remat"),
    _case("4x2-allreduce-mode", "4x2", mode="allreduce", ref=True),
    _case("4x2-granite-v257-fused", "4x2", arch="granite-v257"),
    _case("4x2-gemma-fused", "4x2", arch="gemma"),
    _case("4x2-gemma-ppermute", "4x2", arch="gemma", backend="ppermute", ref=True),
    _case("4x2-deepseek-fused", "4x2", arch="deepseek"),
    _case("4x2-chameleon-fused", "4x2", arch="chameleon"),
    _case("4x2-nemotron-fused", "4x2", arch="nemotron"),
    _case("2x4-granite-fused", "2x4"),
    _case("2x4-gemma-fused", "2x4", arch="gemma"),
    _case("2x4-chameleon-ppermute", "2x4", arch="chameleon", backend="ppermute"),
    _case("2x4-nemotron-adafactor", "2x4", arch="nemotron", optimizer="adafactor"),
    _case("2x4-allreduce-mode-microbatch2", "2x4", mode="allreduce", microbatch=2),
    _case("2x2x2-granite-fused", "2x2x2"),
    _case("2x2x2-deepseek-ppermute", "2x2x2", arch="deepseek", backend="ppermute"),
    _case("2x2x2-allreduce-mode", "2x2x2", mode="allreduce"),
]
BY_NAME = {c["name"]: c for c in CASES}
# the train() cases on (4, 2): (name, checkpoint kind, mode)
LOOPS = [("train-sharded", "sharded", "gossip"),
         ("train-monolithic", "monolithic", "gossip"),
         ("train-allreduce", "monolithic", "allreduce")]


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds; the same on every rank and in the oracles
# ---------------------------------------------------------------------------


def _weights(defs, seed: int, tree_map):
    """Different weights per worker: every leaf (M, *shape), float32, drawn
    in the trees' common leaf order."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        x = 0.05 * rng.normal(size=(M,) + tuple(d.shape))
        return (x + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)

    return tree_map(leaf, defs)


def _tokens() -> np.ndarray:
    """(STEPS, M, B, L) token ids (allreduce mode: rows reshape to M·B)."""
    return np.random.default_rng(7).integers(0, 256, size=(STEPS, M, B, L)).astype(np.int64)


def _inputs(case, dtype=torch.float32):
    cfg = _cfg(case["arch"])
    if dtype == torch.float64:
        cfg = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    params = _tree.map(lambda x: torch.from_numpy(x).to(dtype),
                       _weights(Mo.model_defs(cfg), 3, _tree.map))
    toks = torch.from_numpy(_tokens())
    if case["mode"] == "allreduce":
        params = _tree.map(lambda x: x[0].clone(), params)
        toks = toks.reshape(STEPS, -1, L)
    return cfg, params, [{"tokens": toks[k]} for k in range(STEPS)]


def _optimizer(case):
    if case["opts"].get("optimizer") == "adafactor":
        return O.adafactor_like(LR)
    return O.momentum_sgd(LR, 0.9)


def _run_step_case(case, wm=None, dtype=torch.float32):
    """Two steps of ``make_train_step``; on a mesh from this rank's cut of
    the global inputs. Returns the final params, opt state and metrics."""
    cfg, params, batches = _inputs(case, dtype)
    opts = dict(case["opts"])
    opts.pop("optimizer", None)
    opt = _optimizer(case)
    gossip = None
    if case["mode"] == "gossip":
        # on the mesh bound to it: the fused bus gossips per model shard
        gossip = GossipSpec(topology=TT.make(case["topo"], M), backend=case["backend"]) \
            if wm is None else GossipSpec.for_mesh(TT.make(case["topo"], M), wm,
                                                   backend=case["backend"])
    specs = None
    if wm is not None:
        specs = S.param_pspecs(cfg, wm, case["mode"])
        params = S.local_tree(params, specs, wm)
        batches = [S.local_tree(b, {"tokens": wm.worker_spec()}, wm) for b in batches]
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt, gossip=gossip,
                           mode=case["mode"], mesh=wm, param_specs=specs, **opts)
    state = init_state(_tree.map(torch.clone, params), opt)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(torch.stack([f.float() for f in m]))
    return {"params": state.params, "opt": state.opt_state, "metrics": torch.stack(metrics)}


def _loop_case(mode: str):
    return BY_NAME["4x2-granite-fused" if mode == "gossip" else "4x2-allreduce-mode"]


def _run_loop(ckpt_kind, path, mesh=None, mode="gossip"):
    """train() of a (4, 2) case, checkpointing after every step."""
    case = _loop_case(mode)
    cfg, params, batches = _inputs(case)
    wm = WorkerMesh.ensure(mesh)
    specs = None if wm is None else S.param_pspecs(cfg, wm, mode)
    gossip = None
    if mode == "gossip":
        gossip = GossipSpec(topology=TT.make("ring", M), backend="fused") if wm is None \
            else GossipSpec.for_mesh(TT.make("ring", M), wm, backend="fused")
    state, hist = train(lambda p, b: Mo.loss_fn(p, cfg, b), params, O.momentum_sgd(LR, 0.9),
                        iter(batches), steps=STEPS, gossip=gossip, mode=mode,
                        mesh=mesh, param_specs=specs, log_every=1, ckpt_path=path,
                        ckpt_every=1, ckpt_sharded=ckpt_kind == "sharded", device="cpu",
                        verbose=False)
    fields = ("loss", "grad_energy", "grad_spread", "mean_grad_norm", "param_spread")
    return {"params": state.params, "history": {f: getattr(hist, f) for f in fields}}


def _wm_abstract(name: str) -> WorkerMesh:
    kw = MESHES[name]
    names = tuple(kw)
    return WorkerMesh.from_mesh(AbstractMesh(tuple(kw[n] for n in names), names))


def _tp_functions(wm):
    """f and g inside a two-layer product, under ``vmap(grad_and_value)``
    over 3 stacked workers, plain and through ``remat.checkpoint``: (loss,
    grads) of this rank's shards."""
    gen = torch.Generator().manual_seed(0)
    W1, W2 = torch.randn(3, 8, 16, generator=gen), torch.randn(3, 16, 8, generator=gen)
    x = torch.randn(3, 5, 8, generator=gen)
    k, r = wm.model_factor, wm.model_index
    w1, w2 = W1[..., r * 16 // k:(r + 1) * 16 // k], W2[:, r * 16 // k:(r + 1) * 16 // k]
    out = {}
    for use_remat in (False, True):
        def loss(w1, w2, x):
            def body(x, w1, w2):
                return tp.reduce_from_model(torch.relu(tp.copy_to_model(x) @ w1) @ w2)
            h = remat.checkpoint(body, x, w1, w2) if use_remat else body(x, w1, w2)
            return torch.sum(h ** 2) + torch.sum(tp.max_over_model(h))
        with mesh_lib.model_parallel(wm):
            out[use_remat] = torch.func.vmap(torch.func.grad_and_value(
                loss, argnums=(0, 1, 2)))(w1.contiguous(), w2.contiguous(), x)
    return out


def _tp_functions_meshless():
    gen = torch.Generator().manual_seed(0)
    W1, W2 = torch.randn(3, 8, 16, generator=gen), torch.randn(3, 16, 8, generator=gen)
    x = torch.randn(3, 5, 8, generator=gen)

    def loss(w1, w2, x):
        h = torch.relu(x @ w1) @ w2
        return torch.sum(h ** 2) + torch.sum(h.detach())

    return torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)))(W1, W2, x)


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    wms = {name: WorkerMesh.from_mesh(make_host_mesh(**kw, device="cpu"))
           for name, kw in MESHES.items()}
    out = {"cases": {}, "loops": {}, "coord": wms["4x2"].coordinate,
           "functions": _tp_functions(wms["4x2"])}
    rows, launch = [], bus.gossip_mix_2d

    def counted(w, *args, **kw):      # the rows of each gossip_mix call on the bus
        rows.append(int(w.shape[-2]))
        return launch(w, *args, **kw)

    bus.gossip_mix_2d = counted
    for case in CASES:
        wm = wms[case["mesh"]]
        rows.clear()
        out["cases"][case["name"]] = {"coord": wm.coordinate, **_run_step_case(case, wm),
                                      "rows": list(rows)}
    bus.gossip_mix_2d = launch

    for name, kind, mode in LOOPS:
        out["loops"][name] = _run_loop(kind, os.path.join(out_dir, name, "ck.npz"),
                                       wms["4x2"], mode)

    # a synchronous sharded save of the fused case's final params
    case, wm = BY_NAME["4x2-granite-fused"], wms["4x2"]
    TC.save_sharded(os.path.join(out_dir, "save-sharded", "ck"),
                    out["cases"][case["name"]]["params"], step=STEPS, wmesh=wm,
                    param_specs=S.param_pspecs(_cfg("granite"), wm, "gossip"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's mesh step, in a subprocess with 8 host devices
# ---------------------------------------------------------------------------


REFERENCE = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import compat, optim
from repro.configs import get_config
from repro.core import topology as T
from repro.core.decentralized import init_state, make_train_step
from repro.core.gossip import GossipSpec
from repro.launch import shardings as S
from repro.launch.mesh import WorkerMesh, make_host_mesh
from repro.models import model as Mo

sys.path.insert(0, sys.argv[3])
from test_torch_train_tp import ARCHS, WIDTHS, LR, L, M, _weights, _tokens, MESHES

cases, out = json.loads(sys.argv[1]), {}
for c in cases:
    name, extra = ARCHS[c["arch"]]
    cfg = get_config(name, reduced=True, **{**WIDTHS, **extra})
    wm = WorkerMesh.from_mesh(make_host_mesh(**MESHES[c["mesh"]]))
    params = _weights(Mo.model_defs(cfg), 3, jax.tree.map)
    toks = _tokens()
    opt = optim.momentum_sgd(LR, 0.9)
    opts = dict(c["opts"])
    with compat.set_mesh(wm.mesh):
        if c["mode"] == "gossip":
            specs = S.param_pspecs(cfg, wm, "gossip")
            bspec = P(wm.wa, None, None)
            gossip = GossipSpec.for_mesh(T.make(c["topo"], M), wm, backend=c["backend"])
        else:
            params = jax.tree.map(lambda x: x[0], params)
            toks = toks.reshape(toks.shape[0], -1, L)
            specs = S.param_pspecs(cfg, wm, "allreduce")
            bspec, gossip = P(wm.wa, None), None
        p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(wm.mesh, s)), params, specs)
        step = jax.jit(make_train_step(lambda q, b: Mo.loss_fn(q, cfg, b), opt, gossip=gossip,
                                       mode=c["mode"], mesh=wm, param_specs=specs, **opts))
        state = init_state(p, opt)
        metrics = []
        for k in range(toks.shape[0]):
            batch = {"tokens": jax.device_put(toks[k], NamedSharding(wm.mesh, bspec))}
            state, m = step(state, batch)
            metrics.append(np.asarray([np.float32(f) for f in m]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[c["name"] + "|" + key] = np.asarray(leaf)
    out[c["name"] + "|metrics"] = np.stack(metrics)
np.savez(sys.argv[2], **out)
print("reference-ok")
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 8 ranks and the reference's subprocess together; load
    what each wrote."""
    tmp = tmp_path_factory.mktemp("gloo")
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "..", "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([src] + [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    ref_path = str(tmp / "reference.npz")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    procs.append(subprocess.Popen([sys.executable, "-c", REFERENCE,
                                   json.dumps([c for c in CASES if c["ref"]]), ref_path, here],
                                  env=jenv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, bad
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "dir": str(tmp), "reference": dict(np.load(ref_path))}


# ---------------------------------------------------------------------------
# The meshless oracles (one intra-op thread)
# ---------------------------------------------------------------------------


def _single_thread(fn, *args, **kw):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args, **kw)
    finally:
        torch.set_num_threads(n)


_ORACLE: dict = {}


def _meshless(case, dtype=torch.float32):
    key = (case["name"], dtype)
    if key not in _ORACLE:
        _ORACLE[key] = _single_thread(_run_step_case, case, dtype=dtype)
    return _ORACLE[key]


def _specs(case, mesh_name):
    return S.param_pspecs(_cfg(case["arch"]), _wm_abstract(mesh_name), case["mode"])


def _cut(tree, case, mesh_name, coord):
    return S.local_tree(tree, _specs(case, mesh_name), _wm_abstract(mesh_name),
                        coordinate=coord)


def _gathered(pieces, case, mesh_name):
    """The global tree from every rank's (coordinate, local tree): each
    piece copied into its place (``local_tree`` cuts views)."""
    coord0, local0 = pieces[0]
    like = _global_like(case)
    whole = _tree.map(lambda x, y: torch.zeros(x.shape, dtype=y.dtype), like, local0)
    for coord, local in pieces:
        for dst, src in zip(_tree.leaves(_cut(whole, case, mesh_name, coord)),
                            _tree.leaves(local)):
            dst.copy_(src)
    return whole


def _global_like(case):
    lead = () if case["mode"] == "allreduce" else (M,)
    return _tree.map(lambda d: torch.empty(lead + tuple(d.shape), device="meta"),
                     Mo.model_defs(_cfg(case["arch"])))


def _adafactor(case) -> bool:
    return case["opts"].get("optimizer") == "adafactor"


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_equals_the_meshless_step(ranks, case):
    """Every rank's params and optimizer state are the meshless step's,
    cut to it, at rtol 1e-5 / atol 1e-6; under adafactor_like the rank's
    params are within twice the meshless float32 step's largest distance
    from the float64 step."""
    want = _meshless(case)
    got = [r["cases"][case["name"]] for r in ranks["ranks"]]
    assert len(got) == WORLD
    if _adafactor(case):
        exact = _meshless(case, torch.float64)
        for r in got:
            dist, own = 0.0, 0.0
            for a, b, w in zip(_tree.leaves(r["params"]),
                               _tree.leaves(_cut(want["params"], case, case["mesh"],
                                                 r["coord"])),
                               _tree.leaves(_cut(exact["params"], case, case["mesh"],
                                                 r["coord"]))):
                assert a.shape == b.shape
                dist = max(dist, (a.double() - w).abs().max().item())
                own = max(own, (b.double() - w).abs().max().item())
            assert dist <= 2 * own, (case["name"], dist, own)
        return
    for r in got:
        pairs = list(zip(_tree.leaves(r["params"]),
                         _tree.leaves(_cut(want["params"], case, case["mesh"], r["coord"]))))
        pairs += list(zip(_tree.leaves(r["opt"]),
                          _tree.leaves(_cut(want["opt"], case, case["mesh"], r["coord"]))))
        for a, b in pairs:
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_step_metrics_count_each_leaf_once(ranks, case):
    """Every rank reports the same metrics, those of all M workers: a
    sharded leaf's squares summed over the model group, a replicated leaf
    counted once (k times would be off by far more than rtol 1e-6)."""
    want = _meshless(case)["metrics"]
    got = [r["cases"][case["name"]]["metrics"] for r in ranks["ranks"]]
    for m in got[1:]:
        assert torch.equal(m, got[0])
    torch.testing.assert_close(got[0], want, rtol=STATS_RTOL, atol=0.0)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_holds_one_kth_of_the_sharded_leaves(ranks, case):
    """A rank holds 1/k of every leaf the specs shard over 'model' (of its
    workers' rows), the rest whole, and the same shapes as the specs cut."""
    wm = _wm_abstract(case["mesh"])
    k, n = wm.model_factor, wm.n_workers if case["mode"] == "gossip" else 1
    like = _global_like(case)
    flags = bus.sharded_leaf_flags(_specs(case, case["mesh"]), wm.model_axis,
                                   treedef=_tree.flatten(like)[1])
    assert any(flags)
    for r in ranks["ranks"]:
        local = _tree.leaves(r["cases"][case["name"]]["params"])
        sharded = sum(x.numel() for x, f in zip(local, flags) if f)
        whole = sum(x.numel() for x, f in zip(local, flags) if not f)
        assert sharded * k * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if f)
        assert whole * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if not f)


@pytest.mark.parametrize("case", [c for c in CASES if c["backend"] == "fused"
                                  and c["mode"] == "gossip"],
                         ids=lambda c: c["name"])
def test_the_fused_bus_mixes_the_ranks_share_of_the_rows(ranks, case):
    """Each step's gossip_mix call on a rank covers its workers' rows of
    the per-model-shard bus (tensor-sharded leaves as local shards, every
    other leaf row-split over the model group and all-gathered after the
    mix): about 1/k of a replica's rows."""
    wm = _wm_abstract(case["mesh"])
    k, m = wm.model_factor, M // wm.n_workers
    like = _global_like(case)
    flags = bus.sharded_leaf_flags(_specs(case, case["mesh"]), wm.model_axis,
                                   treedef=_tree.flatten(like)[1])
    for r in ranks["ranks"]:
        local = r["cases"][case["name"]]["params"]
        planned = bus.plan_layout(local, shards=k, leaf_sharded=flags).groups[0].rows
        whole = bus.plan_layout(like).groups[0].rows
        assert r["cases"][case["name"]]["rows"] == [m * planned] * STEPS
        assert planned <= whole / k + bus.sublane_rows(torch.float32)


REF_CASES = [c for c in CASES if c["ref"]]


@pytest.mark.parametrize("case", REF_CASES, ids=[c["name"] for c in REF_CASES])
def test_each_rank_equals_the_reference_mesh_step(ranks, case):
    ref = ranks["reference"]
    like = _global_like(case)
    keys = [case["name"] + "|" + "/".join(map(str, p)) for p, _ in _tree.flatten_with_path(like)]
    want = _tree.unflatten(_tree.flatten(like)[1], [torch.from_numpy(ref[k]) for k in keys])
    for r in ranks["ranks"]:
        got = r["cases"][case["name"]]
        for a, b in zip(_tree.leaves(got["params"]),
                        _tree.leaves(_cut(want, case, case["mesh"], got["coord"]))):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(got["metrics"],
                                   torch.from_numpy(ref[case["name"] + "|metrics"]),
                                   rtol=RTOL, atol=ATOL)


def test_the_collectives_carry_through_vmap_and_remat(ranks):
    """copy_to_model / reduce_from_model / max_over_model inside a
    two-layer product under vmap(grad_and_value) over stacked workers,
    plain and through remat.checkpoint: the loss and the gradients of x are
    the meshless ones, those of the weights their cut; remat equals plain."""
    (gw1, gw2, gx), loss = _tp_functions_meshless()
    for r in ranks["ranks"]:
        k, i = 2, r["coord"]["model"]
        plain, recomputed = r["functions"][False], r["functions"][True]
        for (g1, g2, g3), l in (plain, recomputed):
            torch.testing.assert_close(l, loss, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(g1, gw1[..., i * 16 // k:(i + 1) * 16 // k],
                                       rtol=RTOL, atol=1e-4)
            torch.testing.assert_close(g2, gw2[:, i * 16 // k:(i + 1) * 16 // k],
                                       rtol=RTOL, atol=1e-4)
            torch.testing.assert_close(g3, gx, rtol=RTOL, atol=1e-4)
        for a, b in zip(_tree.leaves(plain), _tree.leaves(recomputed)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# train() and its checkpoints
# ---------------------------------------------------------------------------


def _members(path: str):
    """A file's content: an npz as its (member, bytes) list, since the zip
    headers carry each write's time; anything else its bytes."""
    if not path.endswith(".npz"):
        with open(path, "rb") as f:
            return f.read()
    with zipfile.ZipFile(path) as z:
        return [(n, z.read(n)) for n in z.namelist()]


def _same_files(got_dir: str, want_dir: str) -> None:
    files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == files
    for f in files:
        assert _members(os.path.join(got_dir, f)) == _members(os.path.join(want_dir, f)), f


@pytest.fixture(scope="module")
def meshless_loops(ranks, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshless")
    return {name: _single_thread(_run_loop, kind, str(tmp / name / "ck.npz"), None, mode)
            for name, kind, mode in LOOPS}


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_train_on_the_model_axis_equals_meshless_train(ranks, meshless_loops, loop):
    """The rank's final params are the meshless train()'s cut (rtol 1e-5 /
    atol 1e-6); every rank's History is the same, within rtol 1e-6 of the
    meshless one."""
    name, _, mode = loop
    want, case = meshless_loops[name], _loop_case(mode)
    got = [r["loops"][name] for r in ranks["ranks"]]
    for r, rk in zip(got, ranks["ranks"]):
        for a, b in zip(_tree.leaves(r["params"]),
                        _tree.leaves(_cut(want["params"], case, "4x2", rk["coord"]))):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert r["history"] == got[0]["history"]
    for field, values in got[0]["history"].items():
        np.testing.assert_allclose(values, want["history"][field], rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_checkpoint_files_equal_a_meshless_save_of_the_gathered_params(
        ranks, tmp_path, loop):
    """train()'s files on the (4, 2) mesh (the last save: the final
    params) are, member for member, those a meshless save of the ranks'
    params gathered writes: shards named by the mesh's coordinates, or one
    monolithic file (allreduce mode: the first rank's gathered replica)."""
    name, kind, mode = loop
    case = _loop_case(mode)
    pieces = [(r["coord"], r["loops"][name]["params"]) for r in ranks["ranks"]]
    whole = _gathered(pieces, case, "4x2")
    want = str(tmp_path / "ck.npz")
    if kind == "sharded":
        TC.save_sharded(want, whole, step=STEPS, wmesh=_wm_abstract("4x2"))
    else:
        TC.save(want, whole, step=STEPS)
    _same_files(os.path.join(ranks["dir"], name), str(tmp_path))


def test_save_sharded_over_the_model_axis_equals_a_meshless_save(ranks, tmp_path):
    """A synchronous save_sharded(wmesh=, param_specs=) of the fused case's
    final params: the group's model rank 0 writes its worker's file from
    the gathered leaves, member for member a meshless save's."""
    case = BY_NAME["4x2-granite-fused"]
    pieces = [(r["coord"], r["cases"][case["name"]]["params"]) for r in ranks["ranks"]]
    TC.save_sharded(str(tmp_path / "ck"), _gathered(pieces, case, "4x2"), step=STEPS,
                    wmesh=_wm_abstract("4x2"))
    _same_files(os.path.join(ranks["dir"], "save-sharded"), str(tmp_path))


# ---------------------------------------------------------------------------
# gqa_apply at k = 16, from abstract coordinates
# ---------------------------------------------------------------------------


def test_gqa_with_replicated_kv_heads_at_k16_sums_to_the_meshless_layer(monkeypatch):
    """granite's 32 q heads and 8 kv heads at model factor 16: the kv heads
    do not divide 16 and stay replicated, each rank holds 2 q heads, and
    its heads read kv head (2r + i) // 4. The 16 ranks' partial outputs
    (the collectives made identities) sum to the meshless attention, in
    float64, where a summation order moves nothing at rtol 1e-5 and a head
    read from the wrong kv head moves the output by its whole size."""
    cfg = get_config("granite-3-2b", reduced=True, d_model=64, n_heads=32, n_kv_heads=8,
                     head_dim=8)
    wm = WorkerMesh.from_mesh(AbstractMesh((1, 16), ("data", "model")))
    rng = np.random.default_rng(5)
    defs = A.gqa_defs(cfg)
    params = _tree.map(lambda d: torch.from_numpy(0.2 * rng.normal(size=d.shape)), defs)
    x = torch.from_numpy(rng.normal(size=(2, 12, 64)))
    want, _ = A.gqa_apply(params, cfg, x)
    from repro_torch.models.params import tree_specs

    specs = tree_specs(defs, mesh=wm)
    assert specs["wq"][1] == "model" and specs["wk"][1] is None
    monkeypatch.setattr(tp, "copy_to_model", lambda t: t)
    monkeypatch.setattr(tp, "reduce_from_model", lambda t: t)
    total = torch.zeros_like(want)
    for r in range(16):
        local = S.local_tree(params, specs, wm, coordinate={"data": 0, "model": r})
        assert local["wq"].shape[1] == 2 and local["wk"].shape[1] == 8
        token = mesh_lib._MODEL.set(mesh_lib.ModelShard(None, 16, r))
        try:
            out, _ = A.gqa_apply(local, cfg, x)
        finally:
            mesh_lib._MODEL.reset(token)
        total += out
    torch.testing.assert_close(total, want, rtol=RTOL, atol=ATOL)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
