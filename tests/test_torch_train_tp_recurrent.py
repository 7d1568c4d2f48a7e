"""Tensor-parallel training of Mamba-2 and RG-LRU over the model axis of
live gloo meshes on the CPU.

One launch of 8 ranks for the whole file (a ``FileStore`` in a temporary
directory): this file, run as a script, is one rank. The (data=4, model=1)
mesh over ranks 0–3 is made first, before the (data=4, model=2) and
(data=2, model=4) meshes over all 8 and before the first sharded save,
whose report group must form all the same. M = 4 workers, 2 layers at
narrow widths, float32, different random weights per worker from a numpy
seed:

* mamba2-2.7b with 8 heads of 16 (d_inner 128, one B/C group, state 16,
  chunks of 8): a rank's heads at k = 2 and 4, ``in_proj`` and the conv
  gathered over the model group; with 6 heads (d_model 48) the heads
  divide k = 2 but not 4, where the layer runs whole on every rank, its
  cut conv, norm and ``out_proj`` leaves gathered;
* recurrentgemma-2b, an RG-LRU layer (width 64) and a local-attention
  layer (MQA, 8 heads): the width's channels cut, the gate products
  summed and cut over the model group.

Step cases (``make_train_step(mesh=, param_specs=)``, two steps each) on
the fused bus and ``ppermute``, with ``remat``, ``adafactor_like`` (on
recurrentgemma: its float64 witness needs a float64 forward, which
Mamba-2's float32 SSD products do not take), and ``mode='allreduce'``.
The reference's step runs the ``ppermute`` cases on (4, 2) and the
allreduce-mode ones: its fused bus on a mesh and its ``ppermute`` with
two workers per rank do not run. Loop cases (``train(mesh=, param_specs=)`` on (4,
2)): gossip with sharded checkpoints through the asynchronous writer, and
a restore onto the mesh.

Oracles, as ``tests/test_torch_train_tp_moe.py``'s: the port's meshless
step (and ``train()``) on the global tree, one intra-op thread, cut to
each rank, at rtol 1e-5 / atol 1e-6 (``adafactor_like``: the float64
witness rule); the reference's own GSPMD step in a subprocess with 8 host
devices, at the same tolerance; the checkpoint files member for member a
meshless save's. The two collectives these layers add
(``tensor_parallel.reduce_scatter_model`` and ``all_gather_model``) are
held under ``vmap(grad_and_value)`` against the meshless functions they
cut.
"""
import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from test_torch_train_tp import _same_files, _single_thread  # noqa: E402

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
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import train  # noqa: E402

WORLD = 8
RTOL, ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-6
STEPS = 2
M = 4
B, L = 4, 16                      # rows of 16 tokens per worker
LR = 0.05
WIDTHS = dict(n_layers=2, d_model=64, vocab_size=256, param_dtype="float32",
              compute_dtype="float32")
MAMBA = dict(ssm_headdim=16, ssm_state=16, ssm_chunk=8)
RGLRU = dict(lru_width=64, n_heads=8, n_kv_heads=1, head_dim=8, d_ff=128, window=32)
ARCHS = {"mamba2": ("mamba2-2.7b", MAMBA),
         "mamba2-remat": ("mamba2-2.7b", dict(MAMBA, remat=True)),
         "mamba2-h6": ("mamba2-2.7b", dict(MAMBA, d_model=48)),
         "rglru": ("recurrentgemma-2b", RGLRU),
         "rglru-remat": ("recurrentgemma-2b", dict(RGLRU, remat=True))}
MESHES = {"4x2": dict(data=4, model=2), "2x4": dict(data=2, model=4),
          "4x1": dict(data=4, model=1)}


def _cfg(arch: str):
    name, extra = ARCHS[arch]
    return get_config(name, reduced=True, **{**WIDTHS, **extra})


def _case(name, mesh, arch, mode="gossip", backend="fused", ref=False, **opts):
    return dict(name=name, mesh=mesh, arch=arch, mode=mode, backend=backend, ref=ref,
                opts=opts)


CASES = [
    _case("4x2-mamba2-fused", "4x2", "mamba2"),
    _case("4x2-mamba2-ppermute", "4x2", "mamba2", backend="ppermute", ref=True),
    _case("4x2-mamba2-remat", "4x2", "mamba2-remat"),
    _case("2x4-mamba2-fused", "2x4", "mamba2"),
    _case("4x2-mamba2-h6-fused", "4x2", "mamba2-h6"),
    _case("2x4-mamba2-h6-whole", "2x4", "mamba2-h6"),
    _case("4x2-rglru-fused", "4x2", "rglru"),
    _case("4x2-rglru-ppermute", "4x2", "rglru", backend="ppermute", ref=True),
    _case("4x2-rglru-remat", "4x2", "rglru-remat"),
    _case("4x2-rglru-adafactor", "4x2", "rglru", optimizer="adafactor"),
    _case("2x4-rglru-fused", "2x4", "rglru"),
    _case("2x4-rglru-adafactor", "2x4", "rglru", optimizer="adafactor"),
    _case("4x1-allreduce-mode-mamba2", "4x1", "mamba2", mode="allreduce"),
    _case("4x2-allreduce-mode-mamba2", "4x2", "mamba2", mode="allreduce", ref=True),
    _case("2x4-allreduce-mode-mamba2", "2x4", "mamba2", mode="allreduce", ref=True),
    _case("2x4-allreduce-mode-mamba2-h6", "2x4", "mamba2-h6", mode="allreduce", ref=True),
    _case("2x4-allreduce-mode-rglru", "2x4", "rglru", mode="allreduce", ref=True),
]
BY_NAME = {c["name"]: c for c in CASES}
REF_CASES = [c for c in CASES if c["ref"]]
# the train() cases on (4, 2), sharded checkpoints: (name, case)
LOOPS = [("train-mamba2", "4x2-mamba2-fused"), ("train-rglru", "4x2-rglru-fused")]


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds; the same on every rank and in the oracles
# ---------------------------------------------------------------------------


def _weights(defs, seed: int, tree_map):
    """Different weights per worker: every leaf (M, *shape), float32."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        x = 0.05 * rng.normal(size=(M,) + tuple(d.shape))
        return (x + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)

    return tree_map(leaf, defs)


def _batches_np() -> dict:
    """(STEPS, M, B, L) token ids (allreduce mode: rows reshape to M·B)."""
    rng = np.random.default_rng(7)
    return {"tokens": rng.integers(0, 256, size=(STEPS, M, B, L)).astype(np.int64)}


def _inputs(case, dtype=torch.float32):
    cfg = _cfg(case["arch"])
    if dtype == torch.float64:
        cfg = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    params = _tree.map(lambda x: torch.from_numpy(x).to(dtype),
                       _weights(Mo.model_defs(cfg), 3, _tree.map))
    data = {k: torch.from_numpy(v) for k, v in _batches_np().items()}
    if case["mode"] == "allreduce":
        params = _tree.map(lambda x: x[0].clone(), params)
        data = {k: v.reshape((STEPS, M * B) + v.shape[3:]) for k, v in data.items()}
    batches = [{k: v[s] for k, v in data.items()} for s in range(STEPS)]
    return cfg, params, batches


def _gossip(case, wm):
    if case["mode"] != "gossip":
        return None
    if wm is None:
        return GossipSpec(topology=TT.make("ring", M), backend=case["backend"])
    return GossipSpec.for_mesh(TT.make("ring", M), wm, backend=case["backend"])


def _run_step_case(case, wm=None, dtype=torch.float32):
    cfg, params, batches = _inputs(case, dtype)
    opts = dict(case["opts"])
    opt = O.adafactor_like(LR) if opts.pop("optimizer", None) == "adafactor" \
        else O.momentum_sgd(LR, 0.9)
    specs = None
    if wm is not None:
        specs = S.param_pspecs(cfg, wm, case["mode"])
        params = S.local_tree(params, specs, wm)
        batches = [S.local_tree(b, _tree.map(lambda _: wm.worker_spec(), b), wm)
                   for b in batches]
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt, gossip=_gossip(case, wm),
                           mode=case["mode"], mesh=wm, param_specs=specs, **opts)
    state = init_state(_tree.map(torch.clone, params), opt)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(torch.stack([f.float() for f in m]))
    return {"params": state.params, "opt": state.opt_state, "metrics": torch.stack(metrics)}


def _run_loop(case, path, mesh=None):
    cfg, params, batches = _inputs(case)
    wm = WorkerMesh.ensure(mesh)
    specs = None if wm is None else S.param_pspecs(cfg, wm, "gossip")
    state, hist = train(lambda p, b: Mo.loss_fn(p, cfg, b), params, O.momentum_sgd(LR, 0.9),
                        iter(batches), steps=STEPS, gossip=_gossip(case, wm), mesh=mesh,
                        param_specs=specs, log_every=1, ckpt_path=path, ckpt_every=1,
                        ckpt_sharded=True, device="cpu", verbose=False)
    fields = ("loss", "grad_energy", "grad_spread", "mean_grad_norm", "param_spread")
    return {"params": state.params, "history": {f: getattr(hist, f) for f in fields}}


def _wm_abstract(name: str) -> WorkerMesh:
    kw = MESHES[name]
    return WorkerMesh.from_mesh(AbstractMesh((kw["data"], kw["model"]), ("data", "model")))


# the two collectives, each in a function of 3 stacked workers whose
# meshless form is known: (W (3, 16, 16), x (3, 5, 16)) and the loss
def _function_inputs():
    gen = torch.Generator().manual_seed(0)
    return (torch.randn(3, 16, 16, generator=gen, dtype=torch.float64),
            torch.randn(3, 5, 16, generator=gen, dtype=torch.float64))


C = torch.arange(16.0, dtype=torch.float64) * torch.linspace(0.5, 1.5, 16, dtype=torch.float64)


def _reduce_scatter_loss(w, x, k: int, r: int):
    """Meshless (k = 1): sum(tanh(x @ W) · c). On the model axis the rank
    holds W's rows r and reads x's columns r: its product is a partial sum,
    cut to its columns of the whole."""
    n = 16 // k
    if k == 1:
        return torch.sum(torch.tanh(x @ w) * C)
    xr = tp.copy_to_model(x).narrow(-1, r * n, n)
    z = tp.reduce_scatter_model(xr @ w, -1)
    return tp.reduce_from_model(torch.sum(torch.tanh(z) * C.narrow(0, r * n, n)))


def _all_gather_loss(w, x, k: int, r: int):
    """Meshless (k = 1): Σ_j sum(tanh(x @ W) · c · (j + 1)) over the r
    terms of r ranks. On the model axis the rank holds W's columns r,
    gathers W whole and adds its own term: each rank's cotangent of the
    whole W is a partial one."""
    if k == 1:
        return sum(torch.sum(torch.tanh(x @ w) * C * (j + 1)) for j in range(r))
    z = tp.copy_to_model(x) @ tp.all_gather_model(w, -1)
    return tp.reduce_from_model(torch.sum(torch.tanh(z) * C * (r + 1)))


def _functions(wm):
    """The rank's model index, and each collective's function under
    vmap(grad_and_value) over 3 stacked workers on this rank: (loss, (grad
    of the rank's W cut, grad of x))."""
    W, x = _function_inputs()
    k, r = wm.model_factor, wm.model_index
    n = 16 // k
    out = {"index": r}
    with mesh_lib.model_parallel(wm):
        out["reduce_scatter"] = torch.func.vmap(torch.func.grad_and_value(
            lambda w, x: _reduce_scatter_loss(w, x, k, r), argnums=(0, 1)))(
                W[:, r * n:(r + 1) * n].contiguous(), x)
        out["all_gather"] = torch.func.vmap(torch.func.grad_and_value(
            lambda w, x: _all_gather_loss(w, x, k, r), argnums=(0, 1)))(
                W[..., r * n:(r + 1) * n].contiguous(), x)
    return out


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    # the (4, 1) mesh over ranks 0-3 first: the sharded saves after it form
    # their report group all the same
    dms = {name: make_host_mesh(**MESHES[name], device="cpu") for name in ("4x1", "4x2", "2x4")}
    wms = {name: WorkerMesh.from_mesh(dm) for name, dm in dms.items()}
    out = {"cases": {}, "loops": {}, "coord": wms["4x2"].coordinate,
           "functions": {name: _functions(wms[name]) for name in ("4x2", "2x4")}}
    for name, case_name in LOOPS:
        out["loops"][name] = _run_loop(BY_NAME[case_name],
                                       os.path.join(out_dir, name, "ck.npz"), wms["4x2"])
    # the sharded checkpoint restored onto the mesh: the rank's cut
    case = BY_NAME["4x2-mamba2-fused"]
    out["restored"] = TC.restore(os.path.join(out_dir, "train-mamba2", "ck.npz"),
                                 _global_like(case), device="cpu", wmesh=wms["4x2"],
                                 param_specs=S.param_pspecs(_cfg(case["arch"]), wms["4x2"],
                                                            "gossip"))

    rows, launch = [], bus.gossip_mix_2d

    def counted(w, *args, **kw):      # the rows of each gossip_mix call on the bus
        rows.append(int(w.shape[-2]))
        return launch(w, *args, **kw)

    bus.gossip_mix_2d = counted
    for case in CASES:
        if dms[case["mesh"]].get_coordinate() is None:
            continue
        wm = wms[case["mesh"]]
        rows.clear()
        out["cases"][case["name"]] = {"coord": wm.coordinate, **_run_step_case(case, wm),
                                      "rows": list(rows)}
    bus.gossip_mix_2d = launch
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


def _subset_then_save(rank: int, store_path: str, out_dir: str) -> None:
    """A (4, 1) mesh over ranks 0-3, then a (4, 2) mesh over all 8 and a
    sharded save over it, with a 30 s collective timeout."""
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=30))
    make_host_mesh(data=4, model=1, device="cpu")
    wm = WorkerMesh.from_mesh(make_host_mesh(data=4, model=2, device="cpu"))
    tree = {"w": torch.full((1, 4), float(wm.worker_index))}
    TC.save_sharded(os.path.join(out_dir, "ck"), tree, step=1, wmesh=wm,
                    param_specs={"w": wm.worker_spec()})
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's GSPMD step, in a subprocess with 8 host devices
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
from test_torch_train_tp_recurrent import ARCHS, WIDTHS, LR, M, B, _weights, _batches_np, MESHES

cases, out = json.loads(sys.argv[1]), {}
for c in cases:
    name, extra = ARCHS[c["arch"]]
    cfg = get_config(name, reduced=True, **{**WIDTHS, **extra})
    wm = WorkerMesh.from_mesh(make_host_mesh(**MESHES[c["mesh"]]))
    params = _weights(Mo.model_defs(cfg), 3, jax.tree.map)
    data = _batches_np()
    opt = optim.momentum_sgd(LR, 0.9)
    with compat.set_mesh(wm.mesh):
        if c["mode"] == "gossip":
            specs = S.param_pspecs(cfg, wm, "gossip")
            gossip = GossipSpec.for_mesh(T.make("ring", M), wm, backend=c["backend"])
        else:
            params = jax.tree.map(lambda x: x[0], params)
            data = {k: v.reshape((v.shape[0], M * B) + v.shape[3:]) for k, v in data.items()}
            specs = S.param_pspecs(cfg, wm, "allreduce")
            gossip = None
        p = jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(wm.mesh, s)), params, specs)
        step = jax.jit(make_train_step(lambda q, b: Mo.loss_fn(q, cfg, b), opt, gossip=gossip,
                                       mode=c["mode"], mesh=wm, param_specs=specs))
        state = init_state(p, opt)
        metrics = []
        for k in range(data["tokens"].shape[0]):
            batch = {n: jax.device_put(v[k], NamedSharding(wm.mesh, P(wm.wa)))
                     for n, v in data.items()}
            state, m = step(state, batch)
            metrics.append(np.asarray([np.float32(f) for f in m]))
    for path, leaf in jax.tree_util.tree_flatten_with_path(state.params)[0]:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
        out[c["name"] + "|" + key] = np.asarray(leaf)
    out[c["name"] + "|metrics"] = np.stack(metrics)
np.savez(sys.argv[2], **out)
print("reference-ok")
"""


def _env():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([os.path.join(here, "..", "src")] +
                                        [p for p in [env.get("PYTHONPATH")] if p])
    env["OMP_NUM_THREADS"] = "1"
    return here, env


def _launch(tmp, mode: str, timeout: float, extra=()):
    """Run the 8 ranks of ``mode`` (and the ``extra`` processes) to their
    end; kill them all past ``timeout`` seconds. Returns the logs."""
    here, env = _env()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    procs += [subprocess.Popen(args, env=dict(env, **e), stdout=subprocess.PIPE,
                               stderr=subprocess.STDOUT) for args, e in extra]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        for q in procs:
            q.kill()
        raise
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode]
    assert not bad, bad
    return logs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Launch the 8 ranks and the reference's subprocess together; load
    what each wrote."""
    tmp = tmp_path_factory.mktemp("gloo")
    here, _ = _env()
    ref_path = str(tmp / "reference.npz")
    jax_env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=8", "JAX_PLATFORMS": "cpu"}
    _launch(tmp, "rank", 300, [([sys.executable, "-c", REFERENCE, json.dumps(REF_CASES),
                                 ref_path, here], jax_env)])
    out = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": out, "dir": str(tmp), "reference": dict(np.load(ref_path))}


# ---------------------------------------------------------------------------
# The meshless oracles (one intra-op thread)
# ---------------------------------------------------------------------------


_ORACLE: dict = {}


def _meshless(case, dtype=torch.float32):
    key = (case["name"], dtype)
    if key not in _ORACLE:
        _ORACLE[key] = _single_thread(_run_step_case, case, dtype=dtype)
    return _ORACLE[key]


def _specs(case, mesh=None):
    return S.param_pspecs(_cfg(case["arch"]), _wm_abstract(mesh or case["mesh"]), case["mode"])


def _cut(tree, case, coord, mesh=None):
    mesh = mesh or case["mesh"]
    return S.local_tree(tree, _specs(case, mesh), _wm_abstract(mesh), coordinate=coord)


def _global_like(case):
    lead = () if case["mode"] == "allreduce" else (M,)
    return _tree.map(lambda d: torch.empty(lead + tuple(d.shape), device="meta"),
                     Mo.model_defs(_cfg(case["arch"])))


def _gathered(pieces, case, mesh):
    """The global tree from every rank's (coordinate, local tree)."""
    _, local0 = pieces[0]
    whole = _tree.map(lambda x, y: torch.zeros(x.shape, dtype=y.dtype), _global_like(case),
                      local0)
    for coord, local in pieces:
        for dst, src in zip(_tree.leaves(_cut(whole, case, coord, mesh)), _tree.leaves(local)):
            dst.copy_(src)
    return whole


def _on_mesh(ranks, case):
    return [r["cases"][case["name"]] for r in ranks["ranks"] if case["name"] in r["cases"]]


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_equals_the_meshless_step(ranks, case):
    """Every rank's params and optimizer state are the meshless step's,
    cut to it, at rtol 1e-5 / atol 1e-6; under adafactor_like the rank's
    params are within twice the meshless float32 step's largest distance
    from the float64 step."""
    want = _meshless(case)
    got = _on_mesh(ranks, case)
    assert len(got) == (4 if case["mesh"] == "4x1" else WORLD)
    if case["opts"].get("optimizer") == "adafactor":
        exact = _meshless(case, torch.float64)
        for r in got:
            dist, own = 0.0, 0.0
            for a, b, w in zip(_tree.leaves(r["params"]),
                               _tree.leaves(_cut(want["params"], case, r["coord"])),
                               _tree.leaves(_cut(exact["params"], case, r["coord"]))):
                assert a.shape == b.shape
                dist = max(dist, (a.double() - w).abs().max().item())
                own = max(own, (b.double() - w).abs().max().item())
            assert dist <= 2 * own, (case["name"], dist, own)
        return
    for r in got:
        pairs = list(zip(_tree.leaves(r["params"]),
                         _tree.leaves(_cut(want["params"], case, r["coord"]))))
        pairs += list(zip(_tree.leaves(r["opt"]),
                          _tree.leaves(_cut(want["opt"], case, r["coord"]))))
        for a, b in pairs:
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_step_metrics_equal_the_meshless_ones(ranks, case):
    """Every rank reports the same metrics, those of the meshless step."""
    want = _meshless(case)["metrics"]
    got = [r["metrics"] for r in _on_mesh(ranks, case)]
    for m in got[1:]:
        assert torch.equal(m, got[0])
    torch.testing.assert_close(got[0], want, rtol=STATS_RTOL, atol=0.0)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_holds_its_cut_of_the_leaves(ranks, case):
    """A rank holds 1/k of every leaf the specs shard over 'model' (of its
    workers' rows), the rest whole: Mamba-2's heads or RG-LRU's channels."""
    wm = _wm_abstract(case["mesh"])
    k, n = wm.model_factor, wm.n_workers if case["mode"] == "gossip" else 1
    like = _global_like(case)
    flags = bus.sharded_leaf_flags(_specs(case), wm.model_axis,
                                   treedef=_tree.flatten(like)[1])
    assert any(flags) == (k > 1)
    cfg = _cfg(case["arch"])
    lead = () if case["mode"] == "allreduce" else (M // n,)
    for r in _on_mesh(ranks, case):
        local = r["params"]
        sharded = sum(x.numel() for x, f in zip(_tree.leaves(local), flags) if f)
        whole = sum(x.numel() for x, f in zip(_tree.leaves(local), flags) if not f)
        assert sharded * k * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if f)
        assert whole * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if not f)
        mix = local["segments"][0][0]["mix"]
        if cfg.arch_type == "ssm":
            H = cfg.ssm_nheads
            assert mix["dt_bias"].shape == lead + ((H // k,) if H % k == 0 else (H,))
        else:
            W = cfg.lru_width
            assert mix["wa"].shape == lead + (W // k, W)
            assert mix["lambda_p"].shape == lead + (W // k,)


@pytest.mark.parametrize("case", [c for c in CASES if c["backend"] == "fused"
                                  and c["mode"] == "gossip"], ids=lambda c: c["name"])
def test_the_fused_bus_mixes_the_ranks_share_of_the_rows(ranks, case):
    """Each step's gossip_mix call on a rank covers its workers' rows of
    the per-model-shard bus: about 1/k of a replica's rows."""
    wm = _wm_abstract(case["mesh"])
    k, m = wm.model_factor, M // wm.n_workers
    like = _global_like(case)
    flags = bus.sharded_leaf_flags(_specs(case), wm.model_axis,
                                   treedef=_tree.flatten(like)[1])
    for r in _on_mesh(ranks, case):
        planned = bus.plan_layout(r["params"], shards=k, leaf_sharded=flags).groups[0].rows
        whole = bus.plan_layout(like).groups[0].rows
        assert r["rows"] == [m * planned] * STEPS
        assert planned <= whole / k + bus.sublane_rows(torch.float32)


@pytest.mark.parametrize("case", REF_CASES, ids=[c["name"] for c in REF_CASES])
def test_each_rank_equals_the_reference_gspmd_step(ranks, case):
    """Params and metrics equal the reference's GSPMD step's at rtol 1e-5 /
    atol 1e-6."""
    ref = ranks["reference"]
    like = _global_like(case)
    keys = [case["name"] + "|" + "/".join(map(str, p)) for p, _ in _tree.flatten_with_path(like)]
    want = _tree.unflatten(_tree.flatten(like)[1], [torch.from_numpy(ref[k]) for k in keys])
    for r in _on_mesh(ranks, case):
        for a, b in zip(_tree.leaves(r["params"]), _tree.leaves(_cut(want, case, r["coord"]))):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(r["metrics"], torch.from_numpy(ref[case["name"] + "|metrics"]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mesh", ["4x2", "2x4"])
@pytest.mark.parametrize("fn", ["reduce_scatter", "all_gather"])
def test_the_collectives_carry_their_gradients_through_vmap(ranks, fn, mesh):
    """reduce_scatter_model and all_gather_model under vmap(grad_and_value)
    over 3 workers: the loss and x's gradient are the meshless ones, the
    weight's gradient its cut (all_gather_model: the ranks' partial
    cotangents summed; reduce_scatter_model: every rank's columns')."""
    W, x = _function_inputs()
    k = MESHES[mesh]["model"]
    loss = {"reduce_scatter": _reduce_scatter_loss, "all_gather": _all_gather_loss}[fn]
    (gw, gx), want = torch.func.vmap(torch.func.grad_and_value(
        lambda w, x: loss(w, x, 1, k), argnums=(0, 1)))(W, x)
    dim = -2 if fn == "reduce_scatter" else -1
    n = 16 // k
    for r in ranks["ranks"]:
        i = r["functions"][mesh]["index"]
        (g1, g2), got = r["functions"][mesh][fn]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g1, gw.narrow(dim, i * n, n), rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g2, gx, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# train() and its checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshless_loops(ranks, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshless")
    return {name: _single_thread(_run_loop, BY_NAME[c], str(tmp / name / "ck.npz"))
            for name, c in LOOPS}


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_train_on_the_model_axis_equals_meshless_train(ranks, meshless_loops, loop):
    name, case_name = loop
    want, case = meshless_loops[name], BY_NAME[case_name]
    got = [r["loops"][name] for r in ranks["ranks"]]
    for r, rk in zip(got, ranks["ranks"]):
        for a, b in zip(_tree.leaves(r["params"]),
                        _tree.leaves(_cut(want["params"], case, rk["coord"], "4x2"))):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert r["history"] == got[0]["history"]
    for field, values in got[0]["history"].items():
        np.testing.assert_allclose(values, want["history"][field], rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_checkpoint_files_equal_a_meshless_save_of_the_gathered_params(
        ranks, tmp_path, loop):
    name, case_name = loop
    case = BY_NAME[case_name]
    pieces = [(r["coord"], r["loops"][name]["params"]) for r in ranks["ranks"]]
    TC.save_sharded(str(tmp_path / "ck.npz"), _gathered(pieces, case, "4x2"), step=STEPS,
                    wmesh=_wm_abstract("4x2"))
    _same_files(os.path.join(ranks["dir"], name), str(tmp_path))


def test_restore_onto_the_model_axis_equals_the_ranks_params(ranks):
    """restore(wmesh=, param_specs=) of train()'s last sharded save gives
    each rank its cut (its heads) bit for bit."""
    for r in ranks["ranks"]:
        for a, b in zip(_tree.leaves(r["restored"]),
                        _tree.leaves(r["loops"]["train-mamba2"]["params"])):
            assert a.shape == b.shape and torch.equal(a, b)


def test_a_sharded_save_after_a_mesh_over_a_subset_of_the_ranks(tmp_path):
    """A (4, 1) mesh over ranks 0-3 made before a (4, 2) mesh over all 8
    and its first sharded save: the save's report group forms, the ranks
    end within 120 s (a 30 s collective timeout), and the meta lists every
    worker's shard."""
    _launch(tmp_path, "subset", 120)
    with open(tmp_path / "ck.meta.json") as f:
        assert json.load(f) == {"sharded": {"shards": [f"data{j}" for j in range(4)]},
                                "step": 1}
    for j in range(4):
        with np.load(tmp_path / f"ck.shard-data{j}.npz") as z:
            assert np.array_equal(z["w"], np.full((4,), float(j), np.float32))


# ---------------------------------------------------------------------------
# No ranks: the collectives at group size 1
# ---------------------------------------------------------------------------


@pytest.fixture
def world_of_one(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("fn", ["reduce_scatter", "all_gather"])
def test_the_collectives_at_group_size_one_are_the_identity(world_of_one, fn):
    """At group size 1 each collective and its backward are the identity
    under vmap(grad_and_value), bit for bit, the batch dim anywhere and the
    dim counted from either end."""
    gen = torch.Generator().manual_seed(1)
    w, x = torch.randn(16, 3, 16, generator=gen), torch.randn(3, 5, 16, generator=gen)
    op = {"reduce_scatter": tp.reduce_scatter_model, "all_gather": tp.all_gather_model}[fn]

    def loss(w, x, dim):
        return torch.sum(torch.tanh(op(x @ w, dim)) * torch.arange(16.0))

    want = torch.func.vmap(torch.func.grad_and_value(lambda w, x: torch.sum(
        torch.tanh(x @ w) * torch.arange(16.0)), argnums=(0, 1)), in_dims=(1, 0))(w, x)
    token = mesh_lib._MODEL.set(mesh_lib.ModelShard(world_of_one, 1, 0))
    try:
        for dim in (-1, 1):
            got = torch.func.vmap(torch.func.grad_and_value(lambda w, x: loss(w, x, dim),
                                                            argnums=(0, 1)),
                                  in_dims=(1, 0))(w, x)
            for a, b in zip(_tree.leaves(got), _tree.leaves(want)):
                assert torch.equal(a, b)
    finally:
        mesh_lib._MODEL.reset(token)


if __name__ == "__main__":
    {"rank": _rank_main, "subset": _subset_then_save}[sys.argv[1]](
        int(sys.argv[2]), sys.argv[3], sys.argv[4])
