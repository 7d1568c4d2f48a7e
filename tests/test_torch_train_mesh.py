"""Decentralized training over the worker axes of live gloo meshes on the CPU.

One launch of 8 ranks for the whole file (a ``FileStore`` in a temporary
directory): this file, run as a script, is one rank. Meshes: 4 × 1 (ranks
0–3; M = 4, one worker per rank, and M = 8, two), 8 × 1 and
``(pod, data) = (2, 4)`` with M = 8, all with model factor 1; a 4 × 2 mesh
for restores, which only cut, and for one step of every family on the model
axis (``tests/test_torch_train_tp.py`` and ``tests/test_torch_train_tp_moe.py``
hold them to oracles there). Models:
granite-3-2b and mixtral-8x7b (global MoE routing) at 2 layers and narrow
widths, float32, different random weights per worker from a numpy seed.

Step cases (``make_train_step(mesh=, param_specs=)``, two steps each): the
fused, ``ppermute``, ``allreduce`` and hierarchical backends,
``mix_first=False``, ``period=2``, one-peer time-varying, ``microbatch=2``,
``compute_stats`` off, ``adafactor_like``, and ``mode='allreduce'`` (with
``microbatch=2`` too, and mixtral routed per sequence, or over the whole
call, as by default, which routes over every rank's rows).
Loop cases (``train(mesh=, param_specs=)``): sharded
checkpoints through the asynchronous writer (WorkerMesh coordinates as
keys, and ``w{j}`` with a bare DeviceMesh), a monolithic checkpoint
streamed to the first rank, ``restore(wmesh=)`` and
``consensus_from_sharded(shardings=)`` on the 4 × 1 and the 4 × 2 mesh, a
reference-written checkpoint restored onto the mesh, and an async sharded
save whose last rank is held back (the meta waits for its shard).

Oracles:
* the port's meshless step (and ``train()``) on the global tree, run with
  one intra-op thread, cut to each rank by ``launch.shardings.local_tree``:
  bit-equal on the fused bus (ppermute/allreduce backends and allreduce
  mode: ``tests/test_bus.py``'s rtol 1e-5 / atol 1e-6, other summation
  orders); ``StepMetrics`` within rtol 1e-6 (their sums are all-reduced);
  every rank's History equal, and the checkpoint files' npz members equal
  the meshless run's byte for byte;
* the reference's own mesh step, in a subprocess with 8 forced host
  devices (as ``tests/test_bus.py`` runs its mesh tests), on its
  ``ppermute``/``allreduce`` backends and its allreduce mode (its fused bus
  does not trace under ``shard_map`` with this JAX): rtol 1e-5 / atol 1e-6.
"""
import json
import os
import subprocess
import sys
import time
import zipfile
from datetime import timedelta

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro_torch import _tree  # noqa: E402
from repro_torch import optim as O  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.decentralized import init_state, make_train_step  # noqa: E402
from repro_torch.core.gossip import GossipSpec  # noqa: E402
from repro_torch.launch import shardings as S  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, WorkerMesh, make_host_mesh  # noqa: E402
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.models.params import PartitionSpec as P  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import train  # noqa: E402

WORLD = 8
RTOL, ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-6
STEPS = 2
B, L = 4, 16                      # rows of 16 tokens per worker
LR = 0.05
LATE_S = 1.5                      # the held-back writer's delay
WIDTHS = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=256, param_dtype="float32", compute_dtype="float32")
ARCHS = {"granite": ("granite-3-2b", {}),
         "mixtral": ("mixtral-8x7b", {"d_ff_expert": 64}),
         "mixtral-seq": ("mixtral-8x7b", {"d_ff_expert": 64, "moe_dispatch": "per_sequence"})}
MESHES = {"4x1": dict(data=4, model=1), "8x1": dict(data=8, model=1),
          "2x4": dict(pod=2, data=4, model=1), "4x2": dict(data=4, model=2)}


def _cfg(arch: str):
    name, extra = ARCHS[arch]
    return get_config(name, reduced=True, **WIDTHS, **extra)


def _case(name, mesh, M, arch="granite", mode="gossip", backend="fused", topo="ring",
          ref=False, **opts):
    return dict(name=name, mesh=mesh, M=M, arch=arch, mode=mode, backend=backend,
                topo=topo, ref=ref, opts=opts)


CASES = [
    _case("4x1-m4-fused", "4x1", 4),
    _case("4x1-m4-ppermute", "4x1", 4, backend="ppermute", ref=True),
    _case("4x1-m4-allreduce", "4x1", 4, backend="allreduce", topo="clique", ref=True),
    _case("4x1-m4-adapt-then-combine", "4x1", 4, mix_first=False),
    _case("4x1-m4-period2", "4x1", 4, period=2),
    _case("4x1-m4-onepeer", "4x1", 4, time_varying="one_peer_exp"),
    _case("4x1-m4-microbatch2", "4x1", 4, microbatch=2),
    _case("4x1-m4-nostats", "4x1", 4, compute_stats=False),
    _case("4x1-m4-adafactor", "4x1", 4, optimizer="adafactor"),
    _case("4x1-m8-fused", "4x1", 8),
    _case("8x1-m8-fused", "8x1", 8),
    _case("2x4-m8-hier", "2x4", 8, topo="hier", hierarchical=True),
    _case("2x4-m8-ppermute", "2x4", 8, backend="ppermute", ref=True),
    _case("2x4-m8-adafactor", "2x4", 8, optimizer="adafactor"),
    _case("4x1-m4-mixtral-fused", "4x1", 4, arch="mixtral"),
    _case("4x1-m4-mixtral-ppermute", "4x1", 4, arch="mixtral", backend="ppermute", ref=True),
    _case("4x1-allreduce-mode", "4x1", 4, mode="allreduce", ref=True),
    _case("4x1-allreduce-mode-microbatch2", "4x1", 4, mode="allreduce", ref=True,
          microbatch=2),
    _case("2x4-allreduce-mode", "2x4", 8, mode="allreduce", ref=True),
    # routed per sequence, the MoE's loss is a mean over rows: the batch cut
    # is exact (routed over the whole call it refuses, below)
    _case("4x1-allreduce-mode-mixtral-per-sequence", "4x1", 4, arch="mixtral-seq",
          mode="allreduce", ref=True),
]
BY_NAME = {c["name"]: c for c in CASES}
# the train() cases: (name, mesh argument, checkpoint kind, mode)
LOOPS = [("train-sharded", "wm", "sharded", "gossip"),
         ("train-monolithic", "wm", "monolithic", "gossip"),
         ("train-sharded-devicemesh", "raw", "sharded", "gossip"),
         ("train-allreduce", "wm", "monolithic", "allreduce")]


# ---------------------------------------------------------------------------
# Inputs, from numpy seeds; the same on every rank and in the oracles
# ---------------------------------------------------------------------------


def _weights(defs, M: int, seed: int, tree_map):
    """Different weights per worker: every leaf (M, *shape), float32, drawn
    in the trees' common leaf order."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        x = 0.05 * rng.normal(size=(M,) + tuple(d.shape))
        return (x + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)

    return tree_map(leaf, defs)


def _tokens(case) -> np.ndarray:
    """(STEPS, M, B, L) token ids (allreduce mode: rows reshape to M·B)."""
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, size=(STEPS, case["M"], B, L)).astype(np.int64)


def _inputs(case):
    cfg = _cfg(case["arch"])
    params = _tree.map(torch.from_numpy, _weights(Mo.model_defs(cfg), case["M"], 3, _tree.map))
    toks = torch.from_numpy(_tokens(case))
    if case["mode"] == "allreduce":
        params = _tree.map(lambda x: x[0].clone(), params)
        toks = toks.reshape(STEPS, -1, L)
    return cfg, params, [{"tokens": toks[k]} for k in range(STEPS)]


def _topology(case):
    M = case["M"]
    return TT.hier(2, M // 2) if case["topo"] == "hier" else TT.make(case["topo"], M)


def _optimizer(case):
    if case["opts"].get("optimizer") == "adafactor":
        return O.adafactor_like(LR)
    return O.momentum_sgd(LR, 0.9)


def _param_specs(cfg, wm, mode):
    return S.param_pspecs(cfg, wm, mode)


def _run_step_case(case, wm=None):
    """Two steps of ``make_train_step``; on a mesh from this rank's cut of
    the global inputs. Returns the final params, opt state and metrics."""
    cfg, params, batches = _inputs(case)
    opts = dict(case["opts"])
    opts.pop("optimizer", None)
    spec_kw = {k: opts.pop(k) for k in ("period", "time_varying", "hierarchical") if k in opts}
    opt = _optimizer(case)
    gossip = GossipSpec(topology=_topology(case), backend=case["backend"], **spec_kw) \
        if case["mode"] == "gossip" else None
    specs = None
    if wm is not None:
        specs = _param_specs(cfg, wm, case["mode"])
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


# mixtral routed over the whole call in allreduce mode: its rows cut over
# the 4 × 1 mesh's ranks
MOE_GLOBAL = dict(BY_NAME["4x1-allreduce-mode"], arch="mixtral",
                  name="4x1-allreduce-mode-moe")


def _moe_train(mesh=None):
    """train() of MOE_GLOBAL: its final params and losses."""
    cfg, single, rows = _inputs(MOE_GLOBAL)
    state, hist = train(lambda p, b: Mo.loss_fn(p, cfg, b), single, O.momentum_sgd(LR, 0.9),
                        iter(rows), steps=STEPS, mode="allreduce", mesh=mesh, log_every=1,
                        device="cpu", verbose=False)
    return {"params": state.params, "loss": hist.loss}


def _batches(case):
    _, _, batches = _inputs(case)
    return iter(batches)


def _run_loop(ckpt_kind, path, mesh=None, mode="gossip"):
    """train() of a 4 × 1 case, checkpointing after every step."""
    case = BY_NAME["4x1-m4-fused" if mode == "gossip" else "4x1-allreduce-mode"]
    cfg, params, batches = _inputs(case)
    wm = WorkerMesh.ensure(mesh)
    specs = None if wm is None else _param_specs(cfg, wm, mode)
    gossip = GossipSpec(topology=_topology(case), backend="fused") if mode == "gossip" else None
    state, hist = train(lambda p, b: Mo.loss_fn(p, cfg, b), params, O.momentum_sgd(LR, 0.9),
                        iter(batches), steps=STEPS, gossip=gossip, mode=mode,
                        mesh=mesh, param_specs=specs, log_every=1, ckpt_path=path,
                        ckpt_every=1, ckpt_sharded=ckpt_kind == "sharded", device="cpu",
                        verbose=False)
    fields = ("loss", "grad_energy", "grad_spread", "mean_grad_norm", "param_spread")
    return {"params": state.params, "history": {f: getattr(hist, f) for f in fields}}


def _global_like(case, single=False):
    cfg = _cfg(case["arch"])
    lead = () if single else (case["M"],)
    return _tree.map(lambda d: torch.empty(lead + tuple(d.shape), device="meta"),
                     Mo.model_defs(cfg))


# configs tried at model factor 2: every family takes a finite step
MODEL_AXIS_ARCHS = ("granite-3-2b", "mixtral-8x7b", "deepseek-v2-lite-16b", "mamba2-2.7b",
                    "recurrentgemma-2b", "seamless-m4t-large-v2")


def _model_axis_step(name: str, wm):
    """One step of ``name``'s reduced config on the 4 × 2 mesh (the rank's
    cut of 4 workers): None if it ran with a finite loss, else the
    NotImplementedError's message."""
    cfg = get_config(name, reduced=True)
    params = _tree.map(torch.from_numpy, _weights(Mo.model_defs(cfg), 4, 3, _tree.map))
    specs = _param_specs(cfg, wm, "gossip")
    toks = torch.from_numpy(_tokens(BY_NAME["4x1-m4-fused"])[0] % cfg.vocab_size)
    batch = {"tokens": toks}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.zeros(4, B, 8, cfg.d_model)
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), O.momentum_sgd(LR, 0.9),
                           gossip=GossipSpec(topology=TT.make("ring", 4)), mesh=wm,
                           param_specs=specs)
    state = init_state(S.local_tree(params, specs, wm), O.momentum_sgd(LR, 0.9))
    try:
        _, metrics = step(state, S.local_tree(batch, _tree.map(lambda _: wm.worker_spec(),
                                                               batch), wm))
    except NotImplementedError as e:
        return str(e)
    assert torch.isfinite(metrics.loss)
    return None


def _wm_abstract(name: str) -> WorkerMesh:
    kw = MESHES[name]
    if "pod" in kw:
        return WorkerMesh.from_mesh(AbstractMesh((kw["pod"], kw["data"], kw["model"]),
                                                 ("pod", "data", "model")))
    return WorkerMesh.from_mesh(AbstractMesh((kw["data"], kw["model"]), ("data", "model")))


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    dms = {name: make_host_mesh(**kw, device="cpu") for name, kw in MESHES.items()}
    wms = {name: WorkerMesh.from_mesh(dm) for name, dm in dms.items()}
    out = {"cases": {}, "loops": {}, "refusals": {}, "restored": {}}
    for case in CASES:
        wm = wms[case["mesh"]]
        if dms[case["mesh"]].get_coordinate() is None:
            continue
        out["cases"][case["name"]] = {"coord": wm.coordinate, **_run_step_case(case, wm)}

    # allreduce mode cuts the rows over the ranks: an MoE layer routing the
    # whole call routes over every rank's rows, in the step and in train()
    out["moe_global"] = {}
    if dms["4x1"].get_coordinate() is not None:
        out["moe_global"] = {"step": _run_step_case(MOE_GLOBAL, wms["4x1"]),
                             "train": _moe_train(wms["4x1"])}

    # train() on the 4 × 1 mesh; the async writer's snapshots recorded
    snaps = []
    real = TC._sharded_writes

    def spy(path, tree, step, wmesh):
        snaps.append([(tuple(x.shape), x.device.type) for x in _tree.leaves(tree)])
        return real(path, tree, step, wmesh)

    TC._sharded_writes = spy
    case = BY_NAME["4x1-m4-fused"]
    for name, which, kind, mode in LOOPS:
        if dms["4x1"].get_coordinate() is None:
            continue
        mesh = wms["4x1"] if which == "wm" else dms["4x1"]
        snaps.clear()
        got = _run_loop(kind, os.path.join(out_dir, name, "ck.npz"), mesh, mode)
        out["loops"][name] = {"coord": wms["4x1"].coordinate, "snapshots": list(snaps), **got}
    TC._sharded_writes = real

    # the meta of an async sharded save waits for every rank's shards: the
    # last rank's writer is held back before it writes its own
    if dms["4x1"].get_coordinate() is not None:
        wm = wms["4x1"]
        path = os.path.join(out_dir, "late", "ck")
        write = TC._write_npz

        def late(p, arrays):
            if wm.worker_index == 3:
                time.sleep(LATE_S)
            write(p, arrays)

        TC._write_npz = late
        with TC.AsyncCheckpointWriter() as w:
            params = _inputs(case)[1]
            w.save(path, S.local_tree(params, _tree.map(lambda _: wm.worker_spec(), params), wm),
                   step=1, wmesh=wm)
        TC._write_npz = write
        # the first rank's writer has written the meta: the late shard is there
        out["late_shard_seen"] = os.path.exists(path + ".shard-data3.npz")
    dist.barrier()

    # restores: the 4 × 1 run's sharded checkpoint on both meshes, cut by
    # the specs; a reference-written one on the 4 × 1 mesh
    cfg = _cfg("granite")
    for mesh_name in ("4x1", "4x2"):
        if dms[mesh_name].get_coordinate() is None:
            continue
        wm = wms[mesh_name]
        path = os.path.join(out_dir, "train-sharded", "ck.npz")
        got = {"coord": wm.coordinate,
               "params": TC.restore(path, _global_like(case), device="cpu", wmesh=wm,
                                    param_specs=_param_specs(cfg, wm, "gossip")),
               "consensus": TC.consensus_from_sharded(
                   path, _global_like(case, single=True), device="cpu",
                   shardings=(_param_specs(cfg, wm, "allreduce"), wm))}
        if mesh_name == "4x1":
            got["reference"] = TC.restore(os.path.join(out_dir, "jax", "ck.npz"),
                                          _global_like(case), device="cpu", wmesh=wm)
            got["monolithic"] = TC.restore(os.path.join(out_dir, "train-monolithic", "ck.npz"),
                                           _global_like(case), device="cpu", wmesh=wm)
        out["restored"][mesh_name] = got

    # the model axis: every family takes a finite step on it
    wm = wms["4x2"]
    for name in MODEL_AXIS_ARCHS:
        out["refusals"][name] = _model_axis_step(name, wm)
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
from test_torch_train_mesh import ARCHS, WIDTHS, LR, L, _weights, _tokens, MESHES

cases, out = json.loads(sys.argv[1]), {}
for c in cases:
    name, extra = ARCHS[c["arch"]]
    cfg = get_config(name, reduced=True, **WIDTHS, **extra)
    wm = WorkerMesh.from_mesh(make_host_mesh(**MESHES[c["mesh"]]))
    params = _weights(Mo.model_defs(cfg), c["M"], 3, jax.tree.map)
    toks = _tokens(c)
    opt = optim.momentum_sgd(LR, 0.9)
    opts = dict(c["opts"])
    with compat.set_mesh(wm.mesh):
        if c["mode"] == "gossip":
            specs = S.param_pspecs(cfg, wm, "gossip")
            bspec = P(wm.wa, None, None)
            gossip = GossipSpec.for_mesh(T.make(c["topo"], c["M"]), wm, backend=c["backend"])
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


def _reference_inputs(tmp) -> tuple[list, str]:
    """The reference cases and the checkpoint the reference writes for the
    restore case (the 4 × 1 loop's initial params, sharded by its own
    WorkerMesh, so the files are keyed 'data0'...)."""
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.launch.mesh import WorkerMesh as JWorkerMesh
    from repro.train import checkpoint as JC

    case = BY_NAME["4x1-m4-fused"]
    _, params, _ = _inputs(case)
    jwm = JWorkerMesh.from_mesh(JAbstractMesh((4, 1), ("data", "model")))
    JC.save_sharded(os.path.join(tmp, "jax", "ck.npz"), _tree.map(lambda x: x.numpy(), params),
                    step=0, wmesh=jwm)
    return [c for c in CASES if c["ref"]], os.path.join(tmp, "reference.npz")


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
    cases, ref_path = _reference_inputs(str(tmp))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r),
                               str(tmp / "store"), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    procs.append(subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(cases), ref_path,
                                   here], env=jenv, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT))
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
# The meshless oracle (one intra-op thread)
# ---------------------------------------------------------------------------


def _single_thread(fn, *args):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(n)


_ORACLE: dict = {}


def _meshless(case):
    if case["name"] not in _ORACLE:
        _ORACLE[case["name"]] = _single_thread(_run_step_case, case)
    return _ORACLE[case["name"]]


def _exact(case) -> bool:
    return case["mode"] == "gossip" and case["backend"] == "fused"


def _ranks_of(ranks, key, name):
    return [r[key][name] for r in ranks["ranks"] if name in r[key]]


def _cut(tree, case, mesh_name, coord, specs=None):
    wm = _wm_abstract(mesh_name)
    if specs is None:
        specs = _param_specs(_cfg(case["arch"]), wm, case["mode"])
    return S.local_tree(tree, specs, wm, coordinate=coord)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_equals_the_meshless_step(ranks, case):
    want = _meshless(case)
    got = _ranks_of(ranks, "cases", case["name"])
    wm = _wm_abstract(case["mesh"])
    assert len(got) == wm.n_workers * wm.model_factor
    for r in got:
        pairs = list(zip(_tree.leaves(r["params"]),
                         _tree.leaves(_cut(want["params"], case, case["mesh"], r["coord"]))))
        if not case["opts"].get("optimizer"):
            pairs += list(zip(_tree.leaves(r["opt"]),
                              _tree.leaves(_cut(want["opt"], case, case["mesh"], r["coord"]))))
        for a, b in pairs:
            assert a.shape == b.shape
            if _exact(case):
                assert torch.equal(a, b), case["name"]
            else:
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_step_metrics_are_global_and_equal_the_meshless_ones(ranks, case):
    """Every rank reports the same metrics, those of all M workers."""
    want = _meshless(case)["metrics"]
    got = [r["metrics"] for r in _ranks_of(ranks, "cases", case["name"])]
    for m in got[1:]:
        assert torch.equal(m, got[0])
    if case["opts"].get("compute_stats") is False:
        assert not got[0][:, 1:].any()
    rtol, atol = (STATS_RTOL, 0.0) if _exact(case) else (RTOL, ATOL)
    torch.testing.assert_close(got[0], want, rtol=rtol, atol=atol)


REF_CASES = [c for c in CASES if c["ref"]]


@pytest.mark.parametrize("case", REF_CASES, ids=[c["name"] for c in REF_CASES])
def test_each_rank_equals_the_reference_mesh_step(ranks, case):
    ref = ranks["reference"]
    like = _global_like(case, single=case["mode"] == "allreduce")
    keys = [case["name"] + "|" + "/".join(map(str, p)) for p, _ in _tree.flatten_with_path(like)]
    want = _tree.unflatten(_tree.flatten(like)[1], [torch.from_numpy(ref[k]) for k in keys])
    for r in _ranks_of(ranks, "cases", case["name"]):
        cut = _cut(want, case, case["mesh"], r["coord"])
        for a, b in zip(_tree.leaves(r["params"]), _tree.leaves(cut)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(r["metrics"], torch.from_numpy(ref[case["name"] + "|metrics"]),
                                   rtol=RTOL, atol=ATOL)


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


@pytest.fixture(scope="module")
def meshless_loops(ranks, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshless")
    return {name: (_single_thread(_run_loop, kind, str(tmp / name / "ck.npz"), None, mode),
                   str(tmp / name))
            for name, _, kind, mode in LOOPS}


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_train_on_the_mesh_equals_meshless_train(ranks, meshless_loops, loop):
    """The rank's final params are the meshless train()'s cut, bit for bit
    in gossip mode (allreduce mode: its all-reduced gradient sums in
    another order); every rank's History is the same, within rtol 1e-6 of
    the meshless one."""
    name, _, _, mode = loop
    (want, _), case = meshless_loops[name], BY_NAME["4x1-m4-fused"]
    if mode == "allreduce":
        case = BY_NAME["4x1-allreduce-mode"]
    got = _ranks_of(ranks, "loops", name)
    assert len(got) == 4
    for r in got:
        for a, b in zip(_tree.leaves(r["params"]),
                        _tree.leaves(_cut(want["params"], case, "4x1", r["coord"]))):
            if mode == "gossip":
                assert torch.equal(a, b)
            else:
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert r["history"] == got[0]["history"]
    for field, values in got[0]["history"].items():
        np.testing.assert_allclose(values, want["history"][field],
                                   rtol=STATS_RTOL if mode == "gossip" else RTOL, atol=0)


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_mesh_checkpoint_files_equal_the_meshless_ones(ranks, meshless_loops, loop):
    """The same files as the meshless train() (a WorkerMesh names the
    shards by its coordinates, which the meshless run calls w{j}), member
    for member, byte for byte; each async snapshot held only the rank's own
    worker, on the host. In allreduce mode the first rank writes its
    replica, which restores to every rank's params bit for bit."""
    name, which, kind, mode = loop
    _, want_dir = meshless_loops[name]
    got_dir = os.path.join(ranks["dir"], name)
    rename = {f"w{j}": f"data{j}" for j in range(4)} if which == "wm" else {}

    def mapped(f):
        for old, new in rename.items():
            f = f.replace(f"shard-{old}.", f"shard-{new}.")
        return f

    want_files = sorted(os.listdir(want_dir))
    assert sorted(os.listdir(got_dir)) == sorted(mapped(f) for f in want_files)
    got = _ranks_of(ranks, "loops", name)
    if mode == "allreduce":
        back = TC.restore(os.path.join(got_dir, "ck.npz"), got[0]["params"], device="cpu")
        for r in got:
            for a, b in zip(_tree.leaves(back), _tree.leaves(r["params"])):
                assert torch.equal(a, b)
        return
    for f in want_files:
        a, b = _members(os.path.join(got_dir, mapped(f))), _members(os.path.join(want_dir, f))
        if f.endswith(".meta.json"):
            a, b = json.loads(a), json.loads(b)
            if "sharded" in b:
                b["sharded"]["shards"] = [rename.get(s, s) for s in b["sharded"]["shards"]]
        assert a == b, f
    for r in got:
        snaps = r["snapshots"]
        # a save after every step, and the loop's last one
        assert len(snaps) == (STEPS + 1 if kind == "sharded" else 0)
        local = [(tuple(x.shape), "cpu") for x in _tree.leaves(r["params"])]
        assert all(s == local and s[0][0][0] == 1 for s in snaps)


def test_restore_and_consensus_cut_to_the_rank_at_any_model_factor(ranks, meshless_loops):
    """The sharded checkpoint restores onto the 4 × 1 and the 4 × 2 mesh
    (each rank its own workers' files, then its model piece), and its
    consensus lands as the rank's piece; a monolithic checkpoint and one
    the reference wrote restore onto the 4 × 1 mesh."""
    (want, _), case = meshless_loops["train-sharded"], BY_NAME["4x1-m4-fused"]
    cfg = _cfg("granite")
    consensus = TC.consensus_params(want["params"])
    _, params0, _ = _inputs(case)
    seen = 0
    for r in ranks["ranks"]:
        for mesh_name, got in r["restored"].items():
            seen += 1
            wm = _wm_abstract(mesh_name)
            cut = _cut(want["params"], case, mesh_name, got["coord"],
                       _param_specs(cfg, wm, "gossip"))
            for a, b in zip(_tree.leaves(got["params"]), _tree.leaves(cut)):
                assert torch.equal(a, b)
            piece = _cut(consensus, case, mesh_name, got["coord"],
                         _param_specs(cfg, wm, "allreduce"))
            for a, b in zip(_tree.leaves(got["consensus"]), _tree.leaves(piece)):
                assert a.shape == b.shape and torch.equal(a, b)
            if mesh_name == "4x1":
                for tree, ref in ((got["reference"], params0), (got["monolithic"], want["params"])):
                    for a, b in zip(_tree.leaves(tree), _tree.leaves(
                            _cut(ref, case, "4x1", got["coord"], _tree.map(
                                lambda _: P("data"), ref)))):
                        assert torch.equal(a, b)
    assert seen == 4 + 8


def test_allreduce_mode_refuses_a_globally_routed_moe_on_a_mesh(ranks):
    """With the rows cut over the 4 × 1 mesh's ranks, an MoE layer routing
    the whole call (capacity, dropped tokens and the aux loss over all its
    tokens) no longer refuses: it routes over every rank's rows, so the
    step and train() equal the meshless whole-batch step and train() at
    rtol 1e-5 / atol 1e-6, loss and metrics included."""
    want_step = _meshless(MOE_GLOBAL)
    want_train = _single_thread(_moe_train)
    got = [r["moe_global"] for r in ranks["ranks"] if r["moe_global"]]
    assert len(got) == 4
    for r in got:
        for what, want in (("step", want_step), ("train", want_train)):
            for a, b in zip(_tree.leaves(r[what]["params"]), _tree.leaves(want["params"])):
                torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(r["step"]["metrics"], want_step["metrics"],
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(r["train"]["loss"], want_train["loss"], rtol=RTOL)


def test_the_meta_waits_for_every_ranks_shards(ranks):
    """The async sharded save's meta comes after the last rank's shard,
    whose writer was held back: the first rank found the shard on disk
    when its writer was done, and the meta is not older than it."""
    seen = [r["late_shard_seen"] for r in ranks["ranks"] if "late_shard_seen" in r]
    assert seen == [True] * 4
    base = os.path.join(ranks["dir"], "late", "ck")
    shard, meta = os.stat(base + ".shard-data3.npz"), os.stat(base + ".meta.json")
    assert meta.st_mtime_ns >= shard.st_mtime_ns
    with open(base + ".meta.json") as f:
        assert json.load(f) == {"sharded": {"shards": [f"data{j}" for j in range(4)]},
                                "step": 1}


def test_model_axis_is_refused_naming_the_tensor_parallel_step(ranks):
    """Every family takes a finite step at model factor 2, refusing
    nothing: granite (a dense decoder), mixtral (MoE), deepseek-v2-lite
    (MLA and MoE), mamba2 (Mamba-2), recurrentgemma (RG-LRU and local
    attention) and seamless (the encoder-decoder)."""
    for r in ranks["ranks"]:
        assert set(r["refusals"]) == set(MODEL_AXIS_ARCHS)
        for name in MODEL_AXIS_ARCHS:
            assert r["refusals"][name] is None, (name, r["refusals"][name])


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
