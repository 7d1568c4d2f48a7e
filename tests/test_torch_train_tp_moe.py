"""Tensor-parallel training of MoE, MLA and the encoder-decoder over the
model axis of live gloo meshes on the CPU, and the globally routed MoE
with its rows cut over the worker groups.

One launch of 8 ranks for the whole file (a ``FileStore`` in a temporary
directory): this file, run as a script, is one rank. Meshes: (data=4,
model=2) and (data=2, model=4) over all 8 ranks, M = 4 workers, and
(data=4, model=1) over ranks 0–3 for allreduce mode. Models at 2 layers
and narrow widths, float32, different random weights per worker from a
numpy seed, 8 heads so that every k here divides them:

* mixtral-8x7b with 8 experts, top-2: the experts cut over the model axis
  (2 or 4 per rank); with 6 experts at k = 4 they do not divide, and their
  ``expert_ff`` columns are cut instead, the router replicated; routed
  over the whole call (``moe_dispatch='global'``) and per sequence; with
  ``remat``;
* deepseek-v2-lite-16b: MLA over the rank's heads, its dense first layer,
  8 routed experts top-3 and 2 shared experts (their ``ff`` columns cut);
  in allreduce mode also with ``moe_shard='capacity'``, whose specs keep
  the routed experts replicated while the shared experts' columns are cut;
* seamless-m4t-large-v2 with frames in the batch: the encoder's layers and
  every decoder layer's cross-attention over the memory; its 8 kv heads cut,
  or 2 kv heads replicated at k = 4.

Step cases (``make_train_step(mesh=, param_specs=)``, two steps each) on
the fused bus and ``ppermute``, ``adafactor_like`` (an expert-sharded
leaf's statistics), and ``mode='allreduce'`` with global routing (the
rows cut over the worker groups, a router aux coefficient of 1 so that
its gradient's scale shows). Loop cases (``train(mesh=, param_specs=)`` on
(4, 2)): gossip with sharded checkpoints through the asynchronous writer,
allreduce mode with a monolithic one; and a synchronous ``save_sharded``.

Oracles, as ``tests/test_torch_train_tp.py``'s: the port's meshless step
(and ``train()``) on the global tree, one intra-op thread, cut to each
rank, at rtol 1e-5 / atol 1e-6 (``adafactor_like``: the float64 witness
rule); the reference's own GSPMD step in a subprocess with 8 host devices,
at the same tolerance, its allreduce mode on the global batch; the
checkpoint files member for member a meshless save's.
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
from repro_torch.models import layers as Ly  # noqa: E402
from repro_torch.models import model as Mo  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import train  # noqa: E402

WORLD = 8
RTOL, ATOL = 1e-5, 1e-6
STATS_RTOL = 1e-6
STEPS = 2
M = 4
B, L, FRAMES = 4, 16, 8           # rows of 16 tokens per worker; 8 frames per row
LR = 0.05
WIDTHS = dict(n_layers=2, d_model=64, n_heads=8, head_dim=8, d_ff=128, vocab_size=256,
              param_dtype="float32", compute_dtype="float32")
MIXTRAL = dict(n_kv_heads=2, n_experts=8, top_k=2, d_ff_expert=32)
DEEPSEEK = dict(n_kv_heads=8, n_experts=8, top_k=3, d_ff_expert=32, n_shared_experts=2)
ARCHS = {"mixtral": ("mixtral-8x7b", MIXTRAL),
         "mixtral-seq": ("mixtral-8x7b", dict(MIXTRAL, moe_dispatch="per_sequence")),
         "mixtral-remat": ("mixtral-8x7b", dict(MIXTRAL, remat=True)),
         "mixtral-e6": ("mixtral-8x7b", dict(MIXTRAL, n_experts=6)),
         "mixtral-aux": ("mixtral-8x7b", dict(MIXTRAL, router_aux_coef=1.0)),
         "mixtral-aux-quarter": ("mixtral-8x7b", dict(MIXTRAL, router_aux_coef=0.25)),
         "deepseek": ("deepseek-v2-lite-16b", DEEPSEEK),
         "deepseek-seq": ("deepseek-v2-lite-16b", dict(DEEPSEEK, moe_dispatch="per_sequence")),
         "deepseek-aux": ("deepseek-v2-lite-16b", dict(DEEPSEEK, router_aux_coef=1.0)),
         "deepseek-capacity": ("deepseek-v2-lite-16b",
                               dict(DEEPSEEK, router_aux_coef=1.0, moe_shard="capacity")),
         "seamless": ("seamless-m4t-large-v2", dict(n_kv_heads=8)),
         "seamless-kv2": ("seamless-m4t-large-v2", dict(n_kv_heads=2))}
MESHES = {"4x2": dict(data=4, model=2), "2x4": dict(data=2, model=4),
          "4x1": dict(data=4, model=1)}


def _cfg(arch: str):
    name, extra = ARCHS[arch]
    return get_config(name, reduced=True, **{**WIDTHS, **extra})


def _case(name, mesh, arch, mode="gossip", backend="fused", ref=False, **opts):
    return dict(name=name, mesh=mesh, arch=arch, mode=mode, backend=backend, ref=ref,
                opts=opts)


CASES = [
    _case("4x2-mixtral-fused", "4x2", "mixtral"),
    _case("4x2-mixtral-ppermute", "4x2", "mixtral", backend="ppermute", ref=True),
    _case("4x2-mixtral-per-sequence", "4x2", "mixtral-seq"),
    _case("4x2-mixtral-remat", "4x2", "mixtral-remat"),
    _case("4x2-mixtral-adafactor", "4x2", "mixtral", optimizer="adafactor"),
    _case("2x4-mixtral-fused", "2x4", "mixtral"),
    _case("2x4-mixtral-e6-expert-ff", "2x4", "mixtral-e6"),
    _case("4x2-mixtral-e6-fused", "4x2", "mixtral-e6"),
    _case("4x2-deepseek-fused", "4x2", "deepseek"),
    _case("4x2-deepseek-ppermute", "4x2", "deepseek", backend="ppermute", ref=True),
    _case("2x4-deepseek-fused", "2x4", "deepseek"),
    _case("2x4-deepseek-per-sequence", "2x4", "deepseek-seq"),
    _case("4x2-seamless-fused", "4x2", "seamless"),
    _case("4x2-seamless-ppermute", "4x2", "seamless", backend="ppermute", ref=True),
    _case("2x4-seamless-kv2-fused", "2x4", "seamless-kv2"),
    _case("4x1-allreduce-mode-mixtral", "4x1", "mixtral-aux", mode="allreduce", ref=True),
    _case("4x2-allreduce-mode-mixtral", "4x2", "mixtral-aux", mode="allreduce", ref=True),
    _case("2x4-allreduce-mode-deepseek", "2x4", "deepseek-aux", mode="allreduce"),
    _case("2x4-allreduce-mode-deepseek-capacity", "2x4", "deepseek-capacity",
          mode="allreduce", ref=True),
    _case("4x2-allreduce-mode-seamless", "4x2", "seamless", mode="allreduce"),
]
BY_NAME = {c["name"]: c for c in CASES}
REF_CASES = [c for c in CASES if c["ref"]]
# the train() cases on (4, 2): (name, case, checkpoint kind)
LOOPS = [("train-sharded", "4x2-deepseek-fused", "sharded"),
         ("train-allreduce", "4x2-allreduce-mode-mixtral", "monolithic")]


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


def _batches_np(arch: str) -> dict:
    """(STEPS, M, B, L) token ids and, for the encoder-decoder, (STEPS, M,
    B, FRAMES, D) frames (allreduce mode: rows reshape to M·B)."""
    rng = np.random.default_rng(7)
    out = {"tokens": rng.integers(0, 256, size=(STEPS, M, B, L)).astype(np.int64)}
    cfg = _cfg(arch)
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.normal(size=(STEPS, M, B, FRAMES, cfg.d_model)).astype(
            np.float32)
    return out


def _inputs(case, dtype=torch.float32):
    cfg = _cfg(case["arch"])
    if dtype == torch.float64:
        cfg = dataclasses.replace(cfg, param_dtype="float64", compute_dtype="float64")
    params = _tree.map(lambda x: torch.from_numpy(x).to(dtype),
                       _weights(Mo.model_defs(cfg), 3, _tree.map))
    data = {k: torch.from_numpy(v) for k, v in _batches_np(case["arch"]).items()}
    data["enc_embeds"] = data["enc_embeds"].to(dtype) if "enc_embeds" in data else None
    if case["mode"] == "allreduce":
        params = _tree.map(lambda x: x[0].clone(), params)
        data = {k: None if v is None else v.reshape((STEPS, M * B) + v.shape[3:])
                for k, v in data.items()}
    batches = [{k: v[s] for k, v in data.items() if v is not None} for s in range(STEPS)]
    return cfg, params, batches


def _run_step_case(case, wm=None, dtype=torch.float32):
    cfg, params, batches = _inputs(case, dtype)
    opts = dict(case["opts"])
    opt = O.adafactor_like(LR) if opts.pop("optimizer", None) == "adafactor" \
        else O.momentum_sgd(LR, 0.9)
    gossip = None
    if case["mode"] == "gossip":
        gossip = GossipSpec(topology=TT.make("ring", M), backend=case["backend"]) \
            if wm is None else GossipSpec.for_mesh(TT.make("ring", M), wm,
                                                   backend=case["backend"])
    specs = None
    if wm is not None:
        specs = S.param_pspecs(cfg, wm, case["mode"])
        params = S.local_tree(params, specs, wm)
        batches = [S.local_tree(b, _tree.map(lambda _: wm.worker_spec(), b), wm)
                   for b in batches]
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt, gossip=gossip,
                           mode=case["mode"], mesh=wm, param_specs=specs, **opts)
    state = init_state(_tree.map(torch.clone, params), opt)
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(torch.stack([f.float() for f in m]))
    return {"params": state.params, "opt": state.opt_state, "metrics": torch.stack(metrics)}


def _run_loop(case, ckpt_kind, path, mesh=None):
    cfg, params, batches = _inputs(case)
    wm = WorkerMesh.ensure(mesh)
    mode = case["mode"]
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
    return WorkerMesh.from_mesh(AbstractMesh((kw["data"], kw["model"]), ("data", "model")))


def _gather_function(wm):
    """gather_from_model of this rank's columns under vmap(grad_and_value)
    over 3 stacked workers: (loss, grads of the rank's columns)."""
    gen = torch.Generator().manual_seed(0)
    W, x = torch.randn(3, 8, 16, generator=gen), torch.randn(3, 5, 8, generator=gen)
    k, r = wm.model_factor, wm.model_index
    w = W[..., r * 16 // k:(r + 1) * 16 // k].contiguous()

    def loss(w, x):
        z = tp.gather_from_model(tp.copy_to_model(x) @ w, -1)
        return torch.sum(torch.softmax(z, -1) * torch.arange(16.0))

    with mesh_lib.model_parallel(wm):
        return torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1)))(w, x)


# ---------------------------------------------------------------------------
# One rank
# ---------------------------------------------------------------------------


def _rank_main(rank: int, store_path: str, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=120))
    # the (4, 1) mesh over ranks 0-3 comes last (tests/test_torch_train_tp_recurrent.py
    # makes its own first, before its sharded saves)
    dms = {name: make_host_mesh(**MESHES[name], device="cpu") for name in ("4x2", "2x4")}
    wms = {name: WorkerMesh.from_mesh(dm) for name, dm in dms.items()}
    out = {"cases": {}, "loops": {}, "coord": wms["4x2"].coordinate,
           "gather": _gather_function(wms["4x2"])}
    for name, case_name, kind in LOOPS:
        out["loops"][name] = _run_loop(BY_NAME[case_name], kind,
                                       os.path.join(out_dir, name, "ck.npz"), wms["4x2"])
    # the sharded checkpoint restored onto the mesh: the rank's cut, experts included
    case = BY_NAME["4x2-deepseek-fused"]
    out["restored"] = TC.restore(os.path.join(out_dir, "train-sharded", "ck.npz"),
                                 _global_like(case), device="cpu", wmesh=wms["4x2"],
                                 param_specs=S.param_pspecs(_cfg(case["arch"]), wms["4x2"],
                                                            "gossip"))
    dms["4x1"] = make_host_mesh(**MESHES["4x1"], device="cpu")
    wms["4x1"] = WorkerMesh.from_mesh(dms["4x1"])

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

    # microbatches of a globally routed MoE's rows cut over the ranks refuse
    if dms["4x1"].get_coordinate() is not None:
        case = dict(BY_NAME["4x1-allreduce-mode-mixtral"], opts={"microbatch": 2})
        try:
            _run_step_case(case, wms["4x1"])
            out["microbatch_refusal"] = None
        except NotImplementedError as e:
            out["microbatch_refusal"] = str(e)

    # a synchronous sharded save of the deepseek case's final params (its
    # report group made by the loop's first save)
    case, wm = BY_NAME["4x2-deepseek-fused"], wms["4x2"]
    TC.save_sharded(os.path.join(out_dir, "save-sharded", "ck"),
                    out["cases"][case["name"]]["params"], step=STEPS, wmesh=wm,
                    param_specs=S.param_pspecs(_cfg(case["arch"]), wm, "gossip"))
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
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
from test_torch_train_tp_moe import ARCHS, WIDTHS, LR, M, B, _weights, _batches_np, MESHES

cases, out = json.loads(sys.argv[1]), {}
for c in cases:
    name, extra = ARCHS[c["arch"]]
    cfg = get_config(name, reduced=True, **{**WIDTHS, **extra})
    wm = WorkerMesh.from_mesh(make_host_mesh(**MESHES[c["mesh"]]))
    params = _weights(Mo.model_defs(cfg), 3, jax.tree.map)
    data = _batches_np(c["arch"])
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
    procs.append(subprocess.Popen([sys.executable, "-c", REFERENCE, json.dumps(REF_CASES),
                                   ref_path, here],
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


_ORACLE: dict = {}


def _meshless(case, dtype=torch.float32):
    key = (case["name"], dtype)
    if key not in _ORACLE:
        _ORACLE[key] = _single_thread(_run_step_case, case, dtype=dtype)
    return _ORACLE[key]


def _specs(case):
    return S.param_pspecs(_cfg(case["arch"]), _wm_abstract(case["mesh"]), case["mode"])


def _cut(tree, case, coord, mesh=None):
    mesh = mesh or case["mesh"]
    specs = S.param_pspecs(_cfg(case["arch"]), _wm_abstract(mesh), case["mode"])
    return S.local_tree(tree, specs, _wm_abstract(mesh), coordinate=coord)


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
    """Every rank reports the same metrics, those of the meshless step
    (allreduce mode: the whole batch's loss, its router aux term included,
    and its gradient norm)."""
    want = _meshless(case)["metrics"]
    got = [r["metrics"] for r in _on_mesh(ranks, case)]
    for m in got[1:]:
        assert torch.equal(m, got[0])
    torch.testing.assert_close(got[0], want, rtol=STATS_RTOL, atol=0.0)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_each_rank_holds_its_cut_of_the_leaves(ranks, case):
    """A rank holds 1/k of every leaf the specs shard over 'model' (of its
    workers' rows), the rest whole: with the experts cut, only its own
    experts' weights and router columns."""
    wm = _wm_abstract(case["mesh"])
    k, n = wm.model_factor, wm.n_workers if case["mode"] == "gossip" else 1
    like = _global_like(case)
    flags = bus.sharded_leaf_flags(_specs(case), wm.model_axis,
                                   treedef=_tree.flatten(like)[1])
    assert any(flags) == (k > 1)
    cfg = _cfg(case["arch"])
    for r in _on_mesh(ranks, case):
        local = r["params"]
        sharded = sum(x.numel() for x, f in zip(_tree.leaves(local), flags) if f)
        whole = sum(x.numel() for x, f in zip(_tree.leaves(local), flags) if not f)
        assert sharded * k * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if f)
        assert whole * n == sum(x.numel() for x, f in zip(_tree.leaves(like), flags) if not f)
        if cfg.n_experts:
            moe = local["segments"][-1][-1]["mlp"]
            lead = () if case["mode"] == "allreduce" else (M // n,)
            e = cfg.n_experts // k if cfg.n_experts % k == 0 else cfg.n_experts
            fe = cfg.d_ff_expert // k if e == cfg.n_experts else cfg.d_ff_expert
            if cfg.moe_shard == "capacity" and case["mode"] == "allreduce":
                e, fe = cfg.n_experts, cfg.d_ff_expert      # the routed experts replicated
            assert moe["w_up"].shape == lead + (e, cfg.d_model, fe)
            assert moe["router"].shape == lead + (cfg.d_model, e)


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
    """Params and metrics (loss with the aux term, grad norm in allreduce
    mode) equal the reference's GSPMD step's at rtol 1e-5 / atol 1e-6."""
    ref = ranks["reference"]
    like = _global_like(case)
    keys = [case["name"] + "|" + "/".join(map(str, p)) for p, _ in _tree.flatten_with_path(like)]
    want = _tree.unflatten(_tree.flatten(like)[1], [torch.from_numpy(ref[k]) for k in keys])
    for r in _on_mesh(ranks, case):
        for a, b in zip(_tree.leaves(r["params"]), _tree.leaves(_cut(want, case, r["coord"]))):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(r["metrics"], torch.from_numpy(ref[case["name"] + "|metrics"]),
                                   rtol=RTOL, atol=ATOL)


def test_the_aux_gradient_is_the_whole_batchs(ranks):
    """Rows cut over 4 worker groups with a router aux coefficient of 1:
    the routers' params equal the meshless whole-batch step's, and would
    not with the aux term's gradient at 1/4 strength (the meshless step
    at a coefficient of 1/4 is far from them)."""
    case = BY_NAME["4x1-allreduce-mode-mixtral"]
    want = _meshless(case)["params"]
    weak = _meshless(dict(case, arch="mixtral-aux-quarter", name="aux-quarter"))["params"]
    got = _on_mesh(ranks, case)[0]["params"]
    router = lambda t: t["segments"][-1][-1]["mlp"]["router"]  # noqa: E731
    torch.testing.assert_close(router(got), router(want), rtol=RTOL, atol=ATOL)
    assert (router(got) - router(weak)).abs().max() > 100 * ATOL


def test_microbatches_of_rows_cut_global_routing_refuse(ranks):
    got = [r["microbatch_refusal"] for r in ranks["ranks"] if "microbatch_refusal" in r]
    assert len(got) == 4
    for msg in got:
        assert msg is not None and "microbatches" in msg and "moe_dispatch='global'" in msg


def test_gather_from_model_carries_through_vmap(ranks):
    """gather_from_model of the rank's columns under vmap(grad_and_value):
    the loss and x's gradient are the meshless ones, the weight's its cut."""
    gen = torch.Generator().manual_seed(0)
    W, x = torch.randn(3, 8, 16, generator=gen), torch.randn(3, 5, 8, generator=gen)

    def loss(w, x):
        return torch.sum(torch.softmax(x @ w, -1) * torch.arange(16.0))

    (gw, gx), want = torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1)))(W, x)
    for r in ranks["ranks"]:
        i = r["coord"]["model"]
        (g1, g2), got = r["gather"]
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g1, gw[..., i * 8:(i + 1) * 8], rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g2, gx, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# train() and its checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def meshless_loops(ranks, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("meshless")
    return {name: _single_thread(_run_loop, BY_NAME[c], kind, str(tmp / name / "ck.npz"))
            for name, c, kind in LOOPS}


@pytest.mark.parametrize("loop", LOOPS, ids=[x[0] for x in LOOPS])
def test_train_on_the_model_axis_equals_meshless_train(ranks, meshless_loops, loop):
    name, case_name, _ = loop
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
    name, case_name, kind = loop
    case = BY_NAME[case_name]
    pieces = [(r["coord"], r["loops"][name]["params"]) for r in ranks["ranks"]]
    whole = _gathered(pieces, case, "4x2")
    want = str(tmp_path / "ck.npz")
    if kind == "sharded":
        TC.save_sharded(want, whole, step=STEPS, wmesh=_wm_abstract("4x2"))
    else:
        TC.save(want, whole, step=STEPS)
    _same_files(os.path.join(ranks["dir"], name), str(tmp_path))


def test_restore_onto_the_model_axis_equals_the_ranks_params(ranks):
    """restore(wmesh=, param_specs=) of train()'s last sharded save gives
    each rank its cut (its experts, heads and vocab rows) bit for bit."""
    for r in ranks["ranks"]:
        for a, b in zip(_tree.leaves(r["restored"]),
                        _tree.leaves(r["loops"]["train-sharded"]["params"])):
            assert a.shape == b.shape and torch.equal(a, b)


def test_save_sharded_over_the_model_axis_equals_a_meshless_save(ranks, tmp_path):
    """deepseek's experts gathered on their leading dim, its heads on
    theirs: the files equal a meshless save's member for member."""
    case = BY_NAME["4x2-deepseek-fused"]
    pieces = [(r["coord"], r["cases"][case["name"]]["params"]) for r in ranks["ranks"]]
    TC.save_sharded(str(tmp_path / "ck"), _gathered(pieces, case, "4x2"), step=STEPS,
                    wmesh=_wm_abstract("4x2"))
    _same_files(os.path.join(ranks["dir"], "save-sharded"), str(tmp_path))


# ---------------------------------------------------------------------------
# No ranks: the collectives at group size 1, the slots, the shapes, refusals
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


def test_gather_from_model_at_group_size_one_is_the_identity(world_of_one):
    """At group size 1 the gather and its backward (the rank's slice) are
    the identity under vmap(grad_and_value), bit for bit, the batch dim
    anywhere and the gathered dim counted from either end."""
    gen = torch.Generator().manual_seed(1)
    w, x = torch.randn(8, 3, 16, generator=gen), torch.randn(3, 5, 8, generator=gen)

    def loss(w, x, dim):
        z = tp.gather_from_model(x @ w, dim)
        return torch.sum(torch.tanh(z) * torch.arange(16.0))

    want = torch.func.vmap(torch.func.grad_and_value(lambda w, x: loss(w, x, -1),
                                                     argnums=(0, 1)), in_dims=(1, 0))(w, x)
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


def _moe_inputs(E=8, Fe=16, n_shared=0, seed=0):
    cfg = get_config("mixtral-8x7b", reduced=True, d_model=16, n_experts=E, top_k=2,
                     d_ff_expert=Fe, n_shared_experts=n_shared, param_dtype="float64",
                     compute_dtype="float64")
    rng = np.random.default_rng(seed)
    params = _tree.map(lambda d: torch.from_numpy(0.3 * rng.normal(size=d.shape)),
                       Ly.moe_defs(cfg))
    return cfg, params, torch.from_numpy(rng.normal(size=(2, 12, 16)))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_the_slot_ranges_of_the_expert_shards_sum_to_the_whole_dispatch(k):
    """Each of k shards fills and runs only slots [r·(E/k)·C, (r+1)·(E/k)·C)
    of its experts; the k partial outputs sum to the whole dispatch
    (float64, so only a wrong slot moves it past rtol 1e-5), dropped
    tokens included (capacity 1.25 of the mean load)."""
    cfg, params, x = _moe_inputs()
    xf = x.reshape(-1, 16)
    topw, _, keep, slot, capacity, _ = Ly._route_logits(cfg, (xf @ params["router"]).float())
    assert not bool(keep.all())
    want = Ly._dispatch(params, cfg, xf, topw, keep, slot, capacity)
    e = cfg.n_experts // k
    total = torch.zeros_like(want)
    for r in range(k):
        local = {n: params[n][r * e:(r + 1) * e] for n in ("w_gate", "w_up", "w_down")}
        total += Ly._dispatch(local, cfg, xf, topw, keep, slot, capacity, first=r * e)
    torch.testing.assert_close(total, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("E, k, n_shared", [(8, 4, 0), (8, 2, 1), (6, 4, 1)],
                         ids=["experts-cut", "experts-cut-shared", "expert-ff-cut"])
def test_an_moe_shard_holds_and_buffers_only_its_experts(monkeypatch, E, k, n_shared):
    """moe_apply on each of k model shards (abstract coordinates, the
    collectives made identities but the logits' gather, which returns the
    whole router's logits): the dispatch buffer holds only the rank's
    experts (all of them, over their expert_ff columns, where E does not
    divide k), and the partial outputs sum to the meshless layer, the aux
    loss equal on every rank."""
    cfg, params, x = _moe_inputs(E=E, n_shared=n_shared)
    want, want_aux = Ly.moe_apply(params, cfg, x)
    wm = WorkerMesh.from_mesh(AbstractMesh((1, k), ("data", "model")))
    from repro_torch.models.params import tree_specs

    specs = tree_specs(Ly.moe_defs(cfg), mesh=wm)
    whole_logits = (x @ params["router"]).float()
    monkeypatch.setattr(tp, "copy_to_model", lambda t: t)
    monkeypatch.setattr(tp, "reduce_from_model", lambda t: t)
    monkeypatch.setattr(tp, "gather_from_model", lambda t, dim: whole_logits)
    buffers, real = [], Ly._expert_ffn
    monkeypatch.setattr(Ly, "_expert_ffn",
                        lambda p, c, xe: buffers.append(tuple(xe.shape)) or real(p, c, xe))
    total = torch.zeros_like(want)
    for r in range(k):
        local = S.local_tree(params, specs, wm, coordinate={"data": 0, "model": r})
        token = mesh_lib._MODEL.set(mesh_lib.ModelShard(None, k, r))
        try:
            out, aux = Ly.moe_apply(local, cfg, x)
        finally:
            mesh_lib._MODEL.reset(token)
        total += out
        assert aux == want_aux
    C = int(np.ceil(2 * 12 * 2 / E * cfg.capacity_factor))
    shards = E // k if E % k == 0 else E
    assert buffers == [(shards, C, 16)] * k
    torch.testing.assert_close(total, want, rtol=RTOL, atol=ATOL)


def test_the_ranks_routes_of_their_rows_are_the_whole_calls(monkeypatch):
    """Global routing with the rows cut over 4 ranks (the worker-group
    collectives replaced by the sums over every rank's rows, computed
    here): each rank keeps exactly the (token, k) pairs the whole call
    keeps, with the same weights, so the ranks' outputs stacked are the
    whole call's, and every rank's aux loss equals the whole call's."""
    cfg, params, x = _moe_inputs(seed=3)
    n = 4
    logits = (x.reshape(-1, 16) @ params["router"]).float()
    topw, _, keep, slot, C, aux = Ly._route_logits(cfg, logits)
    want = Ly._dispatch(params, cfg, x.reshape(-1, 16), topw, keep, slot, C)
    cuts = logits.chunk(n)
    counts = torch.stack([((Ly._top_k(torch.softmax(c, -1), 2)[1].reshape(-1)[:, None]
                            == torch.arange(8)).sum(0)) for c in cuts])
    psum = torch.softmax(logits, -1).sum(0)

    class Rows:
        n_workers = n

    rows, outs = Rows(), []
    monkeypatch.setattr(tp, "gather_over_rows", lambda c, wm: counts)
    monkeypatch.setattr(tp, "sum_over_rows", lambda s, wm: psum)
    for r, (lg, xr) in enumerate(zip(cuts, x.reshape(-1, 16).chunk(n))):
        rows.worker_index = r
        w, _, kp, sl, held, a = Ly._route_logits(cfg, lg, rows)
        assert held == min(C, lg.shape[0])
        torch.testing.assert_close(a, aux, rtol=RTOL, atol=0.0)
        assert torch.equal(kp, keep.chunk(n)[r])
        outs.append(Ly._dispatch(params, cfg, xr, w, kp, sl, held))
    torch.testing.assert_close(torch.cat(outs), want, rtol=RTOL, atol=ATOL)


def test_rows_cut_over_an_abstract_mesh_asks_for_a_live_one():
    cfg, params, x = _moe_inputs()
    wm = WorkerMesh.from_mesh(AbstractMesh((4, 1), ("data", "model")))
    with mesh_lib.rows_cut_over(wm):
        with pytest.raises(ValueError, match="needs a live mesh"):
            Ly.moe_apply(params, cfg, x)


if __name__ == "__main__":
    _rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
