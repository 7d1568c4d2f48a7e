"""Multi-pod dry run: every (architecture × input shape) on the production
mesh, run on ``meta`` tensors over torch's fake process group, without a
card: does the distribution config hold together, and what bounds it?

Usage:
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
    python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all      # every combination, in subprocesses

Writes JSON results to ``results/dryrun_torch/``.

The counterpart of the reference's ``repro/launch/dryrun.py``, which lowers
and compiles each step ahead of time on 256 or 512 forced host devices and
reads FLOPs, bytes, collectives and memory out of the compiled program.
Torch compiles nothing ahead of time, so here one process stands for rank 0
of the production world (``launch.mesh.make_host_mesh(device="meta")``:
16 × 16 or 2 × 16 × 16 ranks) and runs rank 0's part of the real step on
``meta`` tensors, which carry shapes and dtypes and no data, every
collective returning at once (``launch.cost.measure`` records them and
every op). The hand-written kernels take their card route as far as the
launch and report their work. So:

* ``compile_s`` is the seconds the meta run took;
* ``memory_analysis`` is the recorder's peak live bytes of rank 0, its
  state, batch and every tensor the step makes, as they are released;
* there is no ``donate`` (eager torch frees a tensor when its last
  reference goes, and the step's caller holds the old state) and no
  ``save_hlo`` (there is no HLO);
* serving replicates the parameters over the worker axes and cuts them
  over the model axis, the layout the port serves with on a mesh; a config
  whose ``serve_sharding`` is ``"fsdp"`` (nemotron-4-340b) says so in
  ``layout``, since the port does not cut d_model over the worker axes. The
  batch's rows are cut over the worker axes where they divide them, as
  the reference cuts them, and replicated where they do not;
* a combination the port refuses gives ``ok=False`` with the error, as the
  reference's ``run_one`` does.

Rank 0 stands for every rank: each holds the same shapes (a row-split bus
leaf pads its last shard, with the same chunk size).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback
from typing import Any

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import topology as topo_lib
from repro_torch.launch import cost as cost_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import roofline as roof_lib
from repro_torch.launch import shardings as shard_lib
from repro_torch.launch.mesh import WorkerMesh

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

__all__ = ["DryrunResult", "kind_of", "shape_applicable", "make_topology", "input_specs",
           "build_and_run", "run_one", "save_result", "main"]


def kind_of(shape_name: str) -> str:
    return INPUT_SHAPES[shape_name]["kind"]


def shape_applicable(cfg: ModelConfig, shape_name: str) -> bool:
    """long_500k only for sub-quadratic archs, as in the reference."""
    if shape_name == "long_500k":
        return cfg.subquadratic
    return True


def make_topology(name: str, M_: int, degree: int = 2, pod_size: int = 16):
    if name == "ring":
        return topo_lib.undirected_ring(M_)
    if name == "clique":
        return topo_lib.clique(M_)
    if name == "expander":
        return topo_lib.expander(M_, degree, n_candidates=10)
    if name == "dirring":
        return topo_lib.directed_ring_lattice(M_, degree)
    if name == "hypercube":
        return topo_lib.hypercube(int(np.log2(M_)))
    if name == "hier":
        # inter-pod pairing ⊗ intra-pod ring; pod_size follows the mesh's
        # workers per pod, so node index = pod-major worker index
        if M_ % pod_size:
            raise ValueError(f"{M_} workers do not split into pods of {pod_size}")
        outer = topo_lib.clique(max(M_ // pod_size, 1))
        return topo_lib.kronecker(outer, topo_lib.undirected_ring(pod_size))
    raise ValueError(name)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _cross_kv_abstract(cfg: ModelConfig, batch: int) -> list:
    from repro_torch.models import model as M

    dt = getattr(torch, cfg.compute_dtype)
    shape = (batch, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
    out = []
    for seg in M.plan_segments(cfg):
        if seg.scanned:
            out.append((_meta((seg.length,) + shape, dt), _meta((seg.length,) + shape, dt)))
        else:
            out.append([(_meta(shape, dt), _meta(shape, dt)) for _ in range(seg.length)])
    return out


def input_specs(cfg: ModelConfig, shape_name: str, mesh, mode: str) -> dict[str, Any]:
    """``meta`` stand-ins of every model input of this shape, global (the
    whole batch, unsharded caches), as the reference's ShapeDtypeStructs."""
    from repro_torch.models import model as M

    spec = INPUT_SHAPES[shape_name]
    seq, gb, kind = spec["seq_len"], spec["global_batch"], spec["kind"]
    dt_tok, dt_act = torch.int32, getattr(torch, cfg.compute_dtype)
    out: dict[str, Any] = {}
    if kind == "train":
        lead = (WorkerMesh.ensure(mesh).n_workers, gb // WorkerMesh.ensure(mesh).n_workers) \
            if mode == "gossip" else (gb,)
        out["tokens"] = _meta(lead + (seq,), dt_tok)
        out["labels"] = _meta(lead + (seq,), dt_tok)
        if cfg.encoder_layers:
            out["enc_embeds"] = _meta(lead + (cfg.encoder_seq, cfg.d_model), dt_act)
    elif kind == "prefill":
        out["tokens"] = _meta((gb, seq), dt_tok)
        if cfg.encoder_layers:
            out["enc_embeds"] = _meta((gb, cfg.encoder_seq, cfg.d_model), dt_act)
    elif kind == "decode":
        out["tokens"] = _meta((gb, 1), dt_tok)
        out["caches"] = M.init_cache({"embed": _meta((0,), dt_act)}, cfg, gb, seq)
        if cfg.encoder_layers:
            out["memory"] = _meta((gb, cfg.encoder_seq, cfg.d_model), dt_act)
            out["cross_kvs"] = _cross_kv_abstract(cfg, gb)
    return out


@dataclasses.dataclass
class DryrunResult:
    arch: str
    shape: str
    mesh: str
    mode: str
    topology: str
    ok: bool
    compile_s: float
    roofline: dict | None
    collectives: dict | None
    coll_counts: dict | None
    memory_analysis: str | None
    error: str | None = None
    layout: str | None = None      # the layout the port ran, where it is not the reference's
    kernels: dict | None = None    # per hand-written kernel: calls, operations, bytes


def _mesh_name(multi_pod: bool) -> str:
    shape = mesh_lib.MULTI_POD if multi_pod else mesh_lib.SINGLE_POD
    return ("multipod_" if multi_pod else "pod_") + "x".join(str(n) for n in shape)


def _production_mesh(multi_pod: bool) -> WorkerMesh:
    """The live meta mesh of the production shape (``mesh.SINGLE_POD`` or
    ``mesh.MULTI_POD``), over the fake group of its size."""
    if multi_pod:
        pod, data, model = mesh_lib.MULTI_POD
        return WorkerMesh.from_mesh(mesh_lib.make_host_mesh(data, model, pod, device="meta"))
    data, model = mesh_lib.SINGLE_POD
    return WorkerMesh.from_mesh(mesh_lib.make_host_mesh(data, model, device="meta"))


def _local(tree, specs, wm):
    """Rank 0's part of a global meta tree under ``specs``, each leaf a
    tensor of its own (a view would keep the whole leaf's storage live)."""
    return _tree.map(lambda x: _meta(x.shape, x.dtype), shard_lib.local_tree(tree, specs, wm))


def _rows(tree, b_ax, wm):
    """Rank 0's rows of a global batch tree, cut over the worker axes
    (``b_ax``), or the whole batch (``b_ax`` None)."""
    if b_ax is None:
        return tree
    from repro_torch.models.params import PartitionSpec as P

    return _local(tree, _tree.map(lambda x: P(b_ax, *([None] * (x.dim() - 1))), tree), wm)


def _cache_at(caches, pos: int):
    """Every layer cache of ``caches`` with its write position at ``pos``."""
    if isinstance(caches, list):
        return [_cache_at(c, pos) for c in caches]
    return caches._replace(pos=pos)


def _kernels(cost: cost_lib.Cost) -> dict:
    out: dict[str, dict] = {}
    for k in cost.kernels:
        e = out.setdefault(k.name, {"calls": 0, "ops": 0.0, "bytes": 0.0})
        e["calls"] += 1
        e["ops"] += k.ops
        e["bytes"] += k.nbytes
    return out


def build_and_run(arch: str, shape_name: str, *, multi_pod: bool = False,
                  topology: str = "ring", gossip_backend: str = "ppermute",
                  mode: str | None = None, gossip_period: int = 1,
                  microbatch: int | None = None, worker_internal: str = "tp",
                  moe_dispatch: str | None = None, shard_activations: str | None = None,
                  parallel_block: bool = False, moe_shard: str | None = None,
                  reduced: bool = False, hierarchical: bool = False):
    """Run rank 0's part of one (arch × shape) step on the production mesh on
    ``meta`` → ``(DryrunResult, Cost, WorkerMesh)``; raises where the port
    refuses the combination."""
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.mesh import model_parallel, rows_cut_over
    from repro_torch.models import model as M
    from repro_torch.models.params import abstract_tree
    from repro_torch.optim import momentum_sgd
    from repro_torch.serving.engine import make_serve_step

    cfg = get_config(arch, reduced=True) if reduced else get_config(arch)
    overrides = {k: v for k, v in (("moe_dispatch", moe_dispatch),
                                   ("shard_activations", shard_activations),
                                   ("moe_shard", moe_shard)) if v}
    if parallel_block:
        overrides["parallel_block"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    wm = _production_mesh(multi_pod)
    spec = INPUT_SHAPES[shape_name]
    kind, seq, gb = spec["kind"], spec["seq_len"], spec["global_batch"]
    layout = None
    if kind == "train":
        mode = mode or cfg.dp_mode
    else:
        mode = mode or ("fsdp" if cfg.serve_sharding == "fsdp" else "serve")
        if mode == "fsdp":
            layout = ("params: param_pspecs(allreduce), replicated over the worker axes and "
                      "cut over the model axis; the reference's fsdp layout (d_model cut "
                      "over the worker axes) is not emulated")
    chips = int(np.prod(list(wm.shape.values())))
    defs = M.model_defs(cfg)
    params_g = abstract_tree(defs, getattr(torch, cfg.param_dtype))
    ins = input_specs(cfg, shape_name, wm, mode)
    t0 = time.perf_counter()

    if kind == "train":
        if worker_internal != "tp":
            raise NotImplementedError(
                f"worker_internal={worker_internal!r}: the port trains each worker's whole "
                "batch on every model rank of its group; cutting a worker's batch over the "
                "model axis changes the function trained")
        if microbatch is None:
            # the reference's default: per-microbatch sequences per worker kept
            # small enough that the remat carries fit
            microbatch = max(gb // wm.n_workers // 2, 1)
        train_mode = "allreduce" if mode == "serve" else mode
        pod_size = (wm.n_workers // wm.shape["pod"]
                    if multi_pod and topology == "hier" else 16)
        topo = make_topology(topology, wm.n_workers, pod_size=pod_size)
        gspec = GossipSpec.for_mesh(topo, wm, backend=gossip_backend, period=gossip_period,
                                    hierarchical=hierarchical)
        pspec = shard_lib.param_pspecs(cfg, wm, train_mode, worker_internal=worker_internal)
        if train_mode == "gossip":
            params_g = _tree.map(lambda x: _meta((wm.n_workers,) + tuple(x.shape), x.dtype),
                                 params_g)
        params = _local(params_g, pspec, wm)
        bspec = shard_lib.batch_pspecs(cfg, wm, "train", train_mode,
                                       worker_internal=worker_internal)
        batch = _local(ins, {k: bspec[k] for k in ins}, wm)
        opt = momentum_sgd(1e-2, 0.9)
        step = make_train_step(lambda p, b: M.loss_fn(p, cfg, b), opt, gossip=gspec,
                               mode=train_mode, mesh=wm, compute_stats=False,
                               microbatch=microbatch, param_specs=pspec)
        state = init_state(params, opt)
        del params
        _, cost = cost_lib.measure(step, state, batch)
        n_tokens = gb * seq
    else:
        pspec = shard_lib.param_pspecs(cfg, wm, "allreduce")
        params = _local(params_g, pspec, wm)
        b_ax = shard_lib._div(gb, wm, wm.wa)
        rows = wm if b_ax is not None else None
        with model_parallel(wm), rows_cut_over(rows):
            if kind == "prefill":
                args = _rows({k: ins[k] for k in ("tokens", "enc_embeds") if k in ins}, b_ax, wm)

                def fn(p, tokens, enc_embeds=None):
                    logits, caches, _, _ = M.prefill(p, cfg, tokens, max_len=seq,
                                                     enc_embeds=enc_embeds)
                    return logits, caches

                _, cost = cost_lib.measure(fn, params, **args)
                n_tokens = gb * seq
            else:
                b = ins["tokens"].shape[0] if b_ax is None else gb // wm.n_workers
                caches = _cache_at(M.init_cache(params, cfg, b, seq), seq - 1)
                args = [_meta((b, 1), torch.int32)]
                if cfg.encoder_layers:
                    memory = _meta((b, cfg.encoder_seq, cfg.d_model),
                                   getattr(torch, cfg.compute_dtype))
                    args += [memory, M.precompute_cross_kv(params, cfg, memory)]
                _, cost = cost_lib.measure(make_serve_step(cfg), params, caches, *args)
                n_tokens = gb       # one token per sequence
    compile_s = time.perf_counter() - t0
    if cost.unreported_c10d():
        raise AssertionError(f"{cost.unreported_c10d()} c10d ops without a recorded "
                             f"collective: {cost.c10d_ops}")
    terms = roof_lib.analyze(cost, cfg, chips=chips, n_tokens=n_tokens,
                             kind="train" if kind == "train" else "serve")
    mem = (f"peak live bytes per rank {cost.peak_bytes} "
           f"({cost.peak_bytes / 1e9:.3f} GB of the H100's 80 GB)")
    res = DryrunResult(
        arch=arch, shape=shape_name, mesh=_mesh_name(multi_pod), mode=mode,
        topology=topology if kind == "train" else "-", ok=True, compile_s=compile_s,
        roofline=terms.as_dict(), collectives=roof_lib.collective_bytes(cost.collectives),
        coll_counts=roof_lib.collective_counts(cost.collectives), memory_analysis=mem,
        layout=layout, kernels=_kernels(cost))
    return res, cost, wm


def run_one(arch: str, shape_name: str, **kw) -> DryrunResult:
    try:
        return build_and_run(arch, shape_name, **kw)[0]
    except Exception:
        return DryrunResult(
            arch=arch, shape=shape_name, mesh=_mesh_name(kw.get("multi_pod", False)),
            mode=kw.get("mode") or "?", topology=kw.get("topology", "ring"), ok=False,
            compile_s=0.0, roofline=None, collectives=None, coll_counts=None,
            memory_analysis=None, error=traceback.format_exc())


def save_result(res: DryrunResult, tag: str = "") -> str:
    os.makedirs(RESULTS_DIR, exist_ok=True)
    name = f"{res.arch}__{res.shape}__{res.mesh}{('__' + tag) if tag else ''}.json"
    path = os.path.join(RESULTS_DIR, name)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(res), f, indent=1)
    return path


def table_row(res: dict) -> str:
    """One markdown row of a saved result: ok, peak GB per rank, the three
    terms and the bottleneck."""
    head = f"| {res['arch']} | {res['shape']} | {res['mesh']} |"
    if not res["ok"]:
        last = (res["error"] or "").strip().splitlines()[-1:] or [""]
        return f"{head} no: {last[0][:90]} | | | | | |"
    r = res["roofline"]
    return (f"{head} yes | {r['peak_bytes_per_chip'] / 1e9:.2f} | {r['t_compute_s']:.4g} | "
            f"{r['t_memory_s']:.4g} | {r['t_collective_s']:.4g} | {r['bottleneck']} |")


def _smoke_shape() -> str:
    INPUT_SHAPES.setdefault("train_smoke", dict(seq_len=64, global_batch=8, kind="train"))
    return "train_smoke"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=tuple(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--gossip-backend", default="ppermute")
    ap.add_argument("--gossip-period", type=int, default=1)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--worker-internal", default="tp", choices=("tp", "dp", "fsdp"))
    ap.add_argument("--moe-dispatch", default=None)
    ap.add_argument("--shard-activations", default=None, nargs="?", const="model")
    ap.add_argument("--parallel-block", action="store_true")
    ap.add_argument("--moe-shard", default=None)
    ap.add_argument("--mode", default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--all", action="store_true",
                    help="every combination, each a process of its own, one per two host "
                         "cores at a time; ends with a markdown table of the results")
    ap.add_argument("--hierarchical", action="store_true",
                    help="stage the gossip mix as intra-pod then inter-pod rounds "
                         "(GossipSpec.hierarchical)")
    ap.add_argument("--smoke", action="store_true",
                    help="a multi-pod mesh of (2, 2, 2), reduced nemotron, gossip mode on "
                         "the fused bus: it must run and issue collective-permutes")
    ap.add_argument("--hier-smoke", action="store_true",
                    help="the hier topology with hierarchical gossip on a (2, 2, 2) mesh: "
                         "intra-pod permutes stay in a pod, inter-pod ones ride the pod "
                         "axis alone, and none mixes the two")
    args = ap.parse_args(argv)

    if args.smoke or args.hier_smoke:
        mesh_lib.MULTI_POD = (2, 2, 2)
        kw = dict(topology="hier", gossip_backend=args.gossip_backend, hierarchical=True) \
            if args.hier_smoke else dict(topology=args.topology, gossip_backend="fused")
        arch = args.arch or "nemotron-4-340b"
        try:
            res, cost, wm = build_and_run(arch, _smoke_shape(), multi_pod=True, mode="gossip",
                                          reduced=True, **kw)
        except Exception:
            traceback.print_exc()
            return 2
        counts = res.coll_counts
        if args.smoke:
            print(f"SMOKE OK {arch} gossip on multipod {mesh_lib.MULTI_POD}: {wm.describe()}; "
                  f"collective-permutes={counts['collective-permute']} "
                  f"cp_bytes={int(res.collectives['collective-permute'])}")
            if not counts["collective-permute"]:
                print("gossip mode must issue collective-permutes")
                return 2
            return 0
        classes = cost_lib.permute_link_classes(cost, wm)
        print(f"HIER SMOKE {arch} on multipod {mesh_lib.MULTI_POD}: {wm.describe()}; "
              f"permute classes ici={classes['ici']} dci={classes['dci']} "
              f"mixed={classes['mixed']}")
        if not (classes["ici"] > 0 and classes["dci"] > 0 and classes["mixed"] == 0):
            print(f"hierarchical gossip must give pure ici and dci permutes: {classes['ops']}")
            return 2
        return 0

    if args.all:
        from concurrent.futures import ThreadPoolExecutor

        runs = [(arch, shape, multi) for multi in (False, True) for arch in ARCH_NAMES
                for shape in INPUT_SHAPES if shape_applicable(get_config(arch), shape)]

        def one(run):
            arch, shape, multi = run
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--shape", shape] + (["--multi-pod"] if multi else [])
            res = subprocess.run(cmd, capture_output=True, text=True)
            print(">>", " ".join(cmd), "\n" + res.stdout + res.stderr[-2000:], flush=True)
            return res.returncode

        with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)) as pool:
            rcs = list(pool.map(one, runs))
        fails = [run for run, rc in zip(runs, rcs) if rc]
        rows = []
        for arch, shape, multi in runs:
            with open(os.path.join(RESULTS_DIR,
                                   f"{arch}__{shape}__{_mesh_name(multi)}.json")) as f:
                rows.append(table_row(json.load(f)))
        print("| arch | shape | mesh | ok | peak GB / rank | t_compute s | t_memory s "
              "| t_collective s | bottleneck |")
        print("|---|---|---|---|---|---|---|---|---|")
        print("\n".join(rows))
        print("FAILURES:", fails if fails else "none")
        return 1 if fails else 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape are required (or --all, --smoke, --hier-smoke)")
    cfg = get_config(args.arch)
    if not shape_applicable(cfg, args.shape):
        print(f"SKIP {args.arch} × {args.shape}: full attention at 500k")
        return 0
    res = run_one(args.arch, args.shape, multi_pod=args.multi_pod, topology=args.topology,
                  gossip_backend=args.gossip_backend, gossip_period=args.gossip_period,
                  microbatch=args.microbatch, worker_internal=args.worker_internal,
                  moe_dispatch=args.moe_dispatch, shard_activations=args.shard_activations,
                  parallel_block=args.parallel_block, moe_shard=args.moe_shard,
                  mode=args.mode, hierarchical=args.hierarchical)
    path = save_result(res, args.tag)
    if res.ok:
        r = res.roofline
        print(f"OK {res.arch} × {res.shape} × {res.mesh} [{res.mode}] "
              f"meta run={res.compile_s:.1f}s  "
              f"t_comp={r['t_compute_s']:.4f}s t_mem={r['t_memory_s']:.4f}s "
              f"t_coll={r['t_collective_s']:.4f}s -> {r['bottleneck']}")
        print("memory_analysis:", res.memory_analysis)
        if res.layout:
            print("layout:", res.layout)
        print("saved:", path)
        return 0
    print(f"FAIL {res.arch} × {res.shape} × {res.mesh}")
    print(res.error)
    print("saved:", path)
    return 2


if __name__ == "__main__":
    sys.exit(main())
