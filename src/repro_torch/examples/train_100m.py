"""End to end: decentralized training of a granite-family LM for a
few hundred steps (the paper's technique, a synthetic corpus, checkpoints).

    python -m repro_torch.examples.train_100m --preset full           # 300 steps
    python -m repro_torch.examples.train_100m --preset small          # quick
    python -m repro_torch.examples.train_100m --mesh ...              # on a WorkerMesh
    python -m repro_torch.examples.train_100m --device cpu ...

Model: a granite-family decoder, d_model 512, 12 layers, vocab 8192, tied
embeddings: 49,820,160 parameters in ``full`` (4,327,680 in ``small``).
Four DSM workers on a ring; classical momentum 0.9 and the Smith LR rule,
the paper's §4 recipe. The consensus checkpoint goes to
``results/torch/train_100m.npz`` (``--ckpt``), the run's losses, step times
and peak device memory to ``results/torch/train_100m.json``;
``serve_demo --gossip-ckpt`` decodes from the checkpoint.

``--mesh`` trains on a ``WorkerMesh`` over the ranks of ``torch.distributed``
with the fused gossip bus (the ``gossip_mix`` kernel on the card): under
``torchrun`` the world is torchrun's, each rank holding M / world workers;
launched plainly, a world of size 1 on a ``FileStore`` (NCCL on the card,
gloo on the CPU) holds all M workers. Without ``--mesh`` the workers are a
leading dimension on one device and mix through the einsum backend.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import to_device
from repro_torch.configs import get_config
from repro_torch.core import topology as T
from repro_torch.core.decentralized import init_state, make_train_step, replicate_for_workers
from repro_torch.core.gossip import GossipSpec
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
from repro_torch.examples import RESULTS
from repro_torch.models import model as Mo
from repro_torch.models.params import count_params
from repro_torch.optim import momentum_sgd, smith_lr_range_test
from repro_torch.train import train

PRESETS = {
    # name: (d_model, layers, heads, d_ff, vocab, seq, batch/worker, steps)
    "full": (512, 12, 8, 2048, 8192, 128, 8, 300),
    "small": (256, 4, 4, 1024, 2048, 64, 8, 60),
}


def make_config(preset: str):
    """(cfg, preset tuple) for a train_100m run, shared with serve_demo so a
    gossip checkpoint trained here can be decoded there."""
    d, L, H, F, V, seq, B, steps = PRESETS[preset]
    cfg = get_config("granite-3-2b", reduced=True, n_layers=L, d_model=d, n_heads=H,
                     n_kv_heads=max(H // 4, 1), head_dim=d // H, d_ff=F, vocab_size=V,
                     scan_layers=True, remat=False, tie_embeddings=True)
    return cfg, PRESETS[preset]


@contextlib.contextmanager
def _world(dev: torch.device):
    """The process group ``--mesh`` runs over: torchrun's (its environment)
    or a world of size 1 on a FileStore. Yields this process's device; the
    group is destroyed after."""
    import torch.distributed as dist

    backend = "nccl" if dev.type == "cuda" else "gloo"
    tmp = None
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group(backend)
    else:
        if dev.type == "cuda":
            dev = torch.device("cuda", dev.index or 0)
            torch.cuda.set_device(dev)
        tmp = tempfile.mkdtemp(prefix="train_100m_store")
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
    try:
        yield dev
    finally:
        dist.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _worker_mesh(cfg, topo, Mw: int, dev: torch.device):
    """(WorkerMesh, gossip spec, param specs) over the world's ranks."""
    import torch.distributed as dist

    from repro_torch.launch import shardings
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh

    world = dist.get_world_size()
    if Mw % world:
        raise SystemExit(f"--mesh needs the {Mw} workers to divide over the world's "
                         f"{world} ranks")
    wm = WorkerMesh.from_mesh(make_host_mesh(data=world, model=1, device=dev.type))
    return (wm, GossipSpec.for_mesh(topo, wm, backend="fused"),
            shardings.param_pspecs(cfg, wm, "gossip"))


def smith_lr(loss, params0, Mw: int, next_batch, dev) -> tuple[float, np.ndarray, np.ndarray]:
    """The Smith (2017) LR range test, the paper's configuration rule: one
    step from the common start per grid point (10 points in [1e-4, 3])."""
    def one_step_loss(lr):
        opt = momentum_sgd(lr, 0.9)
        spec = GossipSpec(topology=T.undirected_ring(Mw), backend="einsum")
        step = make_train_step(loss, opt, gossip=spec, mode="gossip")
        st = init_state(replicate_for_workers(params0, Mw), opt)
        _, m = step(st, {"tokens": torch.as_tensor(next_batch(), device=dev)})
        return float(m.loss)

    return smith_lr_range_test(one_step_loss, 1e-4, 3.0, n_points=10)


def train_run(preset: str = "small", *, steps: int | None = None, workers: int = 4,
              topology: str = "ring", ckpt: str | None = None, mesh: bool = False,
              device="cuda", params0=None) -> dict:
    """Train one preset; returns the run's record (what ``main`` writes).
    ``params0``: one replica's initial params (default: drawn from seed 0)."""
    dev = resolve_device(device)
    d, L, H, F, V, seq, B, default_steps = PRESETS[preset]
    steps = steps or default_steps
    ckpt = ckpt or os.path.join(RESULTS, "train_100m.npz")
    cfg, _ = make_config(preset)
    n_params = count_params(Mo.model_defs(cfg))
    print(f"model: {n_params/1e6:.1f}M params  d={d} L={L} vocab={V} seq={seq}")

    Mw = workers
    toks, _ = token_stream(S=4096, seq_len=seq, vocab=V, seed=0)
    parts = pad_to_equal(random_split(len(toks), Mw))
    batcher = WorkerBatcher((toks,), parts, batch_size=B, seed=0)

    def next_batch():
        (t,) = batcher.next()
        return t

    def batches():
        while True:
            yield {"tokens": next_batch()}

    def loss(p, b):
        return Mo.loss_fn(p, cfg, b)

    topo = T.undirected_ring(Mw) if topology == "ring" else T.clique(Mw)
    os.makedirs(os.path.dirname(os.path.abspath(ckpt)), exist_ok=True)
    with contextlib.ExitStack() as stack:
        rank = 0
        if mesh:
            dev = stack.enter_context(_world(dev))
            rank = torch.distributed.get_rank()
        if params0 is None:
            params0 = Mo.init(torch.Generator().manual_seed(0), cfg, device=dev)
        params0 = to_device(params0, dev)
        lr, lrs, lr_losses = smith_lr(loss, params0, Mw, next_batch, dev)
        lr *= 0.3  # safety margin below the divergence knee (momentum 0.9)
        print(f"Smith LR rule selected lr = {lr:.4f}")

        mesh_kw, gspec = {}, GossipSpec(topology=topo, backend="einsum")
        if mesh:
            wm, gspec, specs = _worker_mesh(cfg, topo, Mw, dev)
            mesh_kw = dict(mesh=wm, param_specs=specs)
            print(f"WorkerMesh: {wm.describe()}")
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        _, hist = train(loss, replicate_for_workers(params0, Mw), momentum_sgd(lr, 0.9),
                        batches(), steps=steps, gossip=gspec, mode="gossip",
                        log_every=max(steps // 10, 1), ckpt_path=ckpt,
                        ckpt_every=max(steps // 3, 1), device=dev, **mesh_kw)
    # the first window is step 0 alone; the others are steady steps
    ms = 1e3 * float(np.mean(hist.step_time[1:] or hist.step_time))
    return {
        "preset": preset, "steps": steps, "workers": Mw, "topology": topo.name,
        "mesh": mesh, "rank": rank, "device": str(dev), "n_params": n_params, "lr": lr,
        "smith_lrs": lrs.tolist(), "smith_losses": lr_losses.tolist(),
        "loss": hist.loss, "step_time_s": hist.step_time, "ckpt": ckpt,
        "ms_per_step": ms, "tokens_per_s": Mw * B * seq / (ms / 1e3),
        "peak_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                    if dev.type == "cuda" else None),
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.train_100m")
    ap.add_argument("--preset", default="small", choices=PRESETS)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--topology", default="ring", choices=("ring", "clique"))
    ap.add_argument("--ckpt", default=os.path.join(RESULTS, "train_100m.npz"))
    ap.add_argument("--mesh", action="store_true",
                    help="run on a WorkerMesh over torch.distributed's ranks "
                         "(fused gossip bus) instead of meshless")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = train_run(args.preset, steps=args.steps, workers=args.workers,
                    topology=args.topology, ckpt=args.ckpt, mesh=args.mesh,
                    device=args.device)
    if rec["rank"] == 0:
        os.makedirs(RESULTS, exist_ok=True)
        with open(os.path.join(RESULTS, "train_100m.json"), "w") as fp:
            json.dump(rec, fp, indent=1)
    print(f"\nloss {rec['loss'][0]:.4f} -> {rec['loss'][-1]:.4f} over {rec['steps']} steps "
          f"on {rec['topology']}; checkpoint at {rec['ckpt']}")
    print(f"{rec['ms_per_step']:.2f} ms/step after the first, "
          f"{rec['tokens_per_s']:.0f} tokens/s")
    print("decode from it:  python -m repro_torch.examples.serve_demo "
          f"--gossip-ckpt {rec['ckpt']} --preset {args.preset}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
