"""Quickstart: decentralized training of a tiny LM on a ring of workers.

    python -m repro_torch.examples.quickstart [--device cpu]

The public API end to end: topology → GossipSpec → the decentralized step
in ``train()`` → the loss curve and the gradient statistics (the paper's
E, E_sp and H per step).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import topology as T
from repro_torch.core.decentralized import replicate_for_workers
from repro_torch.core.gossip import GossipSpec
from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
from repro_torch.models import model as Mo
from repro_torch.optim import momentum_sgd
from repro_torch.train import train

M_WORKERS = 4
STEPS = 60


def make_config():
    """granite-3-2b's family at 2 layers of 128."""
    return get_config("granite-3-2b", reduced=True, n_layers=2, d_model=128, n_heads=4,
                      n_kv_heads=2, head_dim=32, d_ff=256, vocab_size=512)


def run(*, device="cuda", params0=None, steps: int = STEPS):
    """Train the quickstart model; returns ``(topology, History)``.
    ``params0``: one replica's initial params (default: drawn from seed 0)."""
    dev = resolve_device(device)
    cfg = make_config()
    toks, _ = token_stream(S=512, seq_len=32, vocab=cfg.vocab_size, seed=0)
    parts = pad_to_equal(random_split(len(toks), M_WORKERS))
    batcher = WorkerBatcher((toks,), parts, batch_size=8, seed=0)

    def batches():
        while True:
            (t,) = batcher.next()
            yield {"tokens": t}

    topo = T.undirected_ring(M_WORKERS)
    print(f"topology: {topo.name}  spectral gap: {topo.spectral_gap:.3f}")
    if params0 is None:
        params0 = Mo.init(torch.Generator().manual_seed(0), cfg, device=dev)
    _, hist = train(
        lambda p, b: Mo.loss_fn(p, cfg, b),
        replicate_for_workers(params0, M_WORKERS),
        momentum_sgd(0.1, 0.9),           # the paper's optimizer
        batches(),
        steps=steps,
        gossip=GossipSpec(topology=topo, backend="einsum"),
        mode="gossip",
        log_every=10,
        device=dev,
    )
    return topo, hist


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    _, hist = run(device=args.device)
    print(f"\nloss: {hist.loss[0]:.3f} -> {hist.loss[-1]:.3f}")
    print(f"final sqrt(E/E_sp): "
          f"{np.sqrt(hist.grad_energy[-1] / max(hist.grad_spread[-1], 1e-9)):.2f} "
          f"(paper Table 1 statistic)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
