"""Serving demo: continuous batching over a paged KV cache (the default),
or the lock-step wave baseline with ``--batcher wave``.

    python -m repro_torch.examples.serve_demo [--arch gemma-2b] [--device cpu]
    python -m repro_torch.examples.serve_demo --batcher wave
    python -m repro_torch.examples.serve_demo \\
        --gossip-ckpt results/torch/train_100m.npz --preset small

Serves the reduced config of any architecture from seeded random weights,
or, with ``--gossip-ckpt``, the consensus w̄ = (1/M) Σ_j w_j of a
decentralized-training checkpoint (``train_100m``'s), averaged by
``serving.engine.load_consensus_params``. Architectures the paged cache
cannot serve (SSM, RG-LRU, sliding windows, the encoder-decoder) are served
by the wave batcher instead, as the reference's demo does. Writes each
request's tokens to ``results/torch/serve_demo.json``.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.examples import RESULTS
from repro_torch.models import model as Mo
from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate
from repro_torch.serving.engine import load_consensus_params
from repro_torch.serving.kvcache import paged_unsupported_reason

N_NEW = 8


def serve(params, cfg, batcher: str, requests: int, rng: np.random.Generator) -> dict:
    """Serve ``requests`` random prompts with ``batcher``, then sample two
    prompts through ``generate``; returns the tokens and the batcher's stats."""
    reason = paged_unsupported_reason(cfg)
    if batcher == "continuous" and reason is not None:
        print(f"paged cache unsupported for {cfg.name} ({reason}); "
              f"falling back to the wave baseline")
        batcher = "wave"
    stats = {}
    if batcher == "continuous":
        cb = ContinuousBatcher(params, cfg, batch_slots=3, max_len=64, page_size=8,
                               max_new=N_NEW)
        cb.warmup()
        rids = [cb.submit(rng.integers(0, cfg.vocab_size, size=rng.integers(4, 12)),
                          n_new=N_NEW) for _ in range(requests)]
        done = cb.run_until_done()
        stats = cb.stats()
        print(f"continuous: occupancy={stats['mean_occupancy']:.2f} "
              f"decode_traces={stats['decode_traces']} "
              f"bucket_misses={stats['bucket_misses']}")
    else:
        wb = WaveBatcher(params, cfg, batch_slots=3, max_len=64)
        # recurrent kinds (ssm/rglru) can't take ragged waves: pad tokens
        # would pollute the per-slot recurrent state, so batch equal lengths
        recurrent = set(cfg.layer_kinds) - {"attn", "local"}
        rids = []
        for _ in range(requests):
            size = 8 if recurrent else int(rng.integers(4, 12))
            rids.append(wb.submit(rng.integers(0, cfg.vocab_size, size=size), n_new=N_NEW))
        done = wb.run_until_done()
    tokens = {rid: np.asarray(done[rid]).tolist() for rid in rids}
    for rid in rids:
        print(f"request {rid}: generated tokens {tokens[rid]}")
    # temperature sampling through the same KV-cache path
    out = generate(params, cfg, rng.integers(0, cfg.vocab_size, (2, 6)), n_new=6,
                   temperature=0.8)
    sampled = out.tokens.tolist()
    print("sampled:", sampled)
    return {"batcher": batcher, "tokens": tokens, "n_new": N_NEW, "sampled": sampled,
            "stats": {k: v for k, v in stats.items() if isinstance(v, (int, float, str))}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.serve_demo")
    ap.add_argument("--arch", default="gemma-2b", choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--batcher", default="continuous", choices=("continuous", "wave"),
                    help="continuous = paged-KV slots refilled per request "
                         "(production path); wave = lock-step baseline")
    ap.add_argument("--gossip-ckpt", default=None,
                    help="decode from a gossip-trained checkpoint "
                         "(train_100m's output); implies --preset's config")
    ap.add_argument("--preset", default="small",
                    help="train_100m preset the checkpoint was trained with")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.gossip_ckpt:
        from repro_torch.examples.train_100m import PRESETS, make_config

        if args.preset not in PRESETS:
            ap.error(f"--preset must be one of {sorted(PRESETS)}")
        cfg, _ = make_config(args.preset)
        params = load_consensus_params(args.gossip_ckpt, cfg, device=dev)
        print(f"serving consensus average of gossip checkpoint "
              f"{args.gossip_ckpt} ({cfg.name})")
    else:
        cfg = get_config(args.arch, reduced=True)
        params = Mo.init(torch.Generator().manual_seed(0), cfg, device=dev)
    print(f"serving {cfg.name}: d_model={cfg.d_model} layers={cfg.n_layers}")
    rec = serve(params, cfg, args.batcher, args.requests, np.random.default_rng(0))
    rec.update(arch=cfg.name, gossip_ckpt=args.gossip_ckpt, device=str(dev))
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "serve_demo.json"), "w") as fp:
        json.dump(rec, fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
