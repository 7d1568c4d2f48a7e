#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--collect]

Drives the port (``src/repro_torch``; nothing of JAX or of the JAX package)
through these phases, in order, and exits non-zero at the first failure:

1. device — needs CUDA; prints the card's name and power limit as
   ``nvidia-smi`` reports them; turns TF32 off for float32 products.
2. build — compiles every kernel of the paths below from the sources in this
   checkout (``nvcc``, ``sm_90a``), one compiler per source, all started
   together, and prints the build time, each kernel's registers and spills
   (``ptxas -v``) and the count of ``HGMMA`` instructions in the
   flash_attention library's SASS (``cuobjdump``): none fails the run, as
   the bf16 route must run on the tensor cores.
3. kernel check — holds each kernel against its plain PyTorch version on the
   card at small and odd shapes and at the shapes its paths give it (for
   gossip_mix: k=2 for the ring, k=1 for the one-peer ring), then times
   kernel and plain version with CUDA events. gossip_mix: float32 atol
   1e-5, bf16 atol 5e-2 (the reference's kernel-test tolerances).
   quant_pack: values and scales exactly equal (float32 and bf16 input, odd
   rows and columns, an unaligned buffer, zero rows, half-way ties, negative
   values). consensus_stats: rtol 1e-5, atol 1e-6 on small trees (float32
   and bf16, 2, 8 and 16 workers, the worker mesh's column sums) and at
   slice 1's tree, two calls bit-identical. Every training phase below
   also counts its consensus_stats launches: one per dtype group of the
   params a step, two on a live worker mesh.
4. slice 1 — ``repro_torch.train.loop.train``: the decentralized step of
   paper eq. (3) on granite-3-2b at its published widths, depth cut to 4
   layers, M=4 workers on a ring, momentum SGD, the fused gossip bus. Checks
   finite losses, one gossip_mix launch per step, and that one fused step
   from the trained state matches the einsum-backend step within the bf16
   tolerance; profiles one step.
5. slice 2 — the same model, batches and optimizer on ``hier(2, 2)`` (a ring
   of 2 pods ⊗ a clique of 2 inside each) with ``GossipSpec(hierarchical=
   True)``: 5 ``train()`` steps with exactly two gossip_mix launches each
   (intra-pod, cross-pod), one hierarchical step against one einsum step on
   the unsplit matrix within the bf16 tolerance, a profiled step; then 8
   rounds of ``hierarchical_mix_compressed(dci_dtype="int8")`` on the
   trained params with the error-feedback residual carried, exactly one
   quant_pack and one gossip_mix launch per round, round 1 within half the
   largest row scale plus one bf16 ulp of the exact ``hierarchical_mix``,
   a profiled round.
6. checkpoint — ``export_consensus`` of slice 1's trained worker-stacked
   params to an npz under ``build/``; ``load_consensus_params`` of it must
   equal ``consensus_params`` of the in-memory params bit for bit.
6a. launch — ``repro_torch.launch``'s cost recorder on slice 1's step: A,
   the fused step (M=4 ring) under ``launch.cost.measure`` on ``meta``
   tensors (``gossip_mix`` through its meta branch, reporting its work);
   B, the same step on the card from the same state: FLOPs and bytes
   equal to A's exactly, one ``gossip_mix`` event in each and no
   collective (the meta peak printed beside ``max_memory_allocated``, not
   gated); C, slice 3's prefill wave (4 x 3072, full depth) on both: equal
   FLOPs and 40 ``flash_attention`` events each; D, B's roofline terms at
   the card's rates (``launch.roofline``, the one home of the rates this
   script bounds its kernels with) against slice 1's measured ms/step:
   the bound's share must be at most 1.05, and the MFU is printed; E, the
   dry-run CLI's ``--smoke`` must exit 0, and its full-width run of
   granite-3-2b x train_4k on the single-pod mesh, started after the
   build on one host core beside the card's phases, must have exited 0
   before the report (it waits at most ``LAUNCH_DRYRUN_TIMEOUT`` s).
7. slice 5 — the same model and batches on the one-peer time-varying ring
   (``GossipSpec(time_varying="one_peer_exp")``, M=4): 5 ``train()``
   steps of ``momentum_sgd(warmup_cosine(0.01, 2, 5), 0.9)`` with
   worker-sharded asynchronous checkpoints every 2 steps, exactly one k=1
   gossip_mix launch per step; the shards restore to the trained params bit
   for bit, and ``consensus_from_sharded`` and ``load_consensus_params`` of
   them equal ``consensus_params`` bit for bit. Then a fused one-peer step
   at an even and at an odd step against an einsum step on that round's
   dense matrix, a ``microbatch=2`` momentum step against ``microbatch=1``
   (both within the bf16 tolerance), 2 Adam steps and 1 Adafactor step at
   ``microbatch=2`` (finite losses), and ``survivor_mix`` /
   ``survivor_hierarchical_mix`` with a dead worker (its slice bit-equal to
   its input, the live ones within the bf16 tolerance of a float32 einsum
   with the repaired matrices). Prints ms/step with and without a
   checkpoint in flight, the writer's seconds and each part's peak memory.
8. paper (in a process of its own, ``chip_smoke.py --phase paper OUT``,
   beside slices 8-10, once the dry run's host core is free) — the
   paper's Fig. 2 (``benchmarks/bench_fig2.py``'s settings):
   ``problems.run_dsm`` of the classifier (150 steps, lr 0.5) and the LM
   (60 steps, lr 0.1) at M=8 on degrees 2, 4 and 7, random and by-label
   splits; prints the 12 tail losses and each one's gap to the clique;
   every curve finite and within 1e-4 relative of the port's own CPU run of
   the same seeds. The classifier on the ring (random split) also runs
   through ``train()`` on the fused bus: one gossip_mix launch per step,
   per-step losses within 1e-4 relative of ``train()`` on einsum, whose
   final global loss must be run_dsm's last point exactly.
9. sim — ``run_simulated`` at slice 1's width and batches (M=4 ring,
   momentum SGD, heavy-tail compute times): 4 sync rounds with slice
   commits (einsum) and with full commits (fused bus, one gossip_mix launch
   per commit), the same event schedule, params and committed losses within
   the bf16 tolerance; the batched commit's ms at J=1 and J=4; 4 async
   rounds with finite losses; a sync run whose worker 1 fails round 3 past
   its retries and is restored from the checkpoint's consensus, bit for bit.
10. telemetry — the full-commit run again for 2 rounds inside
   ``telemetry.run`` with health gauges: ``bus.mix_calls`` in
   telemetry.json equals the fused commits, the gauges are finite,
   perfetto.json is a valid Chrome trace, and a profiled fused step shows
   the ``bus.fused_mix`` range around the gossip_mix launch.
11. slice 3 — serving granite-3-2b at its published widths and full depth
   (40 layers, bf16, seeded random weights): a ``WaveBatcher`` with 4 slots
   serves 8 requests of a 3072-token prompt and 64 new tokens (128 until
   slice 13 needed the time). Checks
   exactly one flash_attention launch per layer in each wave's prefill,
   finite logprobs, and that one wave's last-position prefill logits
   through the kernel agree with the same prefill through the training
   path's ``blockwise_attention``; times prefill and decode, reads peak
   memory and profiles one prefill and one decode step; the profiled
   prefill must run the wgmma kernel once per layer and never the float32
   one (a profile that lost launches is taken again, up to 3 sessions;
   a float32 launch or too many launches fail at once; so for slices 8 to
   10).
12. slice 7 — continuous batching of granite-3-2b at its published widths
   and full depth: a ``ContinuousBatcher`` (8 slots, pages of 16 tokens,
   ``max_len`` 2048, buckets ``default_buckets(16, 2048)``, ``warmup()``
   first) serves a 32-request trace (``benchmarks/bench_serving.py``'s
   Poisson day/night arrivals, prompts of 3-1024 tokens, 24 or 192 new
   tokens, replayed at saturation), then ``WaveBatcher`` (8 slots) the same
   trace. Checks every request served in full, ``decode_traces == 1``,
   ``bucket_misses == 0`` and ``retire_traces == 1`` after the pass, no
   gossip_mix or quant_pack launch; one decode step through the CUDA graph
   equal bit for bit to the same step run eagerly on a copy of the state;
   one request admitted alone and stepped 4 times, its next logits against
   the dense-cache route (``prefill`` + ``decode_step``) within twice the
   dense route's distance from a float32 forward plus 1e-5. Prints tokens/s
   and time to first token of both batchers, decode ms/step through the
   graph and eagerly against its byte bound, occupancy, peak memory, a
   profiled graph step by kernel kind, and the greedy tokens' agreement
   with one-at-a-time ``generate()`` (first 16 of each request; not gated:
   random bf16 weights give near-flat logits).
13. slice 8 — the other model families at their published widths, bf16,
   random weights drawn on the card, one model at a time: a
   ``WaveBatcher`` wave each whose prompt takes the flash kernel (gemma-2b
   4 x 3072 + 32 and deepseek-7b 2 x 3072 + 32 at full depth;
   chameleon-34b at 8 layers and nemotron-4-340b at 2, 2 x 2048 + 16;
   mixtral-8x7b at 8 layers, 2 x 6144 + 64 over its 4096-token window).
   Checks one flash_attention launch per layer and nothing else, every
   request in full, the same tokens and finite logprobs through
   ``generate()``, the last-position prefill logits through the kernel
   against the blockwise route within twice the blockwise route's distance
   from a float32 forward (each layer upcast only while it runs) plus
   1e-5, a profiled prefill running the wgmma kernel once per layer and
   never the float32 one, and for mixtral 8 decode steps through the ring
   cache against a full-length cache with the window mask, within twice
   the full route's float32 distance plus 1e-5. Then gemma-2b through a
   ``ContinuousBatcher`` (4 slots, ``max_len`` 512, buckets up to 256, 8
   requests): every request in full, one graph replay per decode,
   ``bucket_misses == 0``, graph step = eager step bit for bit. Last, 5
   ``train()`` steps each of reduced mixtral and gemma in bf16 on a ring
   of 4 (fused bus): finite losses, one gossip_mix launch per step, a
   fused step against an einsum step within the bf16 tolerance.
14. slice 9 — MLA, Mamba-2 and the RG-LRU hybrid at their published widths
   and full depth, bf16, random weights drawn on the card, one model at a
   time, each through one ``WaveBatcher`` wave with slice 8's gates:
   deepseek-v2-lite-16b (2 x 3072 + 32; MLA's prefill takes the flash
   kernel at qk head dim 192 with v zero-padded from 128: one launch per
   layer), mamba2-2.7b (4 x 3072 + 32, no attention: no launch; its prompt
   and 8 recurrent decode steps against one re-prefill of the extended
   sequence through the chunked form, within twice the re-prefill's
   float32 distance plus 1e-5) and recurrentgemma-2b (4 x 3072 + 32: one
   launch per local layer at hd 256, MQA, window 2048, so the ring wraps
   in prefill; 8 decode steps through the ring against a full-length
   cache with the window mask). Then deepseek-v2-lite through a
   ``ContinuousBatcher`` over the paged MLA cache (4 slots, ``max_len``
   512, buckets up to 256, 8 requests; its 64-expert MoE inside the CUDA
   graph): every request in full, one graph replay per decode,
   ``bucket_misses == 0``, graph step = eager step bit for bit, paged
   against dense next logits within twice the dense route's float32
   distance; it times a graph decode step and profiles one. For each MoE
   config (mixtral in slice 8 too) it prints, not gated, per MoE layer the
   tokens whose router picks differ between the kernel and blockwise
   prefills. Last, 5 ``train()`` steps of mamba2-2.7b at its published
   widths cut to 4 layers, and of reduced deepseek-v2-lite and
   recurrentgemma, in bf16 on a ring of 4 (fused bus): finite losses, one
   gossip_mix launch per step, a fused step against an einsum step within
   the bf16 tolerance.
15. slice 10 — the encoder-decoder, seamless-m4t-large-v2, at its published
   widths and full depth (24 encoder and 24 decoder layers, bf16, random
   weights drawn on the card). The main path is one ``generate(...,
   enc_embeds=...)`` of 4 requests, each 4096 seeded random frame
   embeddings (the speech frontend is a stub), an 8-token prompt and 128
   new tokens: exactly one flash_attention launch per encoder layer (the
   encoder's non-causal self-attention; the decoder's 8-token prompt and
   its cross-attention stay dense) and nothing else; finite logprobs and
   the same greedy tokens from a second ``generate``. Then the
   last-position prefill logits with the encoder on the kernel against
   the encoder on ``blockwise_attention`` (check_prefill's tolerance), a
   prefill plus one decode step over the precomputed cross K/V against an
   uncached ``forward`` of the prompt and that token over the same
   memory (twice the uncached route's float32 distance plus 1e-5), a
   profiled prefill (the wgmma kernel once per encoder layer, no float32
   one), a profiled decode step and the logits product's share of it at
   the vocab's unaligned 256206 columns, beside the same product over a
   16-byte-aligned copy of the head. Last, 5 ``train()`` steps at
   published widths cut to 2 encoder and 2 decoder layers, M = 2 on the
   clique (gossip_mix at k = 1), 2 x 512 tokens and 2 x 4096 frames per
   worker: finite losses, one gossip_mix launch per step, no
   flash_attention launch, a fused step against an einsum step within the
   bf16 tolerance, the peak memory.
16. slice 11 — ``cfg.remat`` and the worker mesh. Slice 1's training shape
   (granite-3-2b, 4 layers, M = 4 ring, 8 x 512 tokens per worker) trained
   5 steps with remat off and on: finite losses, one gossip_mix launch per
   step; each one's peak (allocated and reserved), ms/step over steps 1-4
   and launches per step. On the remat run's params, the worker mesh: a
   world-size-1 NCCL process group (a FileStore in a temporary directory),
   the live 1 x 1 ``WorkerMesh`` hosting the 4 workers, ``mix_pytree`` on
   the fused bus, the per-model-shard bus (``param_specs``) and two int8
   rounds of ``mix_bus_compressed``, each equal to the meshless path bit for
   bit, exactly 2 gossip_mix and 2 quant_pack launches, both kernels seen
   in a profile of the route (after one traced warm-up round, up to 3
   sessions: late in a run the profiler has lost the start of its
   windows); a single worker gets its params back and
   launches nothing; the ``ppermute`` and ``allreduce`` backends (NCCL's
   all-reduce) within the bf16 tolerance of the einsum mix; the process
   group destroyed. Then the remat gate: one vmapped step's loss and
   gradients with remat on and off (2 x 512 tokens per worker) equal bit
   for bit, or, where a card kernel is not deterministic, within twice the
   remat-off route's distance from a float32 gradient (it says which held).
   From the reserved peaks at 4 and 6 layers it predicts the deepest
   granite at M = 4 under 75 GB with remat and trains it 5 steps. Then
   slice 10's training shape (seamless 2 + 2 layers, M = 2 clique) with
   remat off and on, and, not gated, the bf16 router's top-k sets over two
   identical forwards of deepseek-v2-lite-16b at published widths (2
   layers, 2 x 1024 tokens) and one step's gradients with remat on and off.
   Every phase before it trains with remat where its config sets it (the
   full configs do; the reduced ones do not), as the reference does.
17. slice 12 — decentralized training over the worker axes of a live mesh:
   slice 1's training shape with remat on (granite-3-2b, 4 layers, M = 4
   ring, ``momentum_sgd(0.01, 0.9)``, 8 x 512 tokens per worker) trained 5
   steps meshless and through ``train(mesh=wm, param_specs=param_pspecs(
   cfg, wm, 'gossip'))`` on a world-size-1 NCCL group's live 1 x 1
   ``WorkerMesh`` (all 4 workers on the rank), in pairs from the same
   seeds: with a monolithic checkpoint at the end (streamed to the mesh's
   first rank), with asynchronous sharded checkpoints every 2 steps (the
   mesh run through the bare DeviceMesh, whose shards keep the meshless
   ``w{j}`` names, as the reference's train() names them for a raw mesh),
   and in ``mode='allreduce'``. Gates: losses and final params bit-equal
   to meshless, one gossip_mix launch per gossip step (none in allreduce
   mode), the checkpoint files' npz members byte-equal to the meshless
   run's, the async sharded save raising the device peak by less than
   half the tree's bytes. Prints ms/step and the peaks (allocated and
   reserved) of each pair. Then ``run_simulated(mesh=WorkerMesh)`` at
   slice 1's width on an abstract (pod, data) = (2, 2) mesh, the hier
   protocol on ``hier(2, 2)`` for 4 rounds: each link class's bytes equal
   its messages times the mirrored ``sim_payload_bytes``.
18. slice 13 — tensor-parallel training over the model axis: slice 1's
   training shape with remat on, 5 steps of ``train(mesh=..., param_specs=
   param_pspecs(cfg, wm, 'gossip'))`` on a live (data=1, model=2)
   ``WorkerMesh`` of two processes that share the card (the script run
   as ``chip_smoke.py --tp-rank R DIR``) in a gloo group on CUDA tensors,
   NCCL refusing two ranks on one device; one asynchronous sharded
   checkpoint. Each rank holds half of every leaf the specs shard (the
   attention heads and the MLP's ``ff``; vocab 49155 is odd, so the
   embedding stays whole) and the workers' whole batches. Rank 0 then
   trains the meshless twins of the same seeds, bf16 and float32. Gates:
   finite losses, the same on both ranks; one gossip_mix launch per step
   per rank, over the rank's half of the bus rows; the ranks' params
   (gathered over the model group) and losses within twice the meshless
   bf16 run's distance from the float32 run; the checkpoint restored
   onto the mesh bit-equal to each rank's params; each rank's peak
   allocated below the meshless run's. Prints ms/step (gloo-staged, not
   NCCL), the peaks and the save's write time.
19. slice 14 — the model axis for MoE, MLA and the encoder-decoder, in slice
   13's two processes on the same mesh. A: deepseek-v2-lite-16b at its
   published widths (MLA, 64 experts top-6 cut 32 per rank, 2 shared
   experts, vocab 102400 cut in two) cut to its dense first layer and one
   MoE layer; B: seamless-m4t-large-v2 at slice 10's training shape (2 + 2
   layers, 4096 frames per row, vocab 256206 cut in two); each with remat,
   M = 2 on the ring, 3 steps of ``train(mesh=, param_specs=)`` and one
   async sharded checkpoint. Gates: finite losses, the same on both ranks;
   one gossip_mix launch per step per rank over the rank's half of the bus
   rows; the checkpoint restored onto the mesh bit-equal; each rank's peak
   allocated below the meshless bf16 run's (rank 0 trains it after each
   config while rank 1 waits, its part freed); the step-0 token losses of a forward on the mesh
   within twice the meshless bf16 forward's mean distance from a float32
   forward of the same params and batch (one worker at a time). The params
   after the steps are reported beside the meshless run's, not gated. C:
   the narrow float32 mixtral, deepseek-v2-lite and seamless configs of
   ``tests/test_torch_train_tp_moe.py``, two steps on the mesh against the
   meshless step, rtol 1e-5 / atol 1e-6. D: reduced mixtral routed over the
   whole batch in allreduce mode on a (data=2, model=1) mesh of the same
   processes, its rows cut over them, against the meshless allreduce step
   over the whole batch at the same tolerance.
20. slice 15 — Mamba-2 and RG-LRU on the model axis, and serving on a mesh,
   in the same processes and mesh. A, B: mamba2-2.7b (4 of 64 layers; 80
   heads, vocab 50280 cut in two) and recurrentgemma-2b (3 of 26: two
   RG-LRU layers and a local-attention one; width 2560 and vocab 256000
   cut in two) at published widths, trained and gated as slice 14's A, B.
   C: their narrow float32 configs of
   ``tests/test_torch_train_tp_recurrent.py`` against the meshless step.
   E: serving at published widths, each consensus loaded onto the mesh
   by ``load_consensus_params(mesh=)`` (the trained ones from their
   sharded saves, the others from a checkpoint of seeded weights):
   granite-3-2b (40 layers), gemma-2b (MQA: the decode cache cut over the
   sequence), deepseek-v2-lite-16b (MLA), recurrentgemma and mamba2, one
   WaveBatcher wave each of 1088-token prompts past the flash threshold,
   and seamless-m4t-large-v2 (2 + 2 layers) through
   ``generate(enc_embeds=)`` over 4096 frames; granite's first 8 requests
   of slice 7's trace through ``ContinuousBatcher(mesh=)``; the narrow
   float32 configs of ``tests/test_torch_serve_tp.py``. Gates: one
   flash_attention launch per attention layer per wave on each rank (the
   bf16 kernel on the rank's heads), the same tokens on both ranks; the
   last prefill position's logits within twice the meshless bf16
   prefill's mean distance from a float32 forward (rank 0, after each
   config, rank 1 waiting); every continuous request in full, its decode
   eager (no CUDA graph over gloo); the narrow configs' greedy tokens
   equal to meshless. Each checkpoint is removed once read.
21. examples — the entry points of ``repro_torch.examples``, each through
   its ``main(argv)`` with ``--device cuda``, at its default size:
   ``train_100m --preset full`` (49.8M parameters, M = 4 ring, 300 steps)
   meshless and with ``--mesh`` (a world-size-1 NCCL group, the 4 workers
   on the rank, the fused bus): finite losses, the last below the first,
   the checkpoint written, one gossip_mix launch per step of the mesh run
   (path ``examples_train_100m_mesh``) and none meshless; ``serve_demo
   --gossip-ckpt`` of the mesh run's checkpoint with the continuous and the
   wave batcher, every request answered in full; ``topology_matters``, its
   four tail losses within 1e-4 relative of its CPU run; ``quickstart``.
   These runs on the card go in a process of their own (``chip_smoke.py
   --phase examples OUT``, at most ≈ 20 GB of the card) started after
   slice 5, beside sim, telemetry, serve and continuous, and read before
   slice 8. The six simulator examples (fleet_wallclock at ``--quick``,
   which keeps M = 512) run in ``EX_SIM_PROCS`` worker processes and the
   command lines (``python -m`` of ``train_100m --preset small --steps 6``,
   then of ``serve_demo`` of its checkpoint) in a subprocess, all started
   before slice 12 and read here: each exits 0, and each simulator example's
   claim holds in what it wrote (``EX_SIM``'s gates), and
   ``outage_wallclock --trace``'s bundles pass ``telemetry.report
   --check``. Prints each run's wall seconds, train_100m's ms/step (steps 2
   onward), tokens/s and peak, and the simulator examples' host seconds
   per virtual round.
22. report — the run's time, one JSON line of kernels, the nvidia-smi line,
   and last the ``{"ok": true, ...}`` line.

``--collect`` runs ``gc.collect()`` before each part (and the microbatch=2
step), so each part's peak memory can be compared with the default run's,
which collects nothing: equal peaks mean no reference cycle holds device
memory between the parts.

The flash_attention kernel check (phase 3) uses the reference's
kernel-test tolerances, float32 atol 2e-5 and bf16 3e-2, and holds bf16
besides to one bf16 ulp of the plain value plus 1e-4, element by element;
at the serving prefill's shape it runs both dtypes, each on its own kernel
(bf16: wgmma tensor cores and TMA; float32: CUDA cores), and prints each
one's time and TFLOP/s, each beside its bound (bf16 at the tensor cores'
rate, float32 at the CUDA cores') and ``scaled_dot_product_attention`` in
the same dtype. Its cases cover head dims 16 to 256 (hd 256 in MQA with a
2048-token window among them) and v zero-padded from 128 to 192, as MLA's
prefill passes it; it also times the bf16 kernel at slice 8's and slice
9's prefill shapes (gemma-2b's, nemotron's, mixtral's windowed one,
deepseek-v2-lite's MLA with the padded v, recurrentgemma's windowed MQA)
and at slice 10's (seamless-m4t-large-v2's encoder, non-causal over 4096
frames) beside its bound, its plain version and
``scaled_dot_product_attention`` (with an explicit boolean mask for a
window, which that call has no argument for; with v at its own head dim
128 for MLA; with no mask and ``is_causal=False`` for the encoder).
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Slice configuration (PERF.md, "Cells").
M_WORKERS = 4
N_LAYERS = 4            # granite-3-2b has 40; cut so M replicas + state fit
PER_WORKER_BATCH = 8
SEQ_LEN = 512
STEPS = 5
LR = 0.01
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
DCI_ROUNDS = 8          # compressed cross-pod rounds of slice 2
FLASH_TOL = {"float32": 2e-5, "bfloat16": 3e-2}
SERVE_SLOTS = 4         # slice 3: WaveBatcher slots
SERVE_REQUESTS = 8
PROMPT_LEN = 3072       # a multiple of blockwise_attention's 1024 chunk
NEW_TOKENS = 64         # 128 until slice 13's phase needed the time
SERVE_MAX_LEN = PROMPT_LEN + NEW_TOKENS   # inside granite's 4096 context
CB_SLOTS = 8            # slice 7: ContinuousBatcher (and WaveBatcher) slots
CB_PAGE = 16
CB_MAX_LEN = 2048       # inside granite's 4096 context
CB_REQUESTS = 32        # the trace (benchmarks/bench_serving.py::make_trace)
# synthetic lengths, from no measured population of users: prompts spread
# over the admission buckets up to 1024, a bimodal output length
CB_MAX_PROMPT = 1024
CB_SHORT_NEW, CB_LONG_NEW, CB_LONG_FRAC = 24, 192, 0.22
CB_AGREE_TOKENS = 16    # tokens per request held against one-at-a-time generate()
PAPER_M = 8             # Fig. 2 (benchmarks/bench_fig2.py): M = 8, degrees 2, 4, 7
PAPER_DEGREES = (2, 4, 7)
PAPER_RTOL = 1e-4       # card vs CPU curves, fused vs einsum losses (PERF.md §6)
PAPER_CPU_PROCS, PAPER_CPU_THREADS = 3, 2   # the CPU twins' pool, beside the card's runs
SIM_ROUNDS = 4          # simulator rounds per run at full width
TEL_ROUNDS = 2
SNAP_DEPTH = 4          # snapshot planes of the barrier protocols (2.75 GB each)
# Slice 8 (PERF.md, Cells): the families at their published widths, cut in
# depth so each model and its wave stay well inside 80 GB and the time limit:
# (config, layers kept (None: all), wave of requests = slots, prompt, new tokens)
S8_SERVE = [
    ("gemma-2b", None, 4, 3072, 32),
    ("deepseek-7b", None, 2, 3072, 32),
    ("chameleon-34b", 8, 2, 2048, 16),
    ("nemotron-4-340b", 2, 2, 2048, 16),
    ("mixtral-8x7b", 8, 2, 6144, 64),
]
CHECK_STEPS = 8         # decode steps of the ring (mixtral, recurrentgemma) and recurrent checks
S8_CB_SLOTS, S8_CB_MAX_LEN, S8_CB_PAGE, S8_CB_BUCKET = 4, 512, 16, 256
S8_CB_REQUESTS = 8
S8_TRAIN = ("mixtral-8x7b", "gemma-2b")   # reduced widths: a correctness check
S8_TRAIN_BATCH, S8_TRAIN_SEQ = 4, 64
# Slice 9 (PERF.md, Cells): MLA, Mamba-2 and the RG-LRU hybrid at their
# published widths and full depth, one wave each, in S8_SERVE's form
S9_SERVE = [
    ("deepseek-v2-lite-16b", None, 2, 3072, 32),
    ("mamba2-2.7b", None, 4, 3072, 32),
    ("recurrentgemma-2b", None, 4, 3072, 32),
]
S9_CONTINUOUS = "deepseek-v2-lite-16b"   # paged MLA, MoE in the graph; S8_CB_* sizes
# training: mamba2 at its published widths cut in depth (M replicas and state
# fit one card), the others reduced in width (2 full-width layers at M = 4
# already hold 4.3 B / 3.6 B params): (config, layers or None for reduced,
# per-worker batch, sequence length)
S9_TRAIN = [
    ("mamba2-2.7b", 4, 2, 512),
    ("deepseek-v2-lite-16b", None, S8_TRAIN_BATCH, S8_TRAIN_SEQ),
    ("recurrentgemma-2b", None, S8_TRAIN_BATCH, S8_TRAIN_SEQ),
]
# Slice 10 (PERF.md, Cells): seamless-m4t-large-v2 at its published widths
# and full depth served through generate(enc_embeds=): (requests, prompt
# tokens, new tokens), each request with cfg.encoder_seq (4096) frames
S10_NAME = "seamless-m4t-large-v2"
S10_SERVE = (4, 8, 128)
# training at published widths cut to 2 encoder + 2 decoder layers (the
# embedding and lm_head alone hold 524.6 M params) at M = 2 on the clique:
# (layers, workers, per-worker batch, tokens per sequence)
S10_TRAIN = (2, 2, 2, 512)
# Slice 11 (PERF.md, Cells): cfg.remat on and off at slice 1's training shape
# and slice 10's; the deepest granite-3-2b at M = 4 whose peak with remat,
# predicted from the measured bytes per layer, stays under REMAT_BUDGET_GB;
# the remat gradient gate at slice 1's width with S11_GATE_BATCH x SEQ_LEN
# tokens per worker (its float32 fallback must fit beside it); bf16 router
# picks of two identical forwards at S11_MOE = (config, layers, batch, seq);
# a world-size-1 NCCL mesh hosting slice 1's M workers.
REMAT_BUDGET_GB = 75.0
DEEP_PROBE = 6          # the second depth the bytes per layer are measured at
PROFILE_SESSIONS = 3    # profiler sessions allowed to show a route's kernels (mesh, flash)
S11_GATE_BATCH = 2
S11_MOE = ("deepseek-v2-lite-16b", 2, 2, 1024)
# slice 13: slice 1's training shape over a live (data=1, model=2) mesh of
# two processes sharing the card, a gloo group on CUDA tensors (NCCL
# refuses two ranks on one device); each rank's share of the phase's time
S13_RANKS = 2
S13_TIMEOUT = 900
# slice 14: the model axis for MoE, MLA and the encoder-decoder, in slice
# 13's two processes: (config, layers, workers, per-worker batch, tokens
# per sequence) at published widths, remat on, S14_STEPS steps each:
# deepseek-v2-lite-16b cut to its dense first layer and one MoE layer, and
# seamless-m4t-large-v2 at slice 10's training shape (2 + 2 layers)
S14_TRAIN = (("deepseek-v2-lite-16b", 2, 2, 4, 512), (S10_NAME, 2, 2, 2, 512))
S14_STEPS = 3
# the narrow float32 configs of tests/test_torch_train_tp_moe.py, held to
# the meshless float32 step on the card at rtol 1e-5 / atol 1e-6
S14_NARROW = dict(n_layers=2, d_model=64, n_heads=8, head_dim=8, d_ff=128, vocab_size=256,
                  param_dtype="float32", compute_dtype="float32")
S14_ARCHS = {"mixtral-8x7b": dict(n_kv_heads=2, n_experts=8, top_k=2, d_ff_expert=32),
             "deepseek-v2-lite-16b": dict(n_kv_heads=8, n_experts=8, top_k=3, d_ff_expert=32,
                                          n_shared_experts=2),
             "seamless-m4t-large-v2": dict(n_kv_heads=8)}
S14_NARROW_SHAPE = (2, 4, 16, 8)   # workers, rows per worker, tokens per row, frames
S14_RTOL, S14_ATOL = 1e-5, 1e-6
# slice 15: Mamba-2 and RG-LRU on the model axis, and serving on a mesh, in
# slice 13's two processes. Training as slice 14's (S14_STEPS steps, one
# async sharded save): mamba2-2.7b at 4 of 64 layers, recurrentgemma-2b at
# 3 of 26 (two RG-LRU layers and a local-attention one)
S15_TRAIN = (("mamba2-2.7b", 4, 2, 2, 512), ("recurrentgemma-2b", 3, 2, 2, 512))
# the narrow float32 configs of tests/test_torch_train_tp_recurrent.py
S15_ARCHS = {"mamba2-2.7b": dict(ssm_headdim=16, ssm_state=16, ssm_chunk=8),
             "recurrentgemma-2b": dict(n_kv_heads=1, lru_width=64, window=32)}
# serving on the (data=1, model=2) mesh at published widths, each consensus
# through load_consensus_params(mesh=): (config, layers (None: all), rows,
# prompt tokens, new tokens); prompts past 1024 tokens take the flash
# kernel; the trained configs come from their sharded saves, the others
# from a consensus checkpoint of seeded weights; seamless encodes its
# 4096 frames (slice 10's)
S15_SERVE = (("granite-3-2b", None, 2, 1088, 32), ("gemma-2b", 6, 2, 1088, 32),
             ("deepseek-v2-lite-16b", 4, 4, 1088, 32), ("recurrentgemma-2b", 3, 2, 1088, 32),
             ("mamba2-2.7b", 4, 2, 1088, 32), (S10_NAME, 2, 4, 8, 32))
# granite through ContinuousBatcher(mesh=): the first requests of slice 7's
# trace, their new tokens capped for the phase's time (an eager decode step
# of 40 layers over gloo takes ≈ 0.3 s)
S15_CB_REQUESTS, S15_CB_MAX_NEW = 8, 48
# the narrow float32 configs of tests/test_torch_serve_tp.py: greedy tokens
# on the mesh equal to meshless
S15_NARROW_SERVE = {
    "granite-3-2b": dict(n_heads=8, head_dim=8, d_ff=128, n_kv_heads=4),
    "gemma-2b": dict(n_heads=8, head_dim=16, d_ff=128, n_kv_heads=1, vocab_size=250),
    "deepseek-v2-lite-16b": dict(n_heads=8, n_experts=8, top_k=3, d_ff_expert=32,
                                 n_shared_experts=2, d_ff=128),
    "recurrentgemma-2b": dict(n_heads=8, head_dim=8, d_ff=128, n_kv_heads=1, lru_width=64,
                              window=8),
    "mamba2-2.7b": dict(ssm_headdim=16, ssm_state=16, ssm_chunk=8),
    S10_NAME: dict(n_heads=8, head_dim=8, d_ff=128, n_kv_heads=8)}
# ``--collect`` runs gc.collect() before each part, as the script did while
# the tree helpers held leaves in reference cycles: each part's peak with
# and without it shows whether a cycle holds device memory again.
COLLECT = "--collect" in sys.argv[1:]



def log(msg: str) -> None:
    print(msg, flush=True)


def collect() -> None:
    if COLLECT:
        gc.collect()


def fresh_gb(label: str, tag: str | None = None) -> float:
    """Collect (with ``--collect``), release the cache, reset the peak;
    print and return the GB still allocated before ``label``."""
    import torch

    collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gb = torch.cuda.memory_allocated() / 1e9
    log(f"[{tag or label}] {gb:.2f} GB allocated before {label}")
    return gb


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_wrappers() -> dict:
    """Each kernel's wrapper by name; a wrapper counts its launches."""
    from repro_torch.kernels.consensus_stats import consensus_stats
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.kernels.quant_pack import quantize_pack_2d

    return {"gossip_mix": gossip_mix_2d, "quant_pack": quantize_pack_2d,
            "flash_attention": flash_attention, "consensus_stats": consensus_stats}


def stats_launches(params, steps: int, mesh: bool = False) -> int:
    """The consensus_stats launches of ``steps`` train steps of ``params``
    (gradients of the params' dtypes): one per dtype group of the tree a
    step, two on a live worker mesh (the gradients' and the params' column
    sums are all-reduced, and launched, apart)."""
    from repro_torch import _tree

    return steps * (2 if mesh else 1) * len({x.dtype for x in _tree.leaves(params)})


def reset_launches() -> None:
    for fn in _kernel_wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _kernel_wrappers().items()}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {torch.cuda.get_device_name(0)}  count={torch.cuda.device_count()}  "
        f"torch {torch.__version__}  cuda {torch.version.cuda}")
    log(f"[device] nvidia-smi: {smi}")
    log("[device] TF32 off for matmul and cuDNN: float32 products run in float32")
    return smi.splitlines()[0]


def phase_build() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.consensus_stats import kernel as cs
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.gossip_mix import kernel as gm
    from repro_torch.kernels.quant_pack import kernel as qp

    t0 = time.perf_counter()
    mods = (gm, qp, fa, cs)
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:   # nvcc runs outside the GIL
        built = list(pool.map(lambda m: (m, m.library()[1]), mods))
    log(f"[build] {len(built)} kernels built in {time.perf_counter() - t0:.2f} s")
    for mod, build_log in built:
        log(f"[build]   {os.path.relpath(mod.SOURCE, ROOT)}")
        for kernel, regs, spills in _ptxas_usage(build_log):
            log(f"[build]     {kernel}: {regs} registers, spills {spills}")
    # the bf16 route must issue wgmma: count HGMMA in the library's SASS
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "--dump-sass",
                           str(_build.library_path("flash_attention", fa.SOURCE))],
                          capture_output=True, text=True, check=True, timeout=300).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    log(f"[build] flash_attention library: {n_hgmma} HGMMA instructions in its SASS "
        f"(cuobjdump --dump-sass)")
    if n_hgmma == 0:
        raise AssertionError("the flash_attention library issues no HGMMA: the bf16 route "
                             "is not on the tensor cores")


def _ptxas_usage(build_log: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spill stores/loads) per entry function that
    ``ptxas -v`` reports; the name is the mangled one's kernel identifier
    and template argument."""
    out, kernel, spills = [], "?", "?"
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            names, i = [], 0
            while i < len(mangled):      # length-prefixed identifiers of the mangled name
                m = re.match(r"\d+", mangled[i:])
                if m:
                    n, i = int(m.group()), i + m.end()
                    names.append(mangled[i:i + n])
                    i += n
                else:
                    i += 1
            kernel = next((w for w in names if "kernel" in w),
                          next((w for w in names if not w.startswith("_GLOBAL")), mangled))
            arg = re.search(r"ILi(\d+)E", mangled)
            kernel += f"<{arg.group(1)}>" if arg else ""
        elif "spill stores" in line:
            spills = line.strip().split(", ", 1)[1]
        elif "Used" in line and "registers" in line:
            out.append((kernel, line.split("Used ")[1].split()[0], spills))
    return out


def _mix_inputs(rows, cols, k, w_dtype, u_dtype, gen):
    import torch

    w = torch.randn((rows, cols), generator=gen, device="cuda").to(w_dtype)
    nbr = torch.randn((k, rows, cols), generator=gen, device="cuda").to(w_dtype)
    wts = torch.softmax(torch.randn(k + 1, generator=gen, device="cuda"), 0).cpu().numpy()
    u = None if u_dtype is None else torch.randn(
        (rows, cols), generator=gen, device="cuda").to(u_dtype)
    return w, nbr, wts, u


def _bound(moved: float, ops: float, card: str, peak: float | None = None) -> tuple[float, str]:
    """Least time (ms) for ``moved`` bytes and ``ops`` operations at the
    ``peak`` rate of their type (float32 on the CUDA cores by default), and
    which of the two bounds it; the card's rates are
    ``repro_torch.launch.roofline``'s."""
    from repro_torch.launch.roofline import F32_PEAK, memory_rate

    t_bytes, t_ops = moved / memory_rate(card), ops / (peak or F32_PEAK)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel_check(card: str) -> dict:
    import torch

    from repro_torch.core import bus
    from repro_torch.kernels.gossip_mix import gossip_mix_2d, gossip_mix_reference
    from repro_torch.kernels.gossip_mix.kernel import work

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for w_dt in (f32, bf16):
        for k in (1, 2, 4):
            for u_dt in (None, w_dt):
                cases.append((1001, 128, k, w_dt, u_dt))      # odd row count
    cases += [(37, 129, 2, f32, f32), (37, 129, 3, bf16, bf16),   # unaligned length
              (1001, 128, 2, bf16, f32), (1001, 128, 2, f32, bf16)]  # mixed dtypes
    worst = 0.0
    for rows, cols, k, w_dt, u_dt in cases:
        w, nbr, wts, u = _mix_inputs(rows, cols, k, w_dt, u_dt, gen)
        eta = 0.1 if u is not None else None
        out = gossip_mix_2d(w, nbr, wts, u, eta)
        ref = gossip_mix_reference(w, nbr, wts, u, eta)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = TOL[str(w_dt).split(".")[1]]
        if not (out.dtype == w.dtype and err <= tol):
            raise AssertionError(f"gossip_mix mismatch {rows}x{cols} k={k} "
                                 f"w={w_dt} u={u_dt}: max|err|={err} > {tol}")
        worst = max(worst, err)
    log(f"[kernel] gossip_mix matches its plain version on {len(cases)} small "
        f"cases (max|err| {worst:.3g})")

    # The main path's shape: M=4 bf16 replicas of the 4-layer full-width
    # model on the bus, (M·R, C) with k=2 ring neighbours and a bf16 update.
    rows = M_WORKERS * slice_bus_group().rows
    w, nbr, wts, u = _mix_inputs(rows, bus.LANE, 2, bf16, bf16, gen)
    out = gossip_mix_2d(w, nbr, wts, u, -1.0)
    ref = gossip_mix_reference(w, nbr, wts, u, -1.0)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    del out, ref
    if err > TOL["bfloat16"]:
        raise AssertionError(f"gossip_mix mismatch at the slice shape: {err}")
    log(f"[kernel] gossip_mix at the slice shape ({rows}, {bus.LANE}) bf16 k=2: "
        f"max|err| {err:.3g} vs plain version")

    ms = time_cuda(lambda: gossip_mix_2d(w, nbr, wts, u, -1.0), iters=20)
    plain_ms = time_cuda(lambda: gossip_mix_reference(w, nbr, wts, u, -1.0), iters=3, warmup=1)
    flops, moved = work(w, nbr, u)     # the figures the wrapper reports to launch.cost
    bound_ms, bound_by = _bound(moved, flops, card)
    log(f"[kernel] gossip_mix {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del w, nbr, u
    torch.cuda.empty_cache()

    # Slice 5's shape: the same rows, one one-peer neighbour (k=1).
    w, nbr, wts, u = _mix_inputs(rows, bus.LANE, 1, bf16, bf16, gen)
    out = gossip_mix_2d(w, nbr, wts, u, -1.0)
    ref = gossip_mix_reference(w, nbr, wts, u, -1.0)
    torch.cuda.synchronize()
    err1 = (out.float() - ref.float()).abs().max().item()
    del out, ref
    if err1 > TOL["bfloat16"]:
        raise AssertionError(f"gossip_mix mismatch at the one-peer shape: {err1}")
    ms1 = time_cuda(lambda: gossip_mix_2d(w, nbr, wts, u, -1.0), iters=20)
    plain_ms1 = time_cuda(lambda: gossip_mix_reference(w, nbr, wts, u, -1.0), iters=3, warmup=1)
    ops1, moved1 = work(w, nbr, u)
    bound_ms1, bound_by1 = _bound(moved1, ops1, card)
    log(f"[kernel] gossip_mix at the one-peer shape ({rows}, {bus.LANE}) bf16 k=1: max|err| "
        f"{err1:.3g} vs plain version; {ms1:.3f} ms (bound {bound_ms1:.3f} ms by {bound_by1}, "
        f"{moved1 / ms1 / 1e6:.0f} GB/s); plain version {plain_ms1:.3f} ms")
    del w, nbr, u
    torch.cuda.empty_cache()
    return {"name": "gossip_mix", "route": "cuda",
            "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
            "replaces": "src/repro/kernels/gossip_mix/kernel.py:45",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "k1_max_abs_err": err1, "k1_ms": ms1, "k1_plain_ms": plain_ms1,
            "k1_bound_ms": bound_ms1, "k1_bound_by": bound_by1}


def phase_stats_check(card: str) -> dict:
    """consensus_stats against its plain version on the card (rtol 1e-5,
    atol 1e-6, the reference tolerance of the port's statistics): small
    trees with odd leaf sizes, a transposed leaf, a leaf with gaps and
    params as the bus's views, in float32 and bf16 at 2, 8 and 16 workers (16 reads its column
    tiles twice), and the worker mesh's form from given column sums; then
    slice 1's tree (M=4 bf16 replicas of the 4-layer full-width model as
    the bus hands them out, fresh gradients): two calls bit-identical, one
    launch per call, and the kernel and the plain version timed."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.kernels.consensus_stats import (column_sums, consensus_stats,
                                                     consensus_stats_reference, plan)
    from repro_torch.kernels.consensus_stats.kernel import work
    from repro_torch.models import model as Mo

    gen = torch.Generator(device="cuda").manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16

    def views(tree):
        layout = bus.plan_layout(tree)
        return _tree.leaves(bus.unpack(bus.pack(tree, layout), layout))

    def small(workers, dtype):
        leaves = [torch.randn((workers,) + shape, generator=gen, device="cuda") * 2.0 ** i
                  for i, shape in enumerate([(37,), (5, 13), (129, 64), (3, 101)])]
        leaves.append(torch.randn((workers, 13, 9), generator=gen,
                                  device="cuda").transpose(1, 2))
        # half of a wider dim, as a model axis's shard leaves a gradient
        leaves.append(torch.randn((workers, 4, 160), generator=gen, device="cuda")[..., :80])
        return [x.to(dtype) for x in leaves]

    def check(label, grads, params, M, **kw):
        p = plan(grads, params, M, **kw)
        before = consensus_stats.launches
        got = consensus_stats(p)
        want = consensus_stats_reference(grads, params, M, **kw)
        torch.cuda.synchronize()
        if consensus_stats.launches - before != len(p.groups):
            raise AssertionError(f"consensus_stats {label}: "
                                 f"{consensus_stats.launches - before} launches, want "
                                 f"{len(p.groups)}")
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6,
                                   msg=lambda m: f"consensus_stats {label}: {m}")
        return p, got, ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()

    worst = 0.0
    for dtype in (f32, bf16):
        for M in (2, 8, 16):
            grads = small(M, dtype)
            _, _, err = check(f"{dtype} M={M}", grads, views(dict(enumerate(small(M, dtype)))),
                              M, grad_sharded=[i % 2 == 0 for i in range(len(grads))])
            worst = max(worst, err)
        grads, params = small(4, dtype), views(dict(enumerate(small(4, dtype))))
        sums = [[v.mul_(2) for v in column_sums(t)[1]] for t in (grads, params)]
        _, _, err = check(f"{dtype} 4 of M=8 workers from column sums", grads, params, 8,
                          grad_sums=sums[0], param_sums=sums[1])
        worst = max(worst, err)
    log(f"[kernel] consensus_stats matches its plain version on 8 small cases (largest "
        f"relative gap {worst:.3g})")

    params = replicate_for_workers(Mo.init(gen, slice_config(), device="cuda"), M_WORKERS)
    params = _tree.map(lambda x: (x.float() + 1e-3 * torch.randn(
        x.shape, generator=gen, device="cuda")).to(x.dtype), params)
    params = views(params)
    grads = [(1e-3 * torch.randn(x.shape, generator=gen, device="cuda")).to(x.dtype)
             for x in params]
    p, got, err = check("at slice 1's tree", grads, params, M_WORKERS)
    identical = torch.equal(consensus_stats(p), got)
    if not identical:
        raise AssertionError("consensus_stats: two calls on the same inputs differ")
    ms = time_cuda(lambda: consensus_stats(p), iters=20)
    plain_ms = time_cuda(lambda: consensus_stats_reference(grads, params, M_WORKERS),
                         iters=3, warmup=1)
    ops, moved = sum(work(g)[0] for g in p.groups), p.nbytes
    n = sum(x[0].numel() for x in params)
    if moved != 2 * M_WORKERS * n * 2:
        raise AssertionError(f"consensus_stats reads {moved} B, want 2·M·P·2 = "
                             f"{2 * M_WORKERS * n * 2}")
    bound_ms, bound_by = _bound(moved, ops, card)
    log(f"[kernel] consensus_stats at slice 1's tree (M={M_WORKERS}, P={n:,}, bf16, "
        f"{len(params)} leaves): largest relative gap {err:.3g} vs plain version, two calls "
        f"bit-identical; {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del params, grads, p, got
    torch.cuda.empty_cache()
    return {"name": "consensus_stats", "route": "cuda",
            "source": "src/repro_torch/kernels/consensus_stats/csrc/consensus_stats.cu",
            "replaces": None, "max_rel_err": err, "small_max_rel_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


def _quant_cases(gen):
    """(label, x) small cases for quant_pack, each with its own hazard."""
    import torch

    f32, bf16 = torch.float32, torch.bfloat16
    scaled = lambda r, c: (torch.randn((r, c), generator=gen, device="cuda")
                           * torch.rand((r, 1), generator=gen, device="cuda") * 100)
    cases = []
    for dt in (f32, bf16):
        cases.append((f"{dt} odd rows", scaled(1001, 128).to(dt)))
        cases.append((f"{dt} odd cols", scaled(37, 129).to(dt)))
        flat = scaled(1, 1001 * 128 + 1).to(dt).view(-1)
        cases.append((f"{dt} unaligned buffer", flat[1:].view(1001, 128)))
        z = scaled(64, 128).to(dt)
        z[5] = 0
        z[40] = 0
        cases.append((f"{dt} zero rows", z))
        cases.append((f"{dt} negative", -scaled(64, 128).abs().to(dt)))
        # amax 127 gives scale exactly 1, so k + 0.5 entries are exact ties
        ties = (torch.arange(-64, 64, device="cuda", dtype=f32) + 0.5).repeat(32, 1)
        ties[:, 0] = 127.0
        ties[1::2] *= -1
        cases.append((f"{dt} half-way ties", ties.to(dt)))
    return cases


def phase_quant_check(card: str) -> dict:
    import torch

    from repro_torch.core import bus
    from repro_torch.kernels.quant_pack import quantize_pack_2d, quantize_pack_reference
    from repro_torch.kernels.quant_pack.kernel import work

    gen = torch.Generator(device="cuda").manual_seed(1)
    cases = _quant_cases(gen)
    for label, x in cases:
        v, s = quantize_pack_2d(x, block_r=x.shape[0])
        rv, rs = quantize_pack_reference(x)
        torch.cuda.synchronize()
        if not (v.dtype == torch.int8 and torch.equal(v, rv) and torch.equal(s, rs)):
            bad = (v.int() - rv.int()).abs().max().item()
            raise AssertionError(f"quant_pack mismatch ({label}, {tuple(x.shape)}): "
                                 f"max value diff {bad}, scales equal {torch.equal(s, rs)}")
    log(f"[kernel] quant_pack equals its plain version (values and scales) on "
        f"{len(cases)} small cases")

    # The compressed lane's shape: the (M·R, C) float32 x + residual of the
    # slice's M=4 bf16 replicas.
    group = slice_bus_group()
    rows = M_WORKERS * group.rows
    x = (torch.randn((rows, bus.LANE), generator=gen, device="cuda")
         * torch.rand((rows, 1), generator=gen, device="cuda"))
    v, s = quantize_pack_2d(x, block_r=group.block_r)
    rv, rs = quantize_pack_reference(x)
    torch.cuda.synchronize()
    equal = torch.equal(v, rv) and torch.equal(s, rs)
    err = (v.int() - rv.int()).abs().max().item() * rs.max().item()
    del v, s, rv, rs
    if not equal:
        raise AssertionError(f"quant_pack mismatch at the lane's shape: max|err| {err}")
    log(f"[kernel] quant_pack at the lane's shape ({rows}, {bus.LANE}) float32: "
        f"values and scales equal to the plain version")
    ms = time_cuda(lambda: quantize_pack_2d(x, block_r=group.block_r), iters=20)
    plain_ms = time_cuda(lambda: quantize_pack_reference(x), iters=3, warmup=1)
    ops, moved = work(x)      # the figures the wrapper reports to launch.cost
    bound_ms, bound_by = _bound(moved, ops, card)
    log(f"[kernel] quant_pack {ms:.3f} ms (bound {bound_ms:.3f} ms by {bound_by}, "
        f"{moved / ms / 1e6:.0f} GB/s); plain version {plain_ms:.3f} ms")
    del x
    torch.cuda.empty_cache()
    return {"name": "quant_pack", "route": "cuda",
            "source": "src/repro_torch/kernels/quant_pack/csrc/quant_pack.cu",
            "replaces": "src/repro/kernels/quant_pack/kernel.py:37",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

# (B, Lq, Lkv, H, Hkv, hd, causal, window): the reference's FLASH_CASES
# (tests/test_kernels.py), then lengths off the 64-row tile, Lq != Lkv, a
# window smaller than a tile, MQA, rows past Lkv + window - 1.
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 1, 32, True, 64),
    (2, 128, 128, 4, 4, 64, False, None),
    (1, 64, 64, 2, 2, 128, True, None),
    (1, 128, 128, 4, 2, 16, True, 32),
    (2, 333, 333, 8, 2, 64, True, None),
    (1, 100, 100, 4, 2, 16, True, None),
    (1, 70, 150, 4, 1, 32, True, None),
    (1, 150, 70, 4, 2, 32, True, None),
    (1, 200, 200, 2, 2, 16, True, 5),
    (1, 130, 130, 4, 1, 128, False, 17),
    (1, 150, 70, 4, 2, 32, True, 5),      # rows no key reaches: the mean of v
    (1, 200, 130, 2, 1, 64, False, 40),
    # head dims 192 and 256 (nemotron, gemma): MQA, GQA, windows, lengths off
    # the 64-row kv tile, Lq != Lkv both ways, rows no key reaches
    (1, 200, 200, 8, 1, 256, True, None),
    (2, 333, 333, 4, 2, 192, True, 100),
    (1, 150, 300, 4, 1, 256, True, 64),
    (1, 300, 150, 4, 2, 192, False, None),
    (1, 129, 129, 2, 1, 192, True, None),
    (1, 385, 385, 2, 2, 256, True, 200),
    (1, 150, 70, 4, 2, 256, True, 5),
    (1, 200, 130, 2, 1, 192, False, 40),
    # recurrentgemma-2b's local layers: MQA at hd 256, window 2048, rows past it
    (1, 2300, 2300, 2, 1, 256, True, 2048),
]
# MLA's prefill (deepseek-v2-lite): qk head dim 192, v's 128 zero-padded to
# 192 (B, L, H, hd, hd_v): the output's padding columns must be exact zeros
FLASH_PADDED_V_CASES = [
    (1, 200, 4, 192, 128),
    (2, 333, 2, 192, 128),
]
# The flash kernel's shapes on slice 8's, 9's and 10's prefill paths (B, L,
# H, Hkv, hd, window, hd_v, causal): gemma-2b's wave, nemotron-4-340b's,
# mixtral-8x7b's windowed one, deepseek-v2-lite's MLA (v padded from 128),
# recurrentgemma-2b's windowed MQA, seamless-m4t-large-v2's encoder
# (non-causal over the 4096 frames of each of 4 requests).
FLASH_PATHS = [
    ("gemma-2b", 4, 3072, 8, 1, 256, None, 256, True),
    ("nemotron-4-340b", 2, 2048, 96, 8, 192, None, 192, True),
    ("mixtral-8x7b", 2, 6144, 32, 8, 128, 4096, 128, True),
    ("deepseek-v2-lite-16b", 2, 3072, 16, 16, 192, None, 128, True),
    ("recurrentgemma-2b", 4, 3072, 10, 1, 256, 2048, 256, True),
    ("seamless-m4t-large-v2 encoder", 4, 4096, 16, 16, 64, None, 64, False),
]


def _attn_inputs(B, Lq, Lkv, H, Hkv, hd, dtype, gen, hd_v=None):
    """q, k, v in the model's (B, L, H, hd) layout, as the (B, H, L, hd)
    views ops.attention hands the kernel; with ``hd_v`` < hd, v's columns
    past hd_v are zeros, as MLA's prefill pads them."""
    import torch

    q = torch.randn((B, Lq, H, hd), generator=gen, device="cuda").to(dtype)
    k = torch.randn((B, Lkv, Hkv, hd), generator=gen, device="cuda").to(dtype)
    v = torch.randn((B, Lkv, Hkv, hd_v or hd), generator=gen, device="cuda").to(dtype)
    if hd_v is not None and hd_v < hd:
        v = torch.cat([v, v.new_zeros((B, Lkv, Hkv, hd - hd_v))], dim=-1)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _flash_err(out, ref, dtype, case) -> float:
    """max|err| of the kernel's output against its plain version; raises
    past FLASH_TOL, and for bf16 where an element is off by more than one
    bf16 ulp of the plain value (2^-7·|ref|) plus 1e-4. Both sides round a
    float32 result once to bf16, so they may differ by that rounding only;
    a fixed atol would be as large as a typical output of a long causal row
    (|o| ~ sqrt(e/i) at row i)."""
    import torch

    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = 0.0
    if dtype == torch.bfloat16:
        excess = (diff - 2.0 ** -7 * ref.float().abs() - 1e-4).max().item()
    tol = FLASH_TOL[str(dtype).split(".")[1]]
    if out.dtype != dtype or err > tol or excess > 0:
        raise AssertionError(
            f"flash_attention mismatch {dtype} (B, Lq, Lkv, H, Hkv, hd, causal, window)="
            f"{case}: max|err| {err} (tol {tol}), {excess} past 1 bf16 ulp + 1e-4")
    return err


def phase_flash_check(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_reference, flash_attention
    from repro_torch.kernels.flash_attention.kernel import work
    from repro_torch.launch.roofline import BF16_PEAK, F32_PEAK

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for B, Lq, Lkv, H, Hkv, hd, causal, window in FLASH_CASES:
            q, k, v = _attn_inputs(B, Lq, Lkv, H, Hkv, hd, dtype, gen)
            out = flash_attention(q, k, v, causal=causal, window=window)
            ref = attention_reference(q, k, v, causal=causal, window=window)
            err = _flash_err(out, ref, dtype, (B, Lq, Lkv, H, Hkv, hd, causal, window))
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        for B, L, H, hd, hd_v in FLASH_PADDED_V_CASES:
            q, k, v = _attn_inputs(B, L, L, H, H, hd, dtype, gen, hd_v=hd_v)
            out = flash_attention(q, k, v, causal=True)
            ref = attention_reference(q, k, v, causal=True)
            err = _flash_err(out, ref, dtype, (B, L, L, H, H, hd, True, None))
            if bool(out[..., hd_v:].any()):
                raise AssertionError(f"flash_attention with v zero-padded from {hd_v} to "
                                     f"{hd}: the padding columns of its output are not zero")
            worst[dtype] = max(worst[dtype], err)
    log(f"[kernel] flash_attention matches its plain version on {len(FLASH_CASES)} cases "
        f"and {len(FLASH_PADDED_V_CASES)} with v zero-padded (MLA) x 2 dtypes (max|err| "
        f"float32 {worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g}); the padded "
        f"columns come out exactly zero")

    # The serving slice's prefill: granite-3-2b, B = SERVE_SLOTS, L = PROMPT_LEN.
    cfg = serve_config()
    B, L, H, Hkv, hd = SERVE_SLOTS, PROMPT_LEN, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _attn_inputs(B, L, L, H, Hkv, hd, torch.bfloat16, gen)
    shape = (B, L, L, H, Hkv, hd, True, None)
    # float32 first: the CUDA-core route held to 2e-5 on rows of up to 3072
    # keys, where a bf16 tolerance would hide a lost kv tile; then bf16, the
    # wgmma route, with the same inputs rounded to bf16
    q32, k32, v32 = q.float(), k.float(), v.float()
    err32 = _flash_err(flash_attention(q32, k32, v32, causal=True),
                       attention_reference(q32, k32, v32, causal=True), torch.float32, shape)
    err = _flash_err(flash_attention(q, k, v, causal=True),
                     attention_reference(q, k, v, causal=True), torch.bfloat16, shape)
    log(f"[kernel] flash_attention at the prefill shape q {(B, L, H, hd)} k/v "
        f"{(B, L, Hkv, hd)} causal vs plain version: max|err| float32 {err32:.3g}, "
        f"bf16 {err:.3g}")
    ops, moved = work(q, k, v, True, None)   # q·k and p·v over the causal pairs
    ms32 = time_cuda(lambda: flash_attention(q32, k32, v32, causal=True), iters=5)
    library32_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True, enable_gqa=True), iters=5)
    bound32_ms, bound32_by = _bound(2 * moved, ops, card, peak=F32_PEAK)
    del q32, k32, v32
    torch.cuda.empty_cache()
    ms = time_cuda(lambda: flash_attention(q, k, v, causal=True), iters=20)
    plain_ms = time_cuda(lambda: attention_reference(q, k, v, causal=True), iters=3, warmup=1)
    library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=20)
    bound_ms, bound_by = _bound(moved, ops, card, peak=BF16_PEAK)
    log(f"[kernel] flash_attention bf16 (wgmma) {ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s "
        f"(bound {bound_ms:.3f} ms by {bound_by}; it issues 1.5x these FLOP on the tensor "
        f"cores, P·V twice for the split P); float32 (CUDA cores) {ms32:.3f} ms, "
        f"{ops / ms32 / 1e9:.1f} TFLOP/s (bound {bound32_ms:.3f} ms by {bound32_by} at the "
        f"CUDA cores' {F32_PEAK / 1e12:.0f} TFLOP/s); plain version {plain_ms:.3f} ms; "
        f"scaled_dot_product_attention {library_ms:.3f} ms bf16, {library32_ms:.3f} ms float32")
    del q, k, v
    torch.cuda.empty_cache()
    paths = [_flash_path(card, gen, *shape) for shape in FLASH_PATHS]
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bf16.cuh",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
            "float32_ms": ms32, "float32_bound_ms": bound32_ms, "float32_bound_by": bound32_by,
            "float32_library_ms": library32_ms, "path_shapes": paths}


def _flash_path(card: str, gen, name, B, L, H, Hkv, hd, window, hd_v, causal) -> dict:
    """The bf16 kernel at one path shape of slices 8 to 10: held to its
    plain version, timed beside it, its bound and one library call. The
    library has no window argument, so a windowed shape's library time is
    scaled_dot_product_attention with an explicit boolean mask. With hd_v
    < hd (MLA) the kernel and its plain version take v zero-padded to hd,
    as the model passes it, and the library takes v at its own head dim;
    the bound counts the work at hd_v: 2·(hd + hd_v) FLOP per pair and head
    (every pair without a mask, ``causal=False``)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import attention_reference, flash_attention
    from repro_torch.kernels.flash_attention.kernel import pairs
    from repro_torch.launch.roofline import BF16_PEAK

    q, k, v = _attn_inputs(B, L, L, H, Hkv, hd, torch.bfloat16, gen, hd_v=hd_v)
    shape = (B, L, L, H, Hkv, hd, causal, window)
    ref = attention_reference(q, k, v, causal=causal, window=window)
    err = _flash_err(flash_attention(q, k, v, causal=causal, window=window), ref,
                     torch.bfloat16, shape)
    del ref
    torch.cuda.empty_cache()
    ms = time_cuda(lambda: flash_attention(q, k, v, causal=causal, window=window), iters=10)
    plain_ms = time_cuda(lambda: attention_reference(q, k, v, causal=causal, window=window),
                         iters=1, warmup=1)
    v_own = v[..., :hd_v]
    if window is None:
        library = (f"scaled_dot_product_attention({'is_causal' if causal else 'no mask'}, "
                   "enable_gqa)")
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v_own, is_causal=causal, enable_gqa=True), iters=10)
    else:
        library = "scaled_dot_product_attention(attn_mask=boolean causal window mask, enable_gqa)"
        i = torch.arange(L, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        library_ms = time_cuda(lambda: F.scaled_dot_product_attention(
            q, k, v_own, attn_mask=mask, enable_gqa=True), iters=10)
        del mask
    if hd_v < hd:
        library += f" with v at head dim {hd_v}"
    ops = 2 * (hd + hd_v) * B * H * pairs(L, L, causal, window)
    # q, k in; v at its own head dim in; o at v's head dim out (bf16)
    moved = (q.numel() + k.numel() + B * Hkv * L * hd_v + B * H * L * hd_v) * q.element_size()
    bound_ms, bound_by = _bound(moved, ops, card, peak=BF16_PEAK)
    log(f"[kernel] flash_attention bf16 at {name}'s prefill q {(B, L, H, hd)} k/v "
        f"{(B, L, Hkv, hd)} (v's own head dim {hd_v}) causal {causal} window {window}: max|err| "
        f"{err:.3g} vs plain; {ms:.3f} ms, {ops / ms / 1e9:.1f} TFLOP/s (bound {bound_ms:.3f} "
        f"ms by {bound_by}); plain version {plain_ms:.3f} ms; {library} {library_ms:.3f} ms")
    del q, k, v, v_own
    torch.cuda.empty_cache()
    return {"path": name, "shape": [B, L, H, Hkv, hd], "hd_v": hd_v, "window": window,
            "causal": causal,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "library": library}


def slice_config():
    from repro_torch.configs import get_config

    return get_config("granite-3-2b", n_layers=N_LAYERS)


def serve_config():
    """granite-3-2b at its published widths and full depth (slice 3)."""
    from repro_torch.configs import get_config

    return get_config("granite-3-2b")


def slice_bus_group():
    """The bus group (rows per worker, row block) of the slice's parameter
    tree, planned from its defs."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.models import model as Mo

    defs = Mo.model_defs(slice_config())
    meta = _tree.map(lambda d: torch.empty(d.shape, dtype=torch.bfloat16, device="meta"), defs)
    return bus.plan_layout(meta, lead_ndim=0).groups[0]


def slice_setup(tag: str):
    """(params0, batcher, batches, loss, optimizer) of the slices: the same
    seeded weights and the same batch sequence at every call."""
    import torch

    from repro_torch.core import bus
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd

    cfg = slice_config()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params0 = replicate_for_workers(Mo.init(gen, cfg, device="cuda"), M_WORKERS)
    toks, _ = token_stream(S=M_WORKERS * PER_WORKER_BATCH * 8, seq_len=SEQ_LEN,
                           vocab=cfg.vocab_size, seed=0)
    batcher = WorkerBatcher((toks,), pad_to_equal(random_split(len(toks), M_WORKERS)),
                            batch_size=PER_WORKER_BATCH, seed=0)

    def batches():
        while True:
            yield {"tokens": batcher.next()[0]}

    layout = bus.plan_layout(params0)
    n = layout.payload_elements()
    log(f"[{tag}] {cfg.name} d_model={cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x"
        f"{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} layers={cfg.n_layers} "
        f"{cfg.param_dtype}; {n:,} params per replica, {layout.groups[0].rows:,} bus rows, "
        f"padded_bytes {layout.padded_bytes():,}; set-up {time.perf_counter() - t0:.1f} s")
    return params0, batcher, batches, (lambda p, b: Mo.loss_fn(p, cfg, b)), momentum_sgd(LR, 0.9)


def _params_err(a, b) -> tuple[float, bool]:
    """(max |a − b| over the param trees, whether a is all finite)."""
    import torch

    from repro_torch import _tree

    err = max((x.float() - y.float()).abs().max().item()
              for x, y in zip(_tree.leaves(a), _tree.leaves(b)))
    return err, all(bool(torch.isfinite(x).all()) for x in _tree.leaves(a))


def phase_slice() -> dict:
    import torch

    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.train import train

    params0, batcher, batches, loss, opt = slice_setup("slice")
    topo = T.undirected_ring(M_WORKERS)
    spec = GossipSpec(topology=topo, backend="fused")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0,
                    "consensus_stats": stats_launches(state.params, STEPS)}:
        raise AssertionError(f"training launched {launches} in {STEPS} steps, "
                             f"want 1 gossip_mix and 1 consensus_stats per step")
    tokens = M_WORKERS * PER_WORKER_BATCH * SEQ_LEN
    step_s = hist.step_time[-1]
    log(f"[slice] losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice] gossip_mix launches {launches['gossip_mix']} in {STEPS} steps; step 0 (warm-up) "
        f"{hist.step_time[0] * 1e3:.1f} ms; steps 1-{STEPS - 1} {step_s * 1e3:.1f} ms/step, "
        f"{tokens / step_s:,.0f} tokens/s ({tokens} tokens/step); peak memory {peak_gb:.1f} GB")

    # one fused step vs one einsum step from the same state and batch
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    fused = make_train_step(loss, opt, gossip=spec)
    dense = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"))
    s_f, m_f = fused(state, batch)
    s_e, m_e = dense(state, batch)
    err, finite = _params_err(s_f.params, s_e.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"fused step vs einsum step: max|err|={err}, finite={finite}")
    log(f"[slice] fused step vs einsum step from the same state: params max|err| {err:.3g} "
        f"(bf16 tol {TOL['bfloat16']}); losses {m_f.loss.item():.4f} / {m_e.loss.item():.4f}")
    del s_e, m_e
    profile_call("one fused step", lambda: fused(s_f, batch))
    return {"launches": launches, "step_s": step_s, "tokens": tokens, "params": state.params}


def phase_slice2(slice1: dict) -> dict:
    """Hierarchical training on hier(2, 2), then the compressed cross-pod
    lane on the trained params. Returns each kernel's launches by path."""
    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step
    from repro_torch.core.gossip import (GossipSpec, hierarchical_mix,
                                         hierarchical_mix_compressed, mix_pytree,
                                         split_hierarchical)
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.kernels.quant_pack import quantize_pack_2d
    from repro_torch.train import train

    collect()
    torch.cuda.empty_cache()
    log(f"[slice2] {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated after slice 1")
    params0, batcher, batches, loss, opt = slice_setup("slice2")
    topo = T.hier(2, 2)          # ring of 2 pods ⊗ clique of 2: the product is clique(4)
    spec = GossipSpec(topology=topo, backend="fused", hierarchical=True)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    train_launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params0
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if train_launches != {"gossip_mix": 2 * STEPS, "quant_pack": 0, "flash_attention": 0,
                          "consensus_stats": stats_launches(state.params, STEPS)}:
        raise AssertionError(f"hierarchical training launched {train_launches} in "
                             f"{STEPS} steps, want 2 gossip_mix per step")
    step_s = hist.step_time[-1]
    tokens = slice1["tokens"]
    log(f"[slice2] {topo.name}: losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice2] gossip_mix launches {train_launches['gossip_mix']} in {STEPS} steps; "
        f"step 0 (warm-up) {hist.step_time[0] * 1e3:.1f} ms; steps 1-{STEPS - 1} "
        f"{step_s * 1e3:.1f} ms/step, {tokens / step_s:,.0f} tokens/s (slice 1: "
        f"{slice1['step_s'] * 1e3:.1f} ms/step, {tokens / slice1['step_s']:,.0f} tokens/s); "
        f"peak memory {peak_gb:.1f} GB")

    # one hierarchical step vs one einsum step on the unsplit matrix
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    hier_step = make_train_step(loss, opt, gossip=spec)
    dense = make_train_step(loss, opt, gossip=GossipSpec(topology=topo, backend="einsum"))
    s_h, m_h = hier_step(state, batch)
    s_e, m_e = dense(state, batch)
    err, finite = _params_err(s_h.params, s_e.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"hierarchical step vs einsum step: max|err|={err}, "
                             f"finite={finite}")
    log(f"[slice2] hierarchical step vs einsum step from the same state: params max|err| "
        f"{err:.3g} (bf16 tol {TOL['bfloat16']}); losses {m_h.loss.item():.4f} / "
        f"{m_e.loss.item():.4f}")
    del s_e, m_e, s_h, m_h
    profile_call("one hierarchical step", lambda: hier_step(state, batch))
    params = state.params
    del state, batch
    collect()
    torch.cuda.empty_cache()
    log(f"[slice2] {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the "
        f"compressed lane (the trained params are "
        f"{sum(x.numel() * x.element_size() for x in _tree.leaves(params)) / 1e9:.2f} GB)")

    # the compressed cross-pod lane: exact intra-pod mix, int8 cross-pod wire
    intra, inter = split_hierarchical(GossipSpec(topology=topo, backend="fused"))
    exact = hierarchical_mix(params, intra, inter)
    amax = max(x.abs().max().item() for x in _tree.leaves(mix_pytree(params, intra)))
    torch.cuda.synchronize()
    reset_launches()
    x, res, round_ms, peak = params, None, [], 0
    for r in range(DCI_ROUNDS):
        torch.cuda.reset_peak_memory_stats()    # the round alone, not its checks
        t0 = time.perf_counter()
        x, res = hierarchical_mix_compressed(x, intra, inter, dci_dtype="int8", residual=res)
        torch.cuda.synchronize()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        peak = max(peak, torch.cuda.max_memory_allocated())
        if (gossip_mix_2d.launches, quantize_pack_2d.launches) != (r + 1, r + 1):
            raise AssertionError(f"round {r}: {gossip_mix_2d.launches} gossip_mix and "
                                 f"{quantize_pack_2d.launches} quant_pack launches, "
                                 f"want {r + 1} each")
        if not all(bool(torch.isfinite(t).all()) for t in _tree.leaves(x)):
            raise AssertionError(f"round {r}: non-finite params")
        if r == 0:
            check_round1(x, exact, amax)
            del exact
    lane_launches = read_launches()
    if lane_launches["flash_attention"]:
        raise AssertionError(f"the compressed lane launched {lane_launches}")
    steady = round_ms[1:]
    log(f"[slice2] {DCI_ROUNDS} compressed rounds, launches {lane_launches}; round 0 "
        f"{round_ms[0]:.1f} ms, rounds 1-{DCI_ROUNDS - 1} {sum(steady) / len(steady):.1f} "
        f"ms/round (min {min(steady):.1f}, max {max(steady):.1f}); peak memory of a "
        f"round {peak / 1e9:.1f} GB; residual norm "
        f"{math.sqrt(sum(r.float().pow(2).sum().item() for r in res if r is not None)):.4g}")
    profile_call("one compressed round", lambda: hierarchical_mix_compressed(
        x, intra, inter, dci_dtype="int8", residual=res))
    return {"slice2_hier_train": train_launches, "slice2_compressed": lane_launches}


def phase_slice5(slice1: dict) -> dict:
    """Slice 5: one-peer time-varying training with worker-sharded
    asynchronous checkpoints; both one-peer rounds against the dense
    matrix; gradient accumulation with momentum, Adam and Adafactor;
    survivor mixing. Returns the training run's launches."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec, survivor_hierarchical_mix, survivor_mix
    from repro_torch.kernels.gossip_mix import gossip_mix_2d
    from repro_torch.optim import adafactor_like, adam, momentum_sgd, warmup_cosine
    from repro_torch.serving import load_consensus_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train

    fresh = lambda label: fresh_gb(label, "slice5")

    fresh("slice 5")
    params0, batcher, batches, loss, _ = slice_setup("slice5")
    spec = GossipSpec(topology=T.undirected_ring(M_WORKERS), backend="fused",
                      time_varying="one_peer_exp")
    opt = momentum_sgd(warmup_cosine(LR, 2, STEPS), 0.9)

    # 1. train() with worker-sharded asynchronous checkpoints every 2 steps
    path = os.path.join(ROOT, "build", "chip_smoke", "slice5_ckpt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    for f in os.listdir(os.path.dirname(path)):
        if f.startswith("slice5_ckpt."):      # files of an earlier run
            os.remove(os.path.join(os.path.dirname(path), f))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gossip_mix_2d.launches_by_k = {}
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, ckpt_path=path, ckpt_every=2, ckpt_sharded=True,
                        device="cuda", verbose=False)
    launches, by_k = read_launches(), dict(gossip_mix_2d.launches_by_k)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del params0
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"non-finite loss: {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0,
                    "consensus_stats": stats_launches(state.params, STEPS)} \
            or by_k != {1: STEPS}:
        raise AssertionError(f"one-peer training launched {launches} (by neighbour count "
                             f"{by_k}) in {STEPS} steps, want one k=1 gossip_mix per step")
    if ckpt.latest_step(path) != STEPS or len(hist.ckpt_write_s) != 3:
        raise AssertionError(f"checkpoint at step {ckpt.latest_step(path)}, "
                             f"{len(hist.ckpt_write_s)} writes; want step {STEPS}, 3 writes")
    st = [x * 1e3 for x in hist.step_time]
    log(f"[slice5] one-peer ring: losses {[round(x, 4) for x in hist.loss]}")
    log(f"[slice5] gossip_mix launches {launches['gossip_mix']} in {STEPS} steps, by neighbour "
        f"count {by_k}; step 0 (warm-up) {st[0]:.1f} ms; step 1 (no checkpoint in flight) "
        f"{st[1]:.1f} ms; steps 2-3 (after the step-2 snapshot, its write in flight) "
        f"{st[2]:.1f} ms/step; step 4 (after the step-4 snapshot) {st[4]:.1f} ms; slice 1 "
        f"{slice1['step_s'] * 1e3:.1f} ms/step; peak memory {peak_gb:.1f} GB")
    log(f"[slice5] checkpoints after steps 2, 4, 5: writer-thread seconds "
        f"{[round(x, 2) for x in hist.ckpt_write_s]} (each worker's npz from its pinned host "
        f"snapshot, copied on the loop's stream)")

    t0 = time.perf_counter()
    back = ckpt.restore_sharded(path, state.params, device="cuda")
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    bad = [i for i, (a, b) in enumerate(zip(_tree.leaves(back), _tree.leaves(state.params)))
           if a.dtype != b.dtype or not torch.equal(a, b)]
    del back
    want = ckpt.consensus_params(state.params)
    single = _tree.map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                       state.params)
    t0 = time.perf_counter()
    from_shards = ckpt.consensus_from_sharded(path, single, device="cuda")
    torch.cuda.synchronize()
    t_cons = time.perf_counter() - t0
    loaded = load_consensus_params(path, slice_config(), device="cuda")
    for label, got in (("consensus_from_sharded", from_shards),
                       ("load_consensus_params", loaded)):
        pairs = list(zip(_tree.leaves(got), _tree.leaves(want)))
        if len(pairs) != len(_tree.leaves(want)) or any(
                a.dtype != b.dtype or not torch.equal(a, b) for a, b in pairs):
            raise AssertionError(f"{label} of the sharded checkpoint differs from "
                                 f"consensus_params of the trained params")
    if bad:
        raise AssertionError(f"restore_sharded differs from the trained params at leaves {bad}")
    size = sum(os.path.getsize(f"{path}.shard-w{j}.npz") for j in range(M_WORKERS))
    for j in range(M_WORKERS):
        os.remove(f"{path}.shard-w{j}.npz")
    os.remove(path + ".meta.json")
    del from_shards, loaded, want
    log(f"[slice5] latest_step {STEPS}; {M_WORKERS} shards, {size / 1e9:.2f} GB; "
        f"restore_sharded {t_restore:.1f} s, equal to the trained params bit for bit; "
        f"consensus_from_sharded {t_cons:.1f} s and load_consensus_params both equal to "
        f"consensus_params bit for bit")

    # 2. both one-peer rounds against an einsum step on the round's dense matrix
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    fused = make_train_step(loss, opt, gossip=spec)
    for step in (STEPS + 1, STEPS):        # an even round, then an odd one
        at = state._replace(step=step)
        gossip_mix_2d.launches_by_k = {}
        s_f, m_f = fused(at, batch)
        k_f = dict(gossip_mix_2d.launches_by_k)
        dense = make_train_step(loss, opt, gossip=GossipSpec(
            topology=T.one_peer_exponential(M_WORKERS, step % 2), backend="einsum"))
        s_e, m_e = dense(at, batch)
        err, finite = _params_err(s_f.params, s_e.params)
        if k_f != {1: 1} or not finite or err > TOL["bfloat16"]:
            raise AssertionError(f"one-peer step {step}: launches by k {k_f}, vs einsum "
                                 f"max|err| {err}, finite {finite}")
        log(f"[slice5] step {step} (round {step % 2}, offset {1 << (step % 2)}): fused "
            f"one-peer step vs einsum step on one_peer_exponential({M_WORKERS}, {step % 2}).A: "
            f"params max|err| {err:.3g} (bf16 tol {TOL['bfloat16']}), one k=1 launch; "
            f"losses {m_f.loss.item():.4f} / {m_e.loss.item():.4f}")
        del s_f, m_f, s_e, m_e
    profile_call("one fused one-peer step", lambda: fused(state, batch))

    # 3. gradient accumulation: microbatch=2 against microbatch=1, then Adam
    # and Adafactor at microbatch=2 (finite losses)
    base = fresh("the microbatch=1 step")
    s1, m1 = fused(state, batch)
    torch.cuda.synchronize()
    peak1 = torch.cuda.max_memory_allocated() / 1e9
    collect()
    torch.cuda.reset_peak_memory_stats()
    base2 = torch.cuda.memory_allocated() / 1e9
    s2, m2 = make_train_step(loss, opt, gossip=spec, microbatch=2)(state, batch)
    torch.cuda.synchronize()
    peak2 = torch.cuda.max_memory_allocated() / 1e9
    err, finite = _params_err(s2.params, s1.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"microbatch=2 vs microbatch=1: max|err| {err}, finite {finite}")
    log(f"[slice5] momentum step, microbatch=2 vs 1 from the same state and batch: params "
        f"max|err| {err:.3g} (bf16 tol {TOL['bfloat16']}); losses {m2.loss.item():.4f} / "
        f"{m1.loss.item():.4f}; peaks {peak1:.1f} GB (microbatch=1, {base:.1f} GB before) "
        f"and {peak2:.1f} GB (microbatch=2, {base2:.1f} GB before)")
    params = state.params
    del s1, m1, s2, m2, state, batch
    for name, make_opt, n_steps in (
            ("adam(warmup_cosine(1e-4, 1, 2))", lambda: adam(warmup_cosine(1e-4, 1, 2)), 2),
            ("adafactor_like(1e-4)", lambda: adafactor_like(1e-4), 1)):
        base = fresh(name)
        o = make_opt()
        step_fn = make_train_step(loss, o, gossip=spec, microbatch=2)
        st_o = init_state(params, o)
        losses, t0 = [], time.perf_counter()
        for _ in range(n_steps):
            st_o, m = step_fn(st_o, to_device({"tokens": batcher.next()[0]}, "cuda"))
            losses.append(m.loss.item())
        dt = (time.perf_counter() - t0) / n_steps
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = all(math.isfinite(x) for x in losses) and all(
            bool(torch.isfinite(x).all()) for x in _tree.leaves(st_o.params))
        del st_o, m, step_fn, o
        if not finite:
            raise AssertionError(f"{name} at microbatch=2: losses {losses}, params finite "
                                 f"{finite}")
        log(f"[slice5] {name}, microbatch=2: {n_steps} steps, losses "
            f"{[round(x, 4) for x in losses]}, {dt * 1e3:.1f} ms/step (host clock, incl. the "
            f"first step); peak {peak:.1f} GB ({base:.1f} GB before)")

    # 4. survivor mixing on the trained params
    fresh("survivor mixing")
    cases = (("survivor_mix", T.undirected_ring(M_WORKERS), np.array([1, 1, 0, 1], bool)),
             ("survivor_hierarchical_mix", T.hier(2, 2), np.array([1, 1, 1, 0], bool)))
    for name, topo, alive in cases:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "survivor_mix":
            mixed = survivor_mix(params, topo, alive)
            stages = [T.survivor_matrix(topo.A, alive)]
        else:
            mixed = survivor_hierarchical_mix(params, topo, alive)
            stages = list(T.repair_hier_stages(topo, alive))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        mats = [torch.as_tensor(A, dtype=torch.float32, device="cuda") for A in stages]
        dead, live = np.nonzero(~alive)[0].tolist(), np.nonzero(alive)[0].tolist()
        worst = 0.0
        for x, y in zip(_tree.leaves(params), _tree.leaves(mixed)):
            if any(not torch.equal(y[j], x[j]) for j in dead):
                raise AssertionError(f"{name}: a dead worker's slice changed")
            ref = x.float()
            for A in mats:
                ref = torch.einsum("im,i...->m...", A, ref)
            worst = max(worst, (y[live].float() - ref[live]).abs().max().item())
            del ref
        del mixed
        if worst > TOL["bfloat16"]:
            raise AssertionError(f"{name}: live workers {worst} off the float32 einsum")
        log(f"[slice5] {name} on {topo.name}, alive {alive.astype(int).tolist()}: dead slice "
            f"bit-equal to its input, live workers max|err| {worst:.3g} vs the float32 einsum "
            f"with the repaired matri{'x' if len(mats) == 1 else 'ces'} (bf16 tol "
            f"{TOL['bfloat16']}); {ms:.1f} ms")
    del params
    return {"launches": launches}


# ---------------------------------------------------------------------------
# The paper's experiments: Fig. 2, the simulator, telemetry
# ---------------------------------------------------------------------------


def _fig2_topo(d: int):
    """bench_fig2's graphs at M = 8: ring (d=2), ring_lattice(8, 4), clique (d=7)."""
    from repro_torch.core import topology as T

    if d >= PAPER_M - 1:
        return T.clique(PAPER_M)
    return T.undirected_ring(PAPER_M) if d == 2 else T.ring_lattice(PAPER_M, d)


def _rel_diff(a, b) -> float:
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _paper_cpu_curve(make: str, steps: int, lr: float, split: str, d: int):
    """One Fig. 2 curve of the port on the CPU, in a worker process of
    :func:`phase_paper`'s pool: the same seeds as the card's run."""
    import torch

    from repro_torch import problems

    torch.set_num_threads(PAPER_CPU_THREADS)
    losses, _, _ = problems.run_dsm(getattr(problems, make)(), _fig2_topo(d), steps=steps,
                                    lr=lr, split=split, device="cpu")
    return losses


def phase_paper() -> dict:
    """Fig. 2 on the card: ``problems.run_dsm`` (einsum) for the classifier
    (150 steps, lr 0.5) and the LM (60 steps, lr 0.1) at M = 8 on degrees 2,
    4, 7, random and by-label splits; each curve against the port's own CPU
    run of the same seeds (the 12 CPU runs in a pool of processes beside
    the card's); the classifier on the ring (random split) also
    through ``train()`` on the fused bus, one gossip_mix launch per step,
    its per-step losses against ``train()`` on einsum, whose final global
    loss is run_dsm's last point."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import numpy as np
    import torch

    from repro_torch import _tree, problems
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.data import WorkerBatcher
    from repro_torch.optim import sgd
    from repro_torch.train import train

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    worst, first, card_s = 0.0, 0.0, 0.0
    rows, gate = [], None
    runs = (("problem_classifier", 150, 0.5), ("problem_lm", 60, 0.1))
    pool = ProcessPoolExecutor(PAPER_CPU_PROCS, mp_context=multiprocessing.get_context("spawn"))
    cpu_runs = {(name, split, d): pool.submit(_paper_cpu_curve, name, steps, lr, split, d)
                for name, steps, lr in runs for split in ("random", "by_label")
                for d in PAPER_DEGREES}
    try:
        for name, steps, lr in runs:
            make = getattr(problems, name)
            problem = make()
            for split in ("random", "by_label"):
                curves = {}
                for d in PAPER_DEGREES:
                    t1 = time.perf_counter()
                    losses, _, parts = problems.run_dsm(problem, _fig2_topo(d), steps=steps,
                                                        lr=lr, split=split, device="cuda")
                    card_s += time.perf_counter() - t1
                    cpu = cpu_runs[(name, split, d)].result()
                    err = _rel_diff(losses, cpu)
                    first = max(first, _rel_diff(losses[:1], cpu[:1]))
                    worst = max(worst, err)
                    if not np.isfinite(losses).all() or err > PAPER_RTOL:
                        raise AssertionError(f"{problem[4]} {split} d={d}: card curve off the "
                                             f"CPU run by {err:.3g} relative (tol "
                                             f"{PAPER_RTOL}), finite {np.isfinite(losses).all()}")
                    curves[d] = losses
                    if make is problems.problem_classifier and split == "random" and d == 2:
                        gate = (problem, parts, losses, steps, lr)
                base = curves[PAPER_DEGREES[-1]]
                drop = float(base[0] - base[-20:].mean())
                for d in PAPER_DEGREES:
                    tail = float(curves[d][-20:].mean())
                    rows.append((problem[4], split, d, tail,
                                 (tail - float(base[-20:].mean())) / max(drop, 1e-9)))
        for name, split, d, tail, gap in rows:
            log(f"[paper] {name:34s} {split:8s} degree {d}: tail loss (mean of the last 20 "
                f"steps) {tail:.5f}, gap_vs_clique_frac {gap:+.4f}")
    finally:
        pool.shutdown(cancel_futures=True)
    log(f"[paper] 12 curves finite; card vs the port's CPU run: max relative difference "
        f"{worst:.3g} (first step {first:.3g}; tol {PAPER_RTOL}); card run_dsm time "
        f"{card_s:.1f} s for all 12, the CPU runs in {PAPER_CPU_PROCS} processes of "
        f"{PAPER_CPU_THREADS} threads beside them, {time.perf_counter() - t0:.1f} s in all")

    # the gate configuration through train(): fused bus against einsum
    problem, parts, dsm_losses, steps, lr = gate
    arrays, _, params0, loss, name = problem
    spec = lambda backend: GossipSpec(topology=_fig2_topo(2), backend=backend)

    def run(backend):
        batcher = WorkerBatcher(arrays, parts, batch_size=16, seed=0)
        return train(loss, replicate_for_workers(params0, PAPER_M),
                     sgd(lr), (batcher.next() for _ in range(steps)), steps=steps,
                     gossip=spec(backend), log_every=steps, device="cuda", verbose=False)

    st_e, h_e = run("einsum")
    reset_launches()
    t1 = time.perf_counter()
    st_f, h_f = run("fused")
    fused_s = time.perf_counter() - t1
    launches = read_launches()
    full = _tree.map(lambda a: torch.from_numpy(a).cuda(), arrays)
    with torch.no_grad():
        mean_loss = lambda st: float(loss(_tree.map(lambda v: v.mean(0), st.params), full))
        g_e, g_f = mean_loss(st_e), mean_loss(st_f)
    step_err = _rel_diff(h_f.loss, h_e.loss)
    step0 = _rel_diff(h_f.loss[:2], h_e.loss[:2])
    if launches != {"gossip_mix": steps, "quant_pack": 0, "flash_attention": 0,
                    "consensus_stats": stats_launches(st_f.params, steps)}:
        raise AssertionError(f"fused train() launched {launches} in {steps} steps, "
                             f"want one gossip_mix per step")
    if g_e != float(dsm_losses[-1]):
        raise AssertionError(f"train() on einsum ends at global loss {g_e}, run_dsm at "
                             f"{dsm_losses[-1]}: not the same run")
    if step_err > PAPER_RTOL or _rel_diff([g_f], [g_e]) > PAPER_RTOL:
        raise AssertionError(f"fused train() off the einsum run: per-step losses "
                             f"{step_err:.3g}, final global loss {g_f} vs {g_e} "
                             f"(tol {PAPER_RTOL})")
    log(f"[paper] {name}, ring, random split through train(): fused bus {steps} steps, "
        f"gossip_mix launches {launches['gossip_mix']}; per-step losses vs the einsum run max "
        f"relative difference {step_err:.3g} (steps 0-1: {step0:.3g}; tol {PAPER_RTOL}); "
        f"final global loss fused {g_f:.6f}, einsum {g_e:.6f} = run_dsm's last point; "
        f"fused run {fused_s * 1e3 / steps:.2f} ms/step (host clock, incl. warm-up); "
        f"phase {time.perf_counter() - t0:.1f} s, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    return {"launches": launches}


def _sim_inputs(tag: str):
    """(params0, batches, loss, spec factory) of the simulator phases: the
    slices' model, batches and seeds; every ``batches()`` starts the same
    batch sequence from its first batch. params0 is kept in host memory:
    ``run_simulated`` copies it to the card, and the phase then holds no
    stacked copy of its own there."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec

    params0, batcher, _, loss, _ = slice_setup(tag)
    params0 = _tree.map(lambda x: x.cpu(), params0)
    topo = T.undirected_ring(M_WORKERS)

    def batches():
        fresh = dataclasses.replace(batcher)       # its own generator, reseeded
        while True:
            yield {"tokens": fresh.next()[0]}

    return params0, batches, loss, lambda backend: GossipSpec(topology=topo, backend=backend)


def _schedule(trace) -> list:
    """A trace's event schedule: its signature without the recorded losses."""
    return [r[:6] for r in trace.signature()]


def phase_sim() -> dict:
    """The simulator at full width: granite-3-2b (4 layers), M = 4 on the
    ring, momentum SGD, per-worker batch 8 x 512, heavy-tail compute times.
    Sync for SIM_ROUNDS rounds with slice commits (einsum) and with full
    commits (fused bus); then async; then a sync run whose worker 1 fails
    past its retries at round 3 and is restored from the checkpoint's
    consensus. Returns each run's launches."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.optim import momentum_sgd
    from repro_torch.sim import TrainExecutor, scenarios
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import loop
    from repro_torch.train.loop import RecoveryPolicy, run_simulated

    gb0 = fresh_gb("sim")
    params0, batches, loss, spec = _sim_inputs("sim")
    opt = momentum_sgd(LR, 0.9)
    scen = lambda: scenarios.heavy_tail("spark", seed=7)
    out, runs = {}, {}
    for label, kw in (("slice", dict(commit="slice", commit_batch=True, gossip=spec("einsum"))),
                      ("full", dict(commit="full", gossip=spec("fused")))):
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        run = run_simulated(loss, params0, opt, batches(), protocol="sync", scenario=scen(),
                            rounds=SIM_ROUNDS, snap_depth=SNAP_DEPTH, device="cuda", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out[f"sim_{label}_commit"] = read_launches()
        commits = sum(1 for r in run.trace.records if r.kind == "compute_done")
        log(f"[sim] sync, {label} commits: {commits} commits in {SIM_ROUNDS} rounds, virtual "
            f"time {run.virtual_time:.3f}; {wall:.2f} s host, {wall / SIM_ROUNDS:.2f} s per "
            f"virtual round; launches {out[f'sim_{label}_commit']}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB (snap_depth {SNAP_DEPTH}, "
            f"{gb0:.1f} GB before)")
        runs[label] = run
        del run
    s, f = runs["slice"], runs["full"]
    n_full = sum(1 for r in f.trace.records if r.kind == "compute_done")
    if out["sim_full_commit"] != {"gossip_mix": n_full, "quant_pack": 0, "flash_attention": 0,
                                  "consensus_stats": stats_launches(params0, n_full)}:
        raise AssertionError(f"full commits launched {out['sim_full_commit']}, want one "
                             f"gossip_mix per commit ({n_full})")
    if out["sim_slice_commit"]["gossip_mix"] != 0:
        raise AssertionError(f"einsum slice commits launched {out['sim_slice_commit']}")
    if _schedule(s.trace) != _schedule(f.trace):
        raise AssertionError("slice and full commits ran different event schedules")
    ls = np.array([r[6] for r in s.trace.signature() if r[6] is not None])
    lf = np.array([r[6] for r in f.trace.signature() if r[6] is not None])
    err, finite = _params_err(f.params, s.params)
    loss_err = float(np.abs(ls - lf).max())
    if not finite or err > TOL["bfloat16"] or loss_err > TOL["bfloat16"] \
            or not np.isfinite(ls).all():
        raise AssertionError(f"full vs slice commits: params max|err| {err} (finite {finite}),"
                             f" losses max|err| {loss_err} (tol {TOL['bfloat16']})")
    log(f"[sim] full (fused) vs slice (einsum) commits: schedules equal ({len(_schedule(s.trace))} "
        f"events), params max|err| {err:.3g}, committed losses max|err| {loss_err:.3g} (bf16 "
        f"tol {TOL['bfloat16']}); round-1 losses {[round(float(x), 4) for x in ls[:M_WORKERS]]}")
    del runs, s, f

    # per-commit time of the batched step: J = 1 (padded to [j, j]) and J = 4
    fresh_gb("sim commit timing")
    ex = TrainExecutor(loss, opt, _tree.map(lambda x: x.cuda(), params0), batches(),
                       spec("einsum"))
    A = np.asarray(spec("einsum").topology.A)
    per = {}
    for js in (np.array([0]), np.arange(M_WORKERS)):
        ex.commit_batch(js, 1, A, ex.W)           # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ex.commit_batch(js, 1, A, ex.W)
        torch.cuda.synchronize()
        per[len(js)] = (time.perf_counter() - t0) / 3 * 1e3
    del ex
    log(f"[sim] batched per-slice commit: J=1 (padded to [j, j]) {per[1]:.1f} ms, J={M_WORKERS} "
        f"{per[M_WORKERS]:.1f} ms ({per[M_WORKERS] / M_WORKERS:.1f} ms per worker)")

    # async
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    run = run_simulated(loss, params0, opt, batches(), gossip=spec("einsum"), protocol="async",
                        scenario=scen(), rounds=SIM_ROUNDS, device="cuda")
    wall = time.perf_counter() - t0
    out["sim_async"] = read_launches()
    la = [r.loss for r in run.trace.records if r.loss is not None]
    if len(la) != SIM_ROUNDS * M_WORKERS or not np.isfinite(la).all():
        raise AssertionError(f"async: {len(la)} losses, finite {np.isfinite(la).all()}")
    log(f"[sim] async: {len(la)} computations, losses finite ({min(la):.4f}-{max(la):.4f}), "
        f"virtual time {run.virtual_time:.3f}; {wall:.2f} s host; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del run

    # recovery: worker 1 fails round 3 past max_retries, restored from the checkpoint
    path = os.path.join(ROOT, "build", "chip_smoke", "sim_ckpt")
    clean_ckpt(path)
    checked = {}
    real = loop._RecoveryManager._restore

    def restore_and_check(self, j):
        real(self, j)
        torch.cuda.synchronize()
        like = _tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
                         self.executor.W)
        want = ckpt.consensus_params(ckpt.restore(self.policy.ckpt_path, like, device="cuda"))
        checked[j] = all(torch.equal(a[j], b) for a, b in
                         zip(_tree.leaves(self.executor.W), _tree.leaves(want)))
        del want

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    loop._RecoveryManager._restore = restore_and_check
    t0 = time.perf_counter()
    try:
        run = run_simulated(
            loss, params0, opt, batches(), gossip=spec("einsum"), protocol="sync",
            scenario=scen(), rounds=SIM_ROUNDS, snap_depth=SNAP_DEPTH, device="cuda",
            recovery=RecoveryPolicy(max_retries=1, backoff_base=0.1, ckpt_path=path,
                                    ckpt_every=2),
            fault_inject=lambda j, k, attempt: j == 1 and k == 3)
    finally:
        loop._RecoveryManager._restore = real
    wall = time.perf_counter() - t0
    out["sim_recovery"] = read_launches()
    stats = run.trace.meta["recovery"]
    flagged = sum(1 for r in run.trace.records if r.retried and r.kind == "compute_done")
    if checked != {1: True} or stats["restores"] != 1 or stats["retries"] != 1 or flagged != 1:
        raise AssertionError(f"recovery: restore checks {checked}, stats {stats}, "
                             f"{flagged} failed attempts traced")
    if not np.all(run.trace.rounds_completed() == SIM_ROUNDS):
        raise AssertionError(f"recovery run completed rounds {run.trace.rounds_completed()}")
    log(f"[sim] recovery: worker 1 fails round 3 past max_retries 1: stats {stats}, "
        f"{flagged} failed attempt in the trace; right after the restore worker 1's slice "
        f"equals the consensus of the checkpoint on disk bit for bit; {wall:.2f} s host; "
        f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del run
    clean_ckpt(path)
    return out


def clean_ckpt(path: str) -> None:
    """Remove a checkpoint base's files (sharded or not) under build/."""
    d, base = os.path.split(path)
    os.makedirs(d, exist_ok=True)
    for f in os.listdir(d):
        if f.startswith(base + "."):
            os.remove(os.path.join(d, f))


def phase_telemetry() -> dict:
    """The full-commit simulator run again for TEL_ROUNDS rounds inside
    ``telemetry.run`` with health gauges; bus.mix_calls, the profiler range
    around the gossip_mix launch, the gauges, the Perfetto file."""
    import numpy as np
    import torch

    from repro_torch import telemetry
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.convert import to_device
    from repro_torch.optim import momentum_sgd
    from repro_torch.sim import scenarios
    from repro_torch.train.loop import run_simulated

    fresh_gb("telemetry")
    params0, batches, loss, spec = _sim_inputs("telemetry")
    opt = momentum_sgd(LR, 0.9)
    run_dir = os.path.join(ROOT, "build", "chip_smoke", "telemetry_run")
    os.makedirs(run_dir, exist_ok=True)
    reset_launches()
    t0 = time.perf_counter()
    with telemetry.run(run_dir):
        run = run_simulated(loss, params0, opt, batches(), gossip=spec("fused"),
                            protocol="sync", scenario=scenarios.heavy_tail("spark", seed=7),
                            rounds=TEL_ROUNDS, commit="full", snap_depth=SNAP_DEPTH,
                            health=True, run_dir=run_dir, device="cuda")
    wall = time.perf_counter() - t0
    launches = read_launches()
    commits = sum(1 for r in run.trace.records if r.kind == "compute_done")
    with open(os.path.join(run_dir, "telemetry.json")) as fh:
        counters = json.load(fh)["counters"]
    with open(os.path.join(run_dir, "perfetto.json")) as fh:
        perfetto = json.load(fh)
    gauges = [(g.name, g.value) for g in run.trace.gauges]
    if counters.get("bus.mix_calls") != commits or launches["gossip_mix"] != commits:
        raise AssertionError(f"telemetry counted bus.mix_calls {counters.get('bus.mix_calls')}"
                             f", gossip_mix launched {launches['gossip_mix']}, for {commits} "
                             f"fused commits")
    if len(gauges) < 3 or not all(np.isfinite(v) for _, v in gauges):
        raise AssertionError(f"health gauges {gauges}")
    if telemetry.validate_chrome_trace(perfetto):
        raise AssertionError(f"perfetto.json: {telemetry.validate_chrome_trace(perfetto)[:3]}")
    log(f"[telemetry] {TEL_ROUNDS} rounds of full (fused) commits in telemetry.run: "
        f"telemetry.json counters {counters}; gossip_mix launches {launches['gossip_mix']}; "
        f"health gauges {[(n, round(v, 4)) for n, v in gauges]}; perfetto.json "
        f"{len(perfetto['traceEvents'])} events, valid; {wall:.2f} s host")
    del run

    # one fused step under the profiler, telemetry on: the bus.fused_mix
    # range must enclose the gossip_mix launch
    step = make_train_step(loss, opt, gossip=spec("fused"))
    state = init_state(to_device(params0, "cuda"), opt)
    batch = to_device(next(batches()), "cuda")
    with telemetry.run():
        reset_launches()
        trace_file = os.path.join(run_dir, "step_profile.json")
        around = _profiled_range_around(lambda: step(state, batch), "bus.fused_mix",
                                        "gossip_mix", trace_file)
        step_launches = read_launches()
    if step_launches["gossip_mix"] != 1:
        raise AssertionError(f"the profiled step launched {step_launches}")
    log(f"[telemetry] profiled fused step: {around}")
    del state, batch
    return {"telemetry_full_commit": launches, "telemetry_profiled_step": step_launches}


def _profiled_range_around(fn, range_name: str, kernel: str, trace_file: str) -> str:
    """Profile one call of ``fn`` and check that the ``range_name`` range
    encloses the launch of the kernel whose name holds ``kernel``: the CPU
    call that launched it (matched by correlation id) lies inside the range
    on the host timeline, or else the kernel lies inside the range's
    projection on the device timeline. Returns what was found; raises when
    neither holds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    del out
    prof.export_chrome_trace(trace_file)
    with open(trace_file) as fh:
        evs = json.load(fh)["traceEvents"]
    ranges = [e for e in evs if e.get("name") == range_name and e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    gpu_ranges = [e for e in evs if e.get("name") == range_name and e.get("ph") == "X"
                  and e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in evs if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    if not ranges or not kernels:
        raise AssertionError(f"profile has {len(ranges)} {range_name!r} ranges and "
                             f"{len(kernels)} {kernel!r} kernels")
    inside = lambda t, r: r["ts"] <= t <= r["ts"] + r["dur"]
    corr = {k.get("args", {}).get("correlation") for k in kernels}
    launch = [e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and e.get("args", {}).get("correlation") in corr]
    if launch and all(any(inside(e["ts"], r) for r in ranges) for e in launch):
        return (f"{len(launch)} launch call(s) {sorted({e['name'] for e in launch})} of "
                f"{kernels[0]['name'][:50]} inside the {range_name!r} host range")
    if gpu_ranges and all(any(inside(k["ts"], r) and inside(k["ts"] + k["dur"], r)
                              for r in gpu_ranges) for k in kernels):
        return (f"{kernels[0]['name'][:50]} inside the {range_name!r} range on the device "
                f"timeline")
    raise AssertionError(f"{kernel!r} launched outside the {range_name!r} range")


def phase_checkpoint(params_M) -> None:
    """export_consensus of slice 1's worker-stacked params, then
    load_consensus_params of the file, bit for bit against
    consensus_params of the in-memory params."""
    import torch

    from repro_torch import _tree
    from repro_torch.serving import load_consensus_params
    from repro_torch.train import checkpoint as ckpt

    path = os.path.join(ROOT, "build", "chip_smoke", "slice1_consensus.npz")
    t0 = time.perf_counter()
    ckpt.export_consensus(params_M, dst=path, step=STEPS)
    t_save = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_consensus_params(path, slice_config(), device="cuda")
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    want = ckpt.consensus_params(params_M)
    pairs = list(zip(_tree.flatten_with_path(loaded), _tree.leaves(want)))
    bad = ["/".join(map(str, p)) for (p, a), b in pairs
           if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b)]
    if bad or len(pairs) != len(_tree.leaves(want)):
        raise AssertionError(f"consensus checkpoint round trip differs at {bad[:5]}")
    size, step = os.path.getsize(path), ckpt.latest_step(path)
    os.remove(path)
    os.remove(path + ".meta.json")
    log(f"[checkpoint] export_consensus of {_tree.leaves(params_M)[0].shape[0]} stacked "
        f"workers → {size / 1e9:.2f} GB npz (step {step}) in {t_save:.1f} s; "
        f"load_consensus_params {t_load:.1f} s; {len(pairs)} leaves equal to "
        f"consensus_params bit for bit")


def phase_serve() -> dict:
    """Slice 3: the full-depth model served by WaveBatcher, then the
    prefill check against the blockwise route, timings and a profile."""
    import numpy as np
    import torch

    from repro_torch.data import token_stream
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.serving import WaveBatcher, generate, make_serve_step

    collect()
    torch.cuda.empty_cache()
    log(f"[serve] {torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated before slice 3")
    cfg = serve_config()
    t0 = time.perf_counter()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    prompts, _ = token_stream(S=SERVE_REQUESTS, seq_len=PROMPT_LEN - 1,
                              vocab=cfg.vocab_size, seed=1)
    log(f"[serve] {cfg.name} layers={cfg.n_layers} d_model={cfg.d_model} heads="
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff={cfg.d_ff} vocab={cfg.vocab_size} "
        f"{cfg.param_dtype}: {count_params(Mo.model_defs(cfg)):,} params; "
        f"{SERVE_REQUESTS} requests of {PROMPT_LEN} prompt + {NEW_TOKENS} new tokens, "
        f"{SERVE_SLOTS} slots; set-up {time.perf_counter() - t0:.1f} s")

    # the user's path: WaveBatcher → generate → prefill (flash kernel) + decode
    wb = WaveBatcher(params, cfg, SERVE_SLOTS, SERVE_MAX_LEN)
    rids = [wb.submit(p, NEW_TOKENS) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    wave_s = []
    while wb.queue:
        before = read_launches()
        t0 = time.perf_counter()
        wb.run_wave()
        wave_s.append(time.perf_counter() - t0)   # generate() ends in a host transfer
        n = read_launches()["flash_attention"] - before["flash_attention"]
        if n != cfg.n_layers:
            raise AssertionError(f"wave {len(wave_s)}: {n} flash_attention launches, "
                                 f"want one per layer ({cfg.n_layers})")
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if sorted(wb.done) != rids or any(len(wb.done[r]) != NEW_TOKENS for r in rids):
        raise AssertionError("WaveBatcher did not serve every request in full")
    if launches["gossip_mix"] or launches["quant_pack"]:
        raise AssertionError(f"serving launched {launches}")
    new_tokens = SERVE_REQUESTS * NEW_TOKENS
    log(f"[serve] {len(wave_s)} waves, flash_attention launches {launches['flash_attention']} "
        f"({cfg.n_layers} per wave's prefill); wave wall {[round(x * 1e3, 1) for x in wave_s]} ms; "
        f"{new_tokens / sum(wave_s):,.1f} generated tokens/s end to end; peak memory "
        f"{peak_gb:.2f} GB")

    wave = prompts[:SERVE_SLOTS]
    with torch.no_grad():
        t0 = time.perf_counter()
        res = generate(params, cfg, wave, n_new=NEW_TOKENS)
        gen_s = time.perf_counter() - t0
        if not np.isfinite(res.logprobs).all():
            raise AssertionError("non-finite logprobs")
        if not all(np.array_equal(res.tokens[i], wb.done[rids[i]]) for i in range(SERVE_SLOTS)):
            raise AssertionError("generate() and WaveBatcher disagree on wave 1's tokens")
        log(f"[serve] wave 1 again through generate(): the same tokens, logprobs finite "
            f"(mean {res.logprobs.mean():.4f}), {gen_s * 1e3:.1f} ms")

        tok = torch.from_numpy(wave).cuda()
        prefill_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, *_ = Mo.prefill(params, cfg, tok, max_len=SERVE_MAX_LEN)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        pf = sum(prefill_s) / len(prefill_s)
        # decode from generate()'s own runs: a run is one prefill and
        # NEW_TOKENS - 1 decode steps (the first wave also warms the caches'
        # allocations, so it is left out)
        runs = wave_s[1:] + [gen_s]
        step_s = sum((r - pf) / (NEW_TOKENS - 1) for r in runs) / len(runs)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        serve_step = make_serve_step(cfg)
        profile_call("one decode step", lambda: serve_step(params, caches, nxt))
        del caches
        log(f"[serve] prefill of a wave ({SERVE_SLOTS} x {PROMPT_LEN} tokens): "
            f"{[round(x * 1e3, 2) for x in prefill_s]} ms, mean {pf * 1e3:.2f} ms = time to "
            f"first token, {SERVE_SLOTS * PROMPT_LEN / pf:,.0f} prompt tokens/s; decode "
            f"{step_s * 1e3:.2f} ms/step ((run - prefill) / {NEW_TOKENS - 1} over "
            f"{len(runs)} generate() runs), {SERVE_SLOTS / step_s:,.1f} generated tokens/s")

        check_prefill(params, cfg, tok, SERVE_MAX_LEN, "serve")
        profile_flash_route("one prefill wave",
                            lambda: Mo.prefill(params, cfg, tok, max_len=SERVE_MAX_LEN),
                            cfg.n_layers)
    del params
    return {"launches": launches}


def serving_trace(n_requests: int, *, max_prompt: int, short_new: int, long_new: int,
                  long_frac: float, seed: int = 0, steps_per_day: float = 40.0) -> list[dict]:
    """``benchmarks/bench_serving.py::make_trace`` (whose module imports
    JAX): Poisson arrivals thinned by a day/night rate curve, prompt lengths
    uniform over [3, max_prompt], ``long_new`` new tokens with probability
    ``long_frac``, else ``short_new``. The arrival process is the
    reference's; the lengths are synthetic (the reference's own trace uses
    3-7-token prompts and 2 or 48 new tokens)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    base = 1.2                     # mean arrivals per decode step
    peak = base * (1 + 0.85)
    t, reqs = 0.0, []
    while len(reqs) < n_requests:
        t += rng.exponential(1.0 / peak)
        rate = base * (1 + 0.85 * np.sin(2 * np.pi * t / steps_per_day))
        if rng.uniform() * peak > max(rate, 1e-9):
            continue               # thinned: off-peak arrival rejected
        n_new = long_new if rng.uniform() < long_frac else short_new
        reqs.append({"arrival_step": t, "prompt_len": int(rng.integers(3, max_prompt + 1)),
                     "n_new": int(n_new)})
    return reqs


def phase_continuous(card: str) -> dict:
    """Slice 7: the trace through ContinuousBatcher (the main path, its
    launches counted) and WaveBatcher, then the graph, paged-attention and
    agreement checks, timings and a profile of the graph step."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.models import model as Mo
    from repro_torch.launch.roofline import memory_rate
    from repro_torch.models.params import count_params
    from repro_torch.serving import ContinuousBatcher, WaveBatcher, generate
    from repro_torch.serving.batcher import default_buckets

    fresh_gb("slice 7", "continuous")
    cfg = serve_config()
    t0 = time.perf_counter()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    trace = serving_trace(CB_REQUESTS, max_prompt=CB_MAX_PROMPT, short_new=CB_SHORT_NEW,
                          long_new=CB_LONG_NEW, long_frac=CB_LONG_FRAC, seed=0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=r["prompt_len"]).astype(np.int32)
               for r in trace]
    n_news = [r["n_new"] for r in trace]
    buckets = default_buckets(CB_PAGE, CB_MAX_LEN)
    lens = [r["prompt_len"] for r in trace]
    log(f"[continuous] {cfg.name} layers={cfg.n_layers} {cfg.param_dtype}: "
        f"{count_params(Mo.model_defs(cfg)):,} params; synthetic trace of {CB_REQUESTS} requests, "
        f"prompts {min(lens)}-{max(lens)} tokens (mean {np.mean(lens):.1f}), "
        f"{sum(n == CB_LONG_NEW for n in n_news)} of {CB_LONG_NEW} new tokens and "
        f"{sum(n == CB_SHORT_NEW for n in n_news)} of {CB_SHORT_NEW}, {sum(n_news)} in all; "
        f"{CB_SLOTS} slots, page {CB_PAGE}, max_len {CB_MAX_LEN}, buckets {buckets}; "
        f"set-up {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cb = ContinuousBatcher(params, cfg, CB_SLOTS, CB_MAX_LEN, page_size=CB_PAGE,
                           max_new=CB_LONG_NEW, buckets=buckets)
    t_build = time.perf_counter() - t0
    pool_gb = sum(c.k_pages.nbytes + c.v_pages.nbytes for c in cb.caches) / 1e9
    t0 = time.perf_counter()
    cb.warmup()
    t_warm = time.perf_counter() - t0
    st = cb.stats()
    log(f"[continuous] built (pools {pool_gb:.2f} GB, {cb.pool.n_pages} pages; the decode "
        f"step captured) in {t_build:.1f} s; warmup of {len(st['admit_traces'])} admission "
        f"shapes in {t_warm:.1f} s, peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
        f"GB; decode: {st['decode']}, decode_traces {st['decode_traces']}")

    # the main path, saturation replay: every request queued at once, the
    # trace fixing the queue's order, as bench_serving's run_continuous
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [cb.submit(p, n) for p, n in zip(prompts, n_news)]
    cb.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = cb.stats()
    done = {r: cb.done[r] for r in rids}
    if sorted(cb.done) != rids or any(len(done[r]) != n for r, n in zip(rids, n_news)):
        raise AssertionError("ContinuousBatcher did not serve every request in full")
    steps = len(cb._occupancy)
    # decode_traces and retire_traces are 1 by construction (the reference's
    # gate); what shows the pass went through the graph is one replay per
    # decode and no eager decode
    if ((stats["decode_traces"], stats["bucket_misses"], stats["retire_traces"]) != (1, 0, 1)
            or stats["decode"] != "cuda graph"
            or (stats["decode_replays"], stats["eager_decodes"]) != (steps, 0)):
        raise AssertionError(f"after the timed pass ({steps} decodes): {stats}")
    if launches["gossip_mix"] or launches["quant_pack"]:
        raise AssertionError(f"continuous serving launched {launches}")
    if not all(np.isfinite(cb.done_logprobs[r]).all() for r in rids):
        raise AssertionError("non-finite logprobs")
    cont_tps = sum(n_news) / wall
    # both batchers' TTFT: submit to the first token ready on the device
    cont_ttft = float(np.mean([cb.ttft[r] for r in rids]))
    log(f"[continuous] ContinuousBatcher: {sum(n_news)} tokens in {wall:.3f} s = "
        f"{cont_tps:,.1f} generated tokens/s; mean time to first token (ready on the device) "
        f"{cont_ttft * 1e3:.1f} ms; {steps} decode steps, {stats['decode_replays']} graph "
        f"replays, {stats['eager_decodes']} eager, {wall / steps * 1e3:.2f} ms per step() with "
        f"admissions; mean occupancy {stats['mean_occupancy']:.3f}; bucket hits "
        f"{stats['bucket_hits']}, misses {stats['bucket_misses']}; launches {launches}; "
        f"peak memory {peak_gb:.2f} GB")

    # the baseline: the same trace through lock-step waves
    wb = WaveBatcher(params, cfg, CB_SLOTS, CB_MAX_LEN)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wave_rids = [wb.submit(p, n) for p, n in zip(prompts, n_news)]
    wb.run_until_done()
    wave_wall = time.perf_counter() - t0
    if any(len(wb.done[r]) != n for r, n in zip(wave_rids, n_news)):
        raise AssertionError("WaveBatcher did not serve every request in full")
    wave_tps = sum(n_news) / wave_wall
    wave_ttft = float(np.mean([wb.ttft[r] for r in wave_rids]))
    log(f"[continuous] WaveBatcher: {wave_wall:.3f} s = {wave_tps:,.1f} generated tokens/s; mean "
        f"time to first token (ready on the device) {wave_ttft * 1e3:.1f} ms; continuous / wave "
        f"tokens/s {cont_tps / wave_tps:.2f}x, mean TTFT {cont_ttft / wave_ttft:.3f}x "
        f"(not gated)")
    del wb

    with torch.no_grad():
        # decode timings on the empty state: every shape is the pool's, so
        # a step does the same work whether or not its slots are active
        graph_ms = time_cuda(cb._decode, 20)
        eager_ms = time_cuda(lambda: cb.decode_eager(*cb.state()), 5, warmup=1)
        param_bytes = sum(t.nbytes for t in _tree.leaves(params))
        bound_ms, _ = _bound(param_bytes + pool_gb * 1e9, 0.0, card)
        log(f"[continuous] decode step ({CB_SLOTS} slots): CUDA graph replay {graph_ms:.3f} ms, "
            f"the same step eagerly {eager_ms:.3f} ms; bound {bound_ms:.3f} ms (the weights' "
            f"{param_bytes / 1e9:.2f} GB and the pools' {pool_gb:.2f} GB read once at "
            f"{memory_rate(card) / 1e12:.2f} TB/s)")
        profile_call("one graph decode step", cb._decode)
        profile_call("one eager paged decode step", lambda: cb.decode_eager(*cb.state()))

        check_paged_vs_dense(params, cfg, cb, prompts[0])
        check_graph_vs_eager(cb, prompts[1:CB_SLOTS + 1])

        agree = total = 0
        for rid, p, n in zip(rids, prompts, n_news):
            k = min(n, CB_AGREE_TOKENS)
            res = generate(params, cfg, p[None], n_new=k)
            agree += int((res.tokens[0] == done[rid][:k]).sum())
            total += k
        log(f"[continuous] greedy tokens vs one-at-a-time generate(): {agree}/{total} agree "
            f"(first {CB_AGREE_TOKENS} of each request; not gated)")
    del cb, params
    return {"launches": launches}


def phase_slice8() -> dict:
    """Slice 8: the dense variants, sliding windows and MoE. A: each family at
    its published widths served through a WaveBatcher wave whose prompt takes
    the flash kernel; B: gemma-2b through ContinuousBatcher; C: reduced-width
    training of mixtral and gemma on the fused bus. Returns launches by path."""
    t0 = time.perf_counter()
    by_path = {}
    for name, layers, slots, prompt_len, n_new in S8_SERVE:
        by_path[f"slice8_serve_{name}"] = _serve_wave("slice8", name, layers, slots,
                                                      prompt_len, n_new)
    by_path["slice8_continuous_gemma-2b"] = _continuous_family("slice8", "gemma-2b")
    for name in S8_TRAIN:
        by_path[f"slice8_train_{name}"] = _train_family("slice8", name, None, S8_TRAIN_BATCH,
                                                        S8_TRAIN_SEQ)
    log(f"[slice8] the phase took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_slice9() -> dict:
    """Slice 9: MLA, Mamba-2 and the RG-LRU hybrid. A: each family at its
    published widths and full depth through one WaveBatcher wave (slice 8's
    gates, the ring check for the hybrid, the recurrent-decode check for
    Mamba-2); B: deepseek-v2-lite through ContinuousBatcher over the paged
    MLA cache; C: training of mamba2 at published widths (4 layers) and of
    reduced deepseek-v2-lite and recurrentgemma on the fused bus. Returns
    launches by path."""
    t0 = time.perf_counter()
    by_path = {}
    for name, layers, slots, prompt_len, n_new in S9_SERVE:
        by_path[f"slice9_serve_{name}"] = _serve_wave("slice9", name, layers, slots,
                                                      prompt_len, n_new)
    by_path[f"slice9_continuous_{S9_CONTINUOUS}"] = _continuous_family(
        "slice9", S9_CONTINUOUS, paged_check=True)
    for name, layers, batch, seq in S9_TRAIN:
        by_path[f"slice9_train_{name}"] = _train_family("slice9", name, layers, batch, seq)
    log(f"[slice9] the phase took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_slice10() -> dict:
    """Slice 10: the encoder-decoder. A: seamless-m4t-large-v2 at its
    published widths and full depth served through generate(enc_embeds=)
    (the encoder's non-causal attention on the kernel); C: training at
    published widths cut to 2 + 2 layers on the M = 2 clique, fused bus.
    (B, the kernel at the encoder's shape, is a FLASH_PATHS row of the
    kernel phase.) Returns launches by path."""
    t0 = time.perf_counter()
    layers, workers, batch, seq = S10_TRAIN
    by_path = {f"slice10_serve_{S10_NAME}": _serve_encdec(),
               f"slice10_train_{S10_NAME}": _train_family("slice10", S10_NAME, layers, batch,
                                                          seq, workers, "clique")}
    log(f"[slice10] the phase took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_slice11() -> dict:
    """Slice 11: cfg.remat and the worker mesh. A: granite-3-2b at slice
    1's shape trained with remat off and on, the worker mesh on those
    params, the remat gradient gate, then the deepest granite predicted to
    fit (from a probe at DEEP_PROBE layers); B: seamless at slice 10's
    training shape, remat off and on; C: the bf16 router's picks over two
    identical forwards (not gated). Returns launches by path."""
    t0 = time.perf_counter()
    by_path, runs = {}, {}
    for remat in (False, True):
        run = _remat_train("granite-3-2b", N_LAYERS, M_WORKERS, "ring", PER_WORKER_BATCH,
                           SEQ_LEN, remat, keep=remat)
        runs[remat] = run
        by_path[f"slice11_train_granite-3-2b_remat_{'on' if remat else 'off'}"] = run["launches"]
    by_path["slice11_mesh"] = _mesh_check(runs[True].pop("params"), runs[True]["cfg"])
    _remat_gate("granite-3-2b", N_LAYERS, M_WORKERS, S11_GATE_BATCH, SEQ_LEN)
    # the deepest granite at M = 4 under the budget, from the bytes per layer
    # between N_LAYERS and DEEP_PROBE layers (past 4 layers the peak sits in
    # the bus step, whose buffers grow with the params) that the allocator
    # holds (reserved: what must fit the card, its fragmentation included)
    probe = _remat_train("granite-3-2b", DEEP_PROBE, M_WORKERS, "ring", PER_WORKER_BATCH,
                         SEQ_LEN, True)
    by_path[f"slice11_train_granite-3-2b_{DEEP_PROBE}_layers"] = probe["launches"]
    fit = {}
    for key in ("peak_gb", "reserved_gb"):
        per_layer = (probe[key] - runs[True][key]) / (DEEP_PROBE - N_LAYERS)
        fit[key] = (per_layer, runs[True][key] - N_LAYERS * per_layer)
    per_layer, fixed = fit["reserved_gb"]
    depth = min(serve_config().n_layers, int((REMAT_BUDGET_GB - fixed) // per_layer))
    predicted = {k: b + depth * a for k, (a, b) in fit.items()}
    log(f"[slice11 deep] remat peaks allocated / reserved: {runs[True]['peak_gb']:.2f} / "
        f"{runs[True]['reserved_gb']:.2f} GB at {N_LAYERS} layers, {probe['peak_gb']:.2f} / "
        f"{probe['reserved_gb']:.2f} GB at {DEEP_PROBE}: reserved {per_layer:.3f} GB per "
        f"layer over {fixed:.2f} GB; predicted: {depth} layers, reserved "
        f"{predicted['reserved_gb']:.2f} GB (budget {REMAT_BUDGET_GB} GB), allocated "
        f"{predicted['peak_gb']:.2f} GB")
    deep = _remat_train("granite-3-2b", depth, M_WORKERS, "ring", PER_WORKER_BATCH, SEQ_LEN,
                        True)
    by_path[f"slice11_train_granite-3-2b_{depth}_layers"] = deep["launches"]
    log(f"[slice11 deep] {depth} layers with remat: peak allocated {deep['peak_gb']:.2f} GB "
        f"(predicted {predicted['peak_gb']:.2f}), reserved {deep['reserved_gb']:.2f} GB "
        f"(predicted {predicted['reserved_gb']:.2f}), {deep['step_ms']:.1f} ms/step")
    layers, workers, batch, seq = S10_TRAIN
    for remat in (False, True):
        run = _remat_train(S10_NAME, layers, workers, "clique", batch, seq, remat)
        by_path[f"slice11_train_{S10_NAME}_remat_{'on' if remat else 'off'}"] = run["launches"]
    _router_repeat(*S11_MOE)
    log(f"[slice11] the phase took {time.perf_counter() - t0:.1f} s")
    return by_path


def _remat_train(name, layers, workers, topology, batch_size, seq_len, remat,
                 keep=False) -> dict:
    """Five train() steps of ``family_config(name, layers, remat=remat)``
    on ``topology`` over ``workers`` (fused bus, momentum SGD): finite
    losses, one gossip_mix launch per step and nothing else. Returns the
    peak GB, ms/step over steps 1-4, the launches, the config and, with
    ``keep``, the trained params; the peak the allocator reserved too."""
    import torch

    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import train

    tag = f"slice11 {name} {layers} layers remat {'on' if remat else 'off'}"
    fresh_gb("training", tag)
    cfg = family_config(name, layers, remat=remat)
    params0, next_batch, loss = family_setup(cfg, workers, batch_size, seq_len)

    def batches():
        while True:
            yield next_batch()

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, hist = train(loss, params0, momentum_sgd(LR, 0.9), batches(), steps=STEPS,
                        gossip=GossipSpec(topology=T.make(topology, workers), backend="fused"),
                        log_every=STEPS, device="cuda", verbose=False)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 1e9
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"{tag}: non-finite loss {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0,
                    "consensus_stats": stats_launches(state.params, STEPS)}:
        raise AssertionError(f"{tag}: {launches} in {STEPS} steps, want 1 gossip_mix per step")
    out = {"peak_gb": peak, "reserved_gb": torch.cuda.max_memory_reserved() / 1e9,
           "step_ms": hist.step_time[-1] * 1e3, "launches": launches, "cfg": cfg}
    log(f"[{tag}] M={workers} {topology}, {batch_size} x {seq_len} tokens per worker: losses "
        f"{[round(x, 4) for x in hist.loss]}; steps 1-{STEPS - 1} {out['step_ms']:.1f} ms/step; "
        f"launches per step {launches['gossip_mix'] / STEPS:g} gossip_mix, 0 flash_attention; "
        f"peak {peak:.2f} GB (reserved {out['reserved_gb']:.2f} GB)")
    if keep:
        out["params"] = state.params
    del state, params0
    return out


def _remat_gate(name, layers, workers, batch_size, seq_len) -> None:
    """The gradients of one vmapped step with remat on and off: equal bit
    for bit, or, where a kernel on the card is not deterministic, within
    twice the remat-off route's distance from a float32 gradient (its
    float32 twin). Says which case held."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.convert import to_device
    from repro_torch.models import model as Mo

    tag = "slice11 remat gate"
    fresh_gb("the remat gradient gate", tag)
    cfg_on = family_config(name, layers, remat=True)
    cfg_off = dataclasses.replace(cfg_on, remat=False)
    params, next_batch, _ = family_setup(cfg_on, workers, batch_size, seq_len)
    batch = to_device(next_batch(), "cuda")

    def grads(cfg, p):
        return torch.func.vmap(torch.func.grad_and_value(
            lambda q, b: Mo.loss_fn(q, cfg, b)))(p, batch)

    g_on, l_on = grads(cfg_on, params)
    g_off, l_off = grads(cfg_off, params)
    pairs = list(zip(_tree.leaves(g_on), _tree.leaves(g_off)))
    equal = torch.equal(l_on, l_off) and all(torch.equal(a, b) for a, b in pairs)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    if equal:
        log(f"[{tag}] {name} {layers} layers, M={workers}, {batch_size} x {seq_len} tokens per "
            f"worker: loss and all {len(pairs)} gradient leaves with remat on equal remat off "
            f"bit for bit")
        return
    del g_on
    cfg32 = dataclasses.replace(cfg_off, param_dtype="float32", compute_dtype="float32")
    g32, _ = grads(cfg32, _tree.map(lambda x: x.float(), params))
    twin = max((b.float() - c).abs().max().item() for b, c in zip(_tree.leaves(g_off),
                                                                   _tree.leaves(g32)))
    log(f"[{tag}] not bit-equal: remat on vs off max|err| {diff:.3g}, the remat-off route's "
        f"float32 distance {twin:.3g} (tol {2 * twin:.3g})")
    if not diff <= 2 * twin:
        raise AssertionError(f"{tag}: remat on vs off {diff} > twice the float32 distance {twin}")


def _router_repeat(name, layers, batch_size, seq_len) -> None:
    """Not gated: at published widths in bf16, the tokens whose top-k
    expert set differs between two identical forwards of the training route
    (no remat involved: it shows whether the route itself is deterministic
    on the card), then whether one step's gradients with remat on equal
    remat off."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.models import layers as Ly
    from repro_torch.models import model as Mo

    tag = "slice11 router"
    fresh_gb("the router repeat", tag)
    cfg = family_config(name, layers, remat=True)
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (batch_size, seq_len),
                        generator=torch.Generator(device="cuda").manual_seed(2), device="cuda")
    real, runs = Ly._route_logits, []
    for _ in range(2):
        picks = []

        def recording(c, logits, rows=None, picks=picks):
            out = real(c, logits, rows)
            picks.append(out[1].sort(-1).values)
            return out

        Ly._route_logits = recording
        try:
            with torch.no_grad():
                Mo.forward(params, cfg, tok)
        finally:
            Ly._route_logits = real
        runs.append(picks)
    flips = [int((a != b).any(-1).sum()) for a, b in zip(*runs)]
    batch = {"tokens": tok}
    g = [torch.func.grad(lambda p, c=c: Mo.loss_fn(p, c, batch))(params)
         for c in (cfg, dataclasses.replace(cfg, remat=False))]
    pairs = list(zip(*(_tree.leaves(x) for x in g)))
    same = sum(torch.equal(a, b) for a, b in pairs)
    diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    log(f"[{tag}] {name} {layers} layers bf16, {batch_size} x {seq_len} tokens: router top-"
        f"{cfg.top_k} sets differing between two identical forwards, per MoE layer: {flips} "
        f"(not gated); one step's gradients remat on vs off: {same} of {len(pairs)} leaves "
        f"bit-equal, max|err| {diff:.3g} (not gated)")


def _mesh_check(params, cfg) -> dict:
    """The worker mesh on the card: a world-size-1 NCCL process group (a
    FileStore in a temporary directory), the live 1 x 1 WorkerMesh hosting
    all M workers of slice 1's trained params, and on it the fused mix
    (``mix_pytree``), the per-model-shard bus (``param_specs``) and two
    int8 rounds of ``mix_bus_compressed``: each equal to the meshless path
    bit for bit, gossip_mix and quant_pack launched (counted, and seen in a
    profile). Then the single-worker case (no neighbour: nothing launched,
    the params back, as the reference's) and the ``ppermute`` and
    ``allreduce`` backends (NCCL's all-reduce) against the einsum mix
    within the bf16 tolerance. The process group is destroyed before it
    returns the launches of the mesh path."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec, mix_pytree
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    from repro_torch.launch.shardings import local_tree, param_pspecs

    tag = "slice11 mesh"
    t0 = time.perf_counter()

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(_tree.leaves(a), _tree.leaves(b)))

    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=1, device="cuda"))
            topo = T.undirected_ring(M_WORKERS)
            spec = GossipSpec.for_mesh(topo, wm, backend="fused")
            flat = GossipSpec(topology=topo, backend="fused")
            specs = param_pspecs(cfg, wm)
            local = local_tree(params, specs, wm)
            reset_launches()
            mixed = mix_pytree(local, spec, wm)
            sharded = bus.mix_bus(local, spec, wm, param_specs=specs)
            comp1, res1 = bus.mix_bus_compressed(local, spec, wm, wire_dtype="int8")
            comp2, res2 = bus.mix_bus_compressed(comp1, spec, wm, wire_dtype="int8",
                                                 residual=res1)
            torch.cuda.synchronize()
            launches = read_launches()
            if launches != {"gossip_mix": 2, "quant_pack": 2, "flash_attention": 0,
                            "consensus_stats": 0}:
                raise AssertionError(f"{tag}: {launches}, want 2 gossip_mix (the fused and the "
                                     "per-shard mix) and 2 quant_pack (two int8 rounds)")
            # late in a whole run the profiler lost the start of its windows
            # (no gossip_mix in three sessions while the launch counts above
            # held): one warm-up round first, and up to PROFILE_SESSIONS sessions
            for attempt in range(1, PROFILE_SESSIONS + 1):
                rows = profile_call("the fused mix and an int8 round over the mesh", lambda: (
                    mix_pytree(local, spec, wm),
                    bus.mix_bus_compressed(local, spec, wm, wire_dtype="int8")), warmup=1)
                seen = {k: sum(c for n, _, c in rows if k in n.lower())
                        for k in ("gossip_mix", "quant_pack")}
                log(f"[{tag}] profile session {attempt}: kernel launches seen {seen}")
                if all(seen.values()):
                    break
            else:
                raise AssertionError(f"{tag}: {PROFILE_SESSIONS} profiles of the mesh route show "
                                     f"{seen}")
            m1, r1 = bus.mix_bus_compressed(params, flat, wire_dtype="int8")
            m2, r2 = bus.mix_bus_compressed(m1, flat, wire_dtype="int8", residual=r1)
            checks = {"fused mix": same(mixed, mix_pytree(params, flat)),
                      "per-shard bus": same(sharded, bus.mix_bus(params, flat)),
                      "int8 round 1": same(comp1, m1) and same(res1, r1),
                      "int8 round 2": same(comp2, m2) and same(res2, r2)}
            if not all(checks.values()):
                raise AssertionError(f"{tag}: not bit-equal to the meshless path: {checks}")
            del m1, m2, r1, r2, comp1, comp2, res1, res2, sharded
            one = _tree.map(lambda x: x[:1], local)
            reset_launches()
            alone = mix_pytree(one, GossipSpec.for_mesh(T.clique(1), wm, backend="fused"), wm)
            if read_launches()["gossip_mix"] or not same(alone, one):
                raise AssertionError(f"{tag}: a single worker must get its params back, "
                                     "launching nothing")
            norm = params["out_norm"]
            for backend, name in (("ppermute", "ring"), ("allreduce", "clique")):
                t = T.make(name, M_WORKERS)
                got = mix_pytree(norm, GossipSpec.for_mesh(t, wm, backend=backend), wm)
                want = mix_pytree(norm, GossipSpec(topology=t, backend="einsum"))
                err, finite = _params_err(got, want)
                if not finite or err > TOL["bfloat16"]:
                    raise AssertionError(f"{tag}: {backend} vs einsum max|err| {err}")
                log(f"[{tag}] {backend} backend on the mesh vs einsum: max|err| {err:.3g} "
                    f"(bf16 tol {TOL['bfloat16']})")
            log(f"[{tag}] {wm.describe()} over {dist.get_backend()}, {M_WORKERS} workers "
                f"on the rank: fused mix, per-shard bus and 2 int8 rounds bit-equal to the "
                f"meshless path; launches {launches}; the profile shows {seen}; single worker "
                f"unchanged, nothing launched; {time.perf_counter() - t0:.1f} s")
        finally:
            dist.destroy_process_group()
    return launches


def phase_slice12() -> dict:
    """Slice 12: decentralized training over the worker axes of a live
    mesh. Slice 1's training shape (granite-3-2b, 4 layers, remat on, M = 4
    ring, momentum SGD, 8 x 512 tokens per worker) trained 5 steps meshless
    and through ``train(mesh=wm, param_specs=...)`` on a world-size-1 NCCL
    group's 1 x 1 WorkerMesh (all 4 workers on the rank), each pair from
    the same seeds: a monolithic checkpoint at the end, then asynchronous
    sharded checkpoints every 2 steps (the writer pins its host memory on
    its own thread), then ``mode='allreduce'``. Gates:
    losses and final params bit-equal to meshless, one gossip_mix launch
    per step, the checkpoints' npz members byte-equal to the meshless
    run's, the async sharded saves (meshless and mesh: one snapshot path,
    a pinned host copy) raising the device peak by less than half the
    tree's bytes. Then ``run_simulated(mesh=WorkerMesh)`` on an
    abstract (pod, data) = (2, 2) mesh: each link class's bytes are its
    messages times the mesh's payload. Returns launches by path."""
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import train

    tag = "slice12"
    t0 = time.perf_counter()
    fresh_gb("training over the mesh", tag)
    cfg = family_config("granite-3-2b", N_LAYERS, remat=True)
    params0, next_batch, loss = family_setup(cfg, M_WORKERS, PER_WORKER_BATCH, SEQ_LEN)
    batches = [next_batch() for _ in range(STEPS)]
    tree_gb = sum(x.numel() * x.element_size() for x in _tree.leaves(params0)) / 1e9
    spec = GossipSpec(topology=T.undirected_ring(M_WORKERS), backend="fused")
    opt = momentum_sgd(LR, 0.9)
    root = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    by_path, runs = {}, {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1),
                                rank=0, world_size=1)
        try:
            wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=1, device="cuda"))
            specs = param_pspecs(cfg, wm, "gossip")
            single = _tree.map(lambda x: x[0].clone(), params0)
            rows = [{"tokens": b["tokens"].reshape((-1,) + b["tokens"].shape[2:])}
                    for b in batches]
            sharded = lambda d: dict(ckpt_path=f"{d}/ck.npz", ckpt_sharded=True, ckpt_every=2)
            plans = [  # (label, where, mesh argument, train keywords)
                ("mono", "meshless", None, dict(ckpt_path="flat-mono/ck.npz")),
                ("mono", "mesh", wm, dict(ckpt_path="mesh-mono/ck.npz")),
                ("sharded", "meshless", None, sharded("flat-sh")),
                # a bare DeviceMesh: the shards keep the meshless w{j} names,
                # as the reference's train() names them for a raw mesh (its
                # worker_coords refuses 4 workers on a 1-worker WorkerMesh)
                ("sharded", "mesh", wm.mesh, sharded("mesh-sh")),
                ("allreduce", "meshless", None, dict(mode="allreduce")),
                ("allreduce", "mesh", wm, dict(mode="allreduce"))]
            for label, where, mesh, kw in plans:
                if "ckpt_path" in kw:
                    kw["ckpt_path"] = os.path.join(tmp, kw["ckpt_path"])
                allreduce = kw.get("mode") == "allreduce"
                mesh_kw = {} if mesh is None else dict(
                    mesh=mesh, param_specs=None if allreduce else specs)
                collect()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                state, hist = train(loss, single if allreduce else params0, opt,
                                    iter(rows if allreduce else batches), steps=STEPS,
                                    gossip=None if allreduce else spec, log_every=STEPS,
                                    device="cuda", verbose=False, **mesh_kw, **kw)
                torch.cuda.synchronize()
                # on the host, so every run starts from the same device memory
                run = {"loss": hist.loss, "params": _tree.map(lambda x: x.cpu(), state.params),
                       "launches": read_launches(),
                       "ms": hist.step_time[-1] * 1e3,
                       "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                       "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
                runs[(label, where)] = run
                del state
                want = 0 if allreduce else STEPS
                stats = stats_launches(run["params"], STEPS,
                                       mesh=mesh is not None and not allreduce)
                if run["launches"] != {"gossip_mix": want, "quant_pack": 0, "flash_attention": 0,
                                       "consensus_stats": stats}:
                    raise AssertionError(f"{tag} {label} {where}: {run['launches']} in {STEPS} "
                                         f"steps, want {want} gossip_mix")
                if not all(math.isfinite(x) for x in hist.loss):
                    raise AssertionError(f"{tag} {label} {where}: non-finite loss {hist.loss}")
                log(f"[{tag}] {label} {where}: losses {[round(x, 4) for x in hist.loss]}; "
                    f"steps 1-{STEPS - 1} {run['ms']:.1f} ms/step; launches {run['launches']};"
                    f" peak {run['peak_gb']:.2f} GB allocated, {run['reserved_gb']:.2f} GB "
                    f"reserved")
                if where != "meshless":
                    by_path[f"slice12_train_{label}_{where.replace(', ', '_')}"] = run["launches"]
            for (label, where), a in runs.items():
                if where == "meshless":
                    continue
                b = runs[(label, "meshless")]
                same = a["loss"] == b["loss"] and all(
                    torch.equal(x, y) for x, y in zip(_tree.leaves(a["params"]),
                                                      _tree.leaves(b["params"])))
                if not same:
                    err, _ = _params_err(a["params"], b["params"])
                    raise AssertionError(f"{tag} {label} {where}: not bit-equal to meshless "
                                         f"(losses {a['loss']} vs {b['loss']}, params max|err| "
                                         f"{err})")
                log(f"[{tag}] {label}, {where}: {a['ms']:.1f} ms/step vs meshless {b['ms']:.1f} "
                    f"({100 * (a['ms'] / b['ms'] - 1):+.1f}%); peak allocated {a['peak_gb']:.2f} "
                    f"vs {b['peak_gb']:.2f} GB, reserved {a['reserved_gb']:.2f} vs "
                    f"{b['reserved_gb']:.2f} GB")
            files = _same_checkpoints(os.path.join(tmp, "mesh-mono"),
                                      os.path.join(tmp, "flat-mono"))
            files += _same_checkpoints(os.path.join(tmp, "mesh-sh"),
                                       os.path.join(tmp, "flat-sh"))
            rise = max(runs[("sharded", w)]["peak_gb"] for w in ("meshless", "mesh")) \
                - min(runs[("mono", w)]["peak_gb"] for w in ("meshless", "mesh"))
            if not rise < tree_gb / 2:
                raise AssertionError(f"{tag}: the async sharded save raised the device peak by "
                                     f"{rise:.3f} GB, the tree is {tree_gb:.3f} GB")
            log(f"[{tag}] {wm.describe()} over {dist.get_backend()}: losses and params of the "
                f"monolithic, sharded and allreduce runs bit-equal to meshless; {files} "
                f"checkpoint "
                f"files' npz members byte-equal to the meshless run's; the async sharded save "
                f"raised the peak by {rise:+.3f} GB at most, meshless and on the mesh (tree "
                f"{tree_gb:.3f} GB, gate < half)")
        finally:
            dist.destroy_process_group()
    del runs, params0, batches
    _sim_on_worker_mesh(tag)
    log(f"[{tag}] the phase took {time.perf_counter() - t0:.1f} s")
    return by_path


def phase_slice13() -> dict:
    """Slice 13: tensor-parallel training over the model axis. Slice 1's
    training shape (granite-3-2b, 4 layers, remat on, M = 4 ring, momentum
    SGD, 8 x 512 tokens per worker) on a live (data=1, model=2)
    ``WorkerMesh``: two processes on the one card in a gloo group on CUDA
    tensors (``make_host_mesh(device='cuda', backend='gloo')``), each
    running ``train(mesh=..., param_specs=param_pspecs(cfg, wm, 'gossip'))``
    with one asynchronous sharded checkpoint at the end; every worker's
    neighbours are on the rank, so the collectives are gloo's all_reduce
    (the tensor-parallel layers, the metrics) and all_gather (the bus's
    row-split leaves, the checkpoint's gather). Rank 0 then trains the
    meshless twin from the same seeds in bf16 and in float32 (:func:`_tp_rank`).
    Gates: finite losses, the same on both ranks; per rank one gossip_mix
    launch per step, each over the rows of the rank's half of the bus
    (tensor-sharded leaves as local shards, the others row-split); the
    ranks' params gathered and the losses within twice the meshless bf16
    run's distance from the float32 run; the checkpoint restored onto the
    mesh bit-equal to each rank's params; each rank's peak allocated
    memory below the meshless run's. The ranks' ms/step are gloo's staging
    through host memory, not NCCL's. Slices 14 and 15 run in the same
    processes (:func:`_s14_rank`, :func:`_s15_rank`, :func:`_tp_twin`,
    gated by :func:`_gate_slice14` and :func:`_gate_slice15`). Returns
    launches by path."""
    import tempfile

    import torch

    tag = "slice13"
    t0 = time.perf_counter()
    fresh_gb("two tensor-parallel ranks", tag)
    root = os.path.join(ROOT, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=root) as tmp:
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--tp-rank",
                                   str(r), tmp], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(S13_RANKS)]
        logs = []
        try:
            for proc in procs:
                logs.append(proc.communicate(timeout=S13_TIMEOUT)[0])
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for r, (proc, out) in enumerate(zip(procs, logs)):
            for line in out.splitlines():
                log(f"[{tag}] rank {r}: {line}")
        bad = [r for r, proc in enumerate(procs) if proc.returncode]
        if bad:
            raise AssertionError(f"{tag}: ranks {bad} failed (exit codes "
                                 f"{[p.returncode for p in procs]})")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(S13_RANKS)]
        twins = torch.load(os.path.join(tmp, "twins.pt"))
        ranks14 = [torch.load(os.path.join(tmp, f"s14-rank{r}.pt")) for r in range(S13_RANKS)]
        twins14 = torch.load(os.path.join(tmp, "s14-twins.pt"))
        ranks15 = [torch.load(os.path.join(tmp, f"s15-rank{r}.pt"), weights_only=False)
                   for r in range(S13_RANKS)]
        twins15 = torch.load(os.path.join(tmp, "s15-twins.pt"))
        serve15 = torch.load(os.path.join(tmp, "s15-serve-twins.pt"), weights_only=False)
    flat, f32 = twins["bf16"], twins["float32"]
    by_path = {}
    for i, r in enumerate(ranks):
        if r["launches"] != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0,
                             "consensus_stats": r["stats_launches"]}:
            raise AssertionError(f"{tag} rank {i}: {r['launches']} in {STEPS} steps, want "
                                 f"one gossip_mix per step")
        if r["rows"] != [r["planned_rows"]] * STEPS or \
                not r["planned_rows"] <= 0.51 * r["whole_rows"]:
            raise AssertionError(f"{tag} rank {i}: gossip_mix over {r['rows']} rows, the rank's "
                                 f"half of the bus is {r['planned_rows']} of "
                                 f"{r['whole_rows']}")
        if not all(math.isfinite(x) for x in r["loss"]) or r["loss"] != ranks[0]["loss"]:
            raise AssertionError(f"{tag} rank {i}: losses {r['loss']} vs rank 0's "
                                 f"{ranks[0]['loss']}")
        if not r["restored_equal"]:
            raise AssertionError(f"{tag} rank {i}: the checkpoint restored onto the mesh "
                                 f"differs from the rank's params")
        if not r["peak_gb"] < flat["peak_gb"]:
            raise AssertionError(f"{tag} rank {i}: peak {r['peak_gb']:.2f} GB allocated, the "
                                 f"meshless run's {flat['peak_gb']:.2f} GB")
        by_path[f"slice13_train_tp_rank{i}"] = r["launches"]
    err, own = twins["err"], twins["own"]
    loss_own = max(abs(a - b) for a, b in zip(flat["loss"], f32["loss"]))
    loss_err = max(abs(a - b) for a, b in zip(ranks[0]["loss"], f32["loss"]))
    if not twins["finite"] or err > 2 * own or loss_err > 2 * loss_own:
        raise AssertionError(f"{tag}: the ranks' params are {err:.4g} from the float32 run "
                             f"(meshless bf16: {own:.4g}), their losses {loss_err:.4g} "
                             f"(meshless bf16: {loss_own:.4g}); gate twice")
    log(f"[{tag}] losses, tensor parallel {[round(x, 4) for x in ranks[0]['loss']]}, meshless "
        f"{[round(x, 4) for x in flat['loss']]}, float32 {[round(x, 4) for x in f32['loss']]}")
    log(f"[{tag}] data=1 x model=2, two ranks on one card over gloo: params max|err| "
        f"{err:.4g} from the float32 run (meshless bf16 {own:.4g}), losses {loss_err:.4g} "
        f"({loss_own:.4g}); gate twice: held")
    for i, r in enumerate(ranks):
        log(f"[{tag}] rank {i}: steps 1-{STEPS - 1} {r['ms']:.1f} ms/step (gloo-staged, not "
            f"NCCL); peak {r['peak_gb']:.2f} GB allocated ({r['peak_gb'] / flat['peak_gb']:.3f}"
            f" of meshless), {r['reserved_gb']:.2f} GB reserved; gossip_mix over "
            f"{r['planned_rows']:,} of {r['whole_rows']:,} bus rows; the async sharded save's "
            f"write {r['write_s']:.2f} s on the writer's thread")
    log(f"[{tag}] meshless bf16: {flat['ms']:.1f} ms/step, peak {flat['peak_gb']:.2f} GB "
        f"allocated, {flat['reserved_gb']:.2f} GB reserved; float32: {f32['ms']:.1f} ms/step, "
        f"peak {f32['peak_gb']:.2f} GB")
    by_path.update(_gate_slice14(ranks14, twins14))
    by_path.update(_gate_slice15(ranks15, twins15, serve15))
    log(f"[{tag}] the phase (slices 13, 14 and 15) took {time.perf_counter() - t0:.1f} s")
    return by_path


def _gate_slice14(ranks: list, twins: dict) -> dict:
    """Slice 14's gates (:func:`_s14_rank`, :func:`_tp_twin`). A, B:
    :func:`_gate_tp_train`; its step-0 loss (identical params, before any
    update) is read token by token: one scalar loss's distance from float32
    is a single draw of rounding noise, which may land near zero for either
    route; a mean over thousands of tokens does not. The params after the
    steps are only reported beside the twin's: router near-ties flip
    between summation orders. C, D: every rank within rtol 1e-5 / atol 1e-6
    of the meshless float32 steps. Returns launches by path."""
    tag = "slice14"
    by_path = _gate_tp_train(tag, [name for name, *_ in S14_TRAIN], ranks, twins)
    for i, r in enumerate(ranks):
        bad = {n: c for n, c in r["narrow"].items() if not c["ok"]}
        if bad or r["narrow_launches"]["gossip_mix"] != 2 * len(S14_ARCHS):
            raise AssertionError(f"{tag} rank {i}: narrow float32 configs off the meshless "
                                 f"step: {bad}; launches {r['narrow_launches']}")
        if not r["rows_cut"]["ok"]:
            raise AssertionError(f"{tag} rank {i}: the rows-cut global MoE is "
                                 f"{r['rows_cut']['err']:.3g} from the meshless allreduce step")
        by_path[f"slice14_narrow_f32_rank{i}"] = r["narrow_launches"]
    log(f"[{tag}] narrow float32 on the (1, 2) mesh vs meshless, max|err| per config: "
        + ", ".join(f"{n} {c['err']:.3g}" for n, c in ranks[0]["narrow"].items())
        + f"; the rows-cut global MoE on a (2, 1) mesh vs the whole batch: "
        f"{max(r['rows_cut']['err'] for r in ranks):.3g}, losses {ranks[0]['rows_cut']['loss']} "
        f"(rtol {S14_RTOL} / atol {S14_ATOL}: held)")
    return by_path


def _gate_tp_train(tag: str, names, ranks: list, twins: dict) -> dict:
    """The training gates of slices 14 and 15 (:func:`_tp_train`,
    :func:`_tp_twin`), per config: finite losses, the same on both ranks;
    one gossip_mix launch per step per rank over the rank's half of the bus
    rows; the checkpoint restored onto the mesh bit-equal; each rank's peak
    allocated below the meshless bf16 run's; the step-0 token losses within
    twice the meshless bf16 forward's mean distance from a float32 forward.
    Returns launches by path."""
    by_path = {}
    for name in names:
        twin = twins[name]
        runs = [r["train"][name] for r in ranks]
        for i, r in enumerate(runs):
            if r["launches"] != {"gossip_mix": S14_STEPS, "quant_pack": 0, "flash_attention": 0,
                                 "consensus_stats": r["stats_launches"]}:
                raise AssertionError(f"{tag} {name} rank {i}: {r['launches']} in {S14_STEPS} "
                                     "steps, want one gossip_mix per step")
            if r["rows"] != [r["planned_rows"]] * S14_STEPS or \
                    not r["planned_rows"] <= 0.51 * r["whole_rows"]:
                raise AssertionError(f"{tag} {name} rank {i}: gossip_mix over {r['rows']} rows, "
                                     f"the rank's half of the bus is {r['planned_rows']} of "
                                     f"{r['whole_rows']}")
            if not all(math.isfinite(x) for x in r["loss"]) or r["loss"] != runs[0]["loss"]:
                raise AssertionError(f"{tag} {name} rank {i}: losses {r['loss']} vs rank 0's "
                                     f"{runs[0]['loss']}")
            if not r["restored_equal"]:
                raise AssertionError(f"{tag} {name} rank {i}: the checkpoint restored onto the "
                                     "mesh differs from the rank's params")
            if not r["peak_gb"] < twin["peak_gb"]:
                raise AssertionError(f"{tag} {name} rank {i}: peak {r['peak_gb']:.2f} GB "
                                     f"allocated, the meshless run's {twin['peak_gb']:.2f} GB")
            by_path[f"{tag}_train_tp_{name}_rank{i}"] = r["launches"]
        err, own = twin["tok_tp"], twin["tok_bf16"]
        if not twin["finite"] or err > 2 * own:
            raise AssertionError(f"{tag} {name}: the ranks' step-0 token losses are {err:.4g} "
                                 f"from the float32 forward's on the mean (meshless bf16: "
                                 f"{own:.4g}); gate twice")
        tp0, bf0, f0 = twin["loss0"]
        log(f"[{tag}] {name}: losses, tensor parallel {[round(x, 4) for x in runs[0]['loss']]}, "
            f"meshless {[round(x, 4) for x in twin['loss']]}; step-0 token losses "
            f"mean|err| {err:.4g} from the float32 forward's (meshless bf16 {own:.4g}); gate "
            f"twice: held; their means {tp0:.5f}, {bf0:.5f}, float32 {f0:.5f}; params after "
            f"{S14_STEPS} steps max|err| {twin['err']:.4g} from the meshless bf16 run's (not "
            "gated: near-ties)")
        for i, r in enumerate(runs):
            log(f"[{tag}] {name} rank {i}: steps 1-{S14_STEPS - 1} {r['ms']:.1f} ms/step "
                f"(gloo-staged, not NCCL); {r['share']:.3f} of a replica's parameters; peak "
                f"{r['peak_gb']:.2f} GB allocated ({r['peak_gb'] / twin['peak_gb']:.3f} of "
                f"meshless), {r['reserved_gb']:.2f} GB reserved; gossip_mix over "
                f"{r['planned_rows']:,} of {r['whole_rows']:,} bus rows; the async sharded "
                f"save's write {r['write_s']:.2f} s")
        log(f"[{tag}] {name} meshless bf16: {twin['ms']:.1f} ms/step, peak "
            f"{twin['peak_gb']:.2f} GB allocated, {twin['reserved_gb']:.2f} GB reserved")
    return by_path


def _tp_rank(rank: int, tmp: str) -> None:
    """One rank of slice 13 (``chip_smoke.py --tp-rank RANK DIR``): trains
    on the (data=1, model=2) mesh and writes its numbers to ``DIR``; rank 0
    keeps the params gathered over the model group on the host and, once
    rank 1 has left the card, trains the meshless twins (bf16, float32)
    and writes their numbers and the distances of the params from the
    float32 run."""
    import dataclasses
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.launch.tensor_parallel import model_cut, whole_leaves
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import train

    t0, marks = time.perf_counter(), []

    def mark(label: str) -> None:      # where the rank's time goes
        marks.append(f"{label} {time.perf_counter() - t0:.1f}")

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = family_config("granite-3-2b", N_LAYERS, remat=True)
    params0, next_batch, loss = family_setup(cfg, M_WORKERS, PER_WORKER_BATCH, SEQ_LEN)
    batches = [next_batch() for _ in range(STEPS)]
    spec = GossipSpec(topology=T.undirected_ring(M_WORKERS), backend="fused")
    opt = momentum_sgd(LR, 0.9)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(tmp, "store"),
                                                         S13_RANKS),
                            rank=rank, world_size=S13_RANKS, timeout=timedelta(seconds=300))
    wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=S13_RANKS, device="cuda",
                                             backend="gloo"))
    specs = param_pspecs(cfg, wm, "gossip")
    # bound to the mesh: the bus gossips per model shard
    mesh_spec = GossipSpec.for_mesh(spec.topology, wm, backend="fused")
    rows, launch = [], bus.gossip_mix_2d

    def counted(w, *args, **kw):      # the rows of each launch on the bus
        rows.append(int(w.shape[-2]))
        return launch(w, *args, **kw)

    bus.gossip_mix_2d = counted
    ck = os.path.join(tmp, "tp", "ck.npz")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mark("set-up")
    # the bare DeviceMesh: the shards keep the meshless w{j} names (a
    # WorkerMesh of one worker refuses to name 4, as the reference's)
    state, hist = train(loss, params0, opt, iter(batches), steps=STEPS, gossip=mesh_spec,
                        mesh=wm.mesh, param_specs=specs, ckpt_path=ck, ckpt_sharded=True,
                        log_every=STEPS, device="cuda", verbose=False)
    torch.cuda.synchronize()
    bus.gossip_mix_2d = launch
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    mark(f"5 steps (step 0 {hist.step_time[0]:.1f} s) and the save")
    like = _tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params0)
    back = ckpt_lib.restore(ck, like, device="cuda", wmesh=wm, param_specs=specs)
    _drop_checkpoint(rank, ck)
    mark("restore")
    leaves, treedef = _tree.flatten(state.params)
    flags = bus.sharded_leaf_flags(specs, wm.model_axis, treedef=treedef)
    planned = bus.plan_layout(state.params, shards=S13_RANKS, leaf_sharded=flags)
    m = M_WORKERS // wm.n_workers      # a launch covers the rank's workers' rows
    out = {"loss": hist.loss, "launches": launches, "rows": rows,
           "stats_launches": stats_launches(state.params, STEPS, mesh=True),
           "planned_rows": m * planned.groups[0].rows,
           "whole_rows": M_WORKERS * bus.plan_layout(params0).groups[0].rows,
           "ms": hist.step_time[-1] * 1e3, "peak_gb": peak_gb, "reserved_gb": reserved_gb,
           "write_s": sum(hist.ckpt_write_s),
           "restored_equal": all(torch.equal(a, b) for a, b in
                                 zip(_tree.leaves(back), leaves))}
    print(f"{wm.describe()} over {dist.get_backend()} on {torch.cuda.get_device_name(0)}; "
          f"losses {[round(x, 4) for x in hist.loss]}; launches {launches}", flush=True)
    whole = [x.cpu() for x in whole_leaves(leaves, model_cut(specs, treedef, wm))]
    mark("gather")
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    del state, back, leaves
    # slice 14 in the same processes; slice 13's inputs wait on the host
    params0 = _tree.map(_host, params0)
    batches = [_tree.map(_host, b) for b in batches]
    gc.collect()
    torch.cuda.empty_cache()
    _s14_rank(rank, tmp, wm, mark)
    _s15_rank(rank, tmp, wm, mark)
    dist.barrier()
    dist.destroy_process_group()
    left = os.path.join(tmp, "rank1.left")
    if rank:
        del params0, batches, whole
        gc.collect()
        torch.cuda.empty_cache()
        open(left, "w").close()
        return
    t_wait = time.perf_counter()
    while not os.path.exists(left):
        if time.perf_counter() - t_wait > 120:
            raise RuntimeError("rank 1 did not leave the card")
        time.sleep(0.5)
    mark("rank 1 gone")
    # back on the card, as they were beside the ranks' own runs
    params0 = _tree.map(lambda x: x.to("cuda"), params0)
    twins, kept = {}, {}
    for dtype in ("bf16", "float32"):
        c = cfg if dtype == "bf16" else dataclasses.replace(
            cfg, param_dtype="float32", compute_dtype="float32")
        p0 = params0 if dtype == "bf16" else _tree.map(lambda x: x.float(), params0)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state, hist = train(lambda p, b, c=c: Mo.loss_fn(p, c, b), p0, opt, iter(batches),
                            steps=STEPS, gossip=spec, log_every=STEPS, device="cuda",
                            verbose=False)
        torch.cuda.synchronize()
        twins[dtype] = {"loss": hist.loss, "ms": hist.step_time[-1] * 1e3,
                        "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                        "reserved_gb": torch.cuda.max_memory_reserved() / 1e9}
        kept[dtype] = _tree.leaves(state.params) if dtype == "float32" else \
            [x.cpu() for x in _tree.leaves(state.params)]
        del state, p0
        print(f"meshless {dtype}: losses {[round(x, 4) for x in hist.loss]}", flush=True)
        mark(f"{dtype} twin")
    # each leaf's distance from the float32 run, one leaf on the card at a time
    twins["err"] = max((a.to(b.device).float() - b).abs().max().item()
                       for a, b in zip(whole, kept["float32"]))
    twins["own"] = max((a.to(b.device).float() - b).abs().max().item()
                       for a, b in zip(kept["bf16"], kept["float32"]))
    twins["finite"] = all(bool(torch.isfinite(x).all()) for x in whole)
    mark("distances")
    torch.save(twins, os.path.join(tmp, "twins.pt"))
    del kept, whole, params0, batches
    print(f"seconds since start: {', '.join(marks)}", flush=True)


def _host(x):
    """A tensor moved to the host; a numpy batch as it is."""
    return x.cpu() if hasattr(x, "cpu") else x


def _s14_rank(rank: int, tmp: str, wm, mark) -> dict:
    """Slice 14 on one rank of slice 13's (data=1, model=2) mesh; writes
    its numbers to ``tmp/s14-rank{rank}.pt``. A, B: each config of
    S14_TRAIN through :func:`_tp_train`. C: the narrow float32 configs, two
    steps on the mesh against the meshless step, each rank against its cut.
    D: reduced mixtral routed over the whole batch in allreduce mode on a
    (data=2, model=1) mesh of the same two processes (the rows cut over the
    ranks) against the meshless allreduce step over the whole batch.
    After each A/B config rank 0 computes its twins (:func:`_tp_twin`,
    written to ``tmp/s14-twins.pt``)."""
    import torch

    out, twins = {"train": {}}, {}
    for name, layers, workers, batch, seq in S14_TRAIN:
        out["train"][name], kept = _tp_train(rank, tmp, wm, mark, "s14", name, layers,
                                             workers, batch, seq)
        twins[name] = _tp_twin(rank, kept, mark)
        del kept
    out["narrow"], out["narrow_launches"] = _s14_narrow(wm)
    mark("narrow float32 configs")
    out["rows_cut"] = _s14_rows_cut()
    mark("the rows-cut global MoE")
    torch.save(out, os.path.join(tmp, f"s14-rank{rank}.pt"))
    if rank == 0:
        torch.save(twins, os.path.join(tmp, "s14-twins.pt"))


def _drop_checkpoint(rank: int, path: str) -> None:
    """Once every rank is past it, rank 0 removes the checkpoint directory
    of ``path``: the phase's checkpoints would otherwise pile up in the
    host's memory where the temporary directory is held there."""
    import torch.distributed as dist

    dist.barrier()
    if rank == 0:
        shutil.rmtree(os.path.dirname(path), ignore_errors=True)


def _tp_train(rank: int, tmp: str, wm, mark, prefix: str, name: str, layers: int,
              workers: int, batch: int, seq: int, keep: bool = False):
    """One config at its published widths cut to ``layers`` through
    ``train(mesh=wm.mesh, param_specs=...)`` on the ring of ``workers``,
    remat on, S14_STEPS steps and one async sharded checkpoint at the end
    (``tmp/{prefix}-{name}/ck.npz``), restored onto the mesh (then dropped
    unless ``keep``); the step-0 token losses on the mesh before. Returns (its numbers; for rank 0's
    twins its config, inputs (on the host), params gathered over the model
    group and step-0 token losses, else None)."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.launch.tensor_parallel import model_cut, whole_leaves
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import checkpoint as ckpt_lib
    from repro_torch.train import train

    rows, launch = [], bus.gossip_mix_2d

    def counted(w, *args, **kw):      # the rows of each launch on the bus
        rows.append(int(w.shape[-2]))
        return launch(w, *args, **kw)

    cfg = family_config(name, layers, remat=True)
    params0, next_batch, loss = family_setup(cfg, workers, batch, seq)
    params0 = _tree.map(_host, params0)      # train() moves the rank's cut
    batches = [_tree.map(_host, next_batch()) for _ in range(S14_STEPS)]
    specs = param_pspecs(cfg, wm, "gossip")
    spec = GossipSpec.for_mesh(T.undirected_ring(workers), wm, backend="fused")
    ck = os.path.join(tmp, f"{prefix}-{name}", "ck.npz")
    tok_tp = _s14_step0(params0, batches[0], cfg, specs, wm)
    mark(f"{name}: step-0 forward on the mesh")
    bus.gossip_mix_2d = counted
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    state, hist = train(loss, params0, momentum_sgd(LR, 0.9), iter(batches),
                        steps=S14_STEPS, gossip=spec, mesh=wm.mesh, param_specs=specs,
                        ckpt_path=ck, ckpt_sharded=True, log_every=S14_STEPS,
                        device="cuda", verbose=False)
    torch.cuda.synchronize()
    bus.gossip_mix_2d = launch
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    reserved_gb = torch.cuda.max_memory_reserved() / 1e9
    mark(f"{name}: {S14_STEPS} steps (step 0 {hist.step_time[0]:.1f} s) and the save")
    like = _tree.map(lambda x: torch.empty(x.shape, dtype=x.dtype, device="meta"), params0)
    back = ckpt_lib.restore(ck, like, device="cuda", wmesh=wm, param_specs=specs)
    leaves, treedef = _tree.flatten(state.params)
    restored = all(torch.equal(a, b) for a, b in zip(_tree.leaves(back), leaves))
    del back
    if not keep:
        _drop_checkpoint(rank, ck)
    mark(f"{name}: restore")
    flags = bus.sharded_leaf_flags(specs, wm.model_axis, treedef=treedef)
    planned = bus.plan_layout(state.params, shards=wm.model_factor, leaf_sharded=flags)
    local_n = sum(x.numel() for x in leaves)
    whole = [x.cpu() for x in whole_leaves(leaves, model_cut(specs, treedef, wm))]
    mark(f"{name}: gather")
    entry = {
        "loss": hist.loss, "launches": launches, "rows": list(rows),
        "stats_launches": stats_launches(state.params, S14_STEPS, mesh=True),
        "planned_rows": workers * planned.groups[0].rows,
        "whole_rows": workers * bus.plan_layout(like).groups[0].rows,
        "ms": hist.step_time[-1] * 1e3, "peak_gb": peak_gb, "reserved_gb": reserved_gb,
        "write_s": sum(hist.ckpt_write_s), "restored_equal": restored,
        "share": local_n / sum(x.numel() for x in whole)}
    print(f"{name} on {wm.describe()}: losses {[round(x, 4) for x in hist.loss]}; "
          f"launches {launches}; peak {peak_gb:.2f} GB", flush=True)
    kept = (cfg, params0, batches, whole, tok_tp) if rank == 0 else None
    del state, leaves
    gc.collect()
    torch.cuda.empty_cache()
    return entry, kept


def _s14_step0(params0, batch, cfg, specs=None, wm=None, f32: bool = False):
    """The per-token next-token losses (float32, on the host) of every
    worker's params and batch before any update, one worker at a time, as
    ``model.loss_fn``'s cross entropy computes them (the MoE aux term
    aside): on ``wm``'s mesh from the rank's cut of ``params0`` inside
    ``model_parallel`` (the final hidden states are whole on every model
    rank), or meshless; ``f32``: a float32 forward of the same params. The
    logits come from the whole unembedding, a row at a time."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.launch.mesh import model_parallel
    from repro_torch.launch.shardings import local_tree
    from repro_torch.models import model as Mo
    from repro_torch.models.attention import f32_product

    local = params0 if wm is None else local_tree(params0, specs, wm)
    c = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32") if f32 else cfg
    dtype = getattr(torch, c.param_dtype)
    out = []
    with torch.no_grad(), model_parallel(wm):
        for j in range(params0["embed"].shape[0]):
            p = _tree.map(lambda x: x[j].to("cuda", dtype), local)
            W = Mo._unembed(_tree.map(lambda x: x[j], params0), cfg).to("cuda", dtype)
            b = _tree.map(lambda x: torch.as_tensor(x[j], device="cuda"), batch)
            memory = Mo.encode(p, c, b["enc_embeds"]) if c.encoder_layers else None
            h, _, _ = Mo._forward(p, c, b["tokens"][:, :-1], memory=memory)
            labels = b["tokens"][:, 1:].long()
            for r in range(h.shape[0]):
                logits = f32_product("ld,dv->lv", h[r], W)
                gold = torch.gather(logits, -1, labels[r, :, None])[:, 0]
                out.append((torch.logsumexp(logits, -1) - gold).cpu())
            del p, W, h, memory
    return torch.cat(out)


def _s14_narrow_inputs(name: str, mode: str, archs: dict = S14_ARCHS):
    """(config, global params, batches) of a narrow float32 config of
    ``archs`` on the card, from numpy seeds: different weights per worker;
    allreduce mode one replica and the workers' rows together."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    M, rows, L, frames = S14_NARROW_SHAPE
    extra = dict(archs[name], router_aux_coef=1.0) if mode == "allreduce" else archs[name]
    cfg = get_config(name, reduced=True, **S14_NARROW, **extra)
    rng = np.random.default_rng(3)
    params = _tree.map(lambda d: torch.from_numpy(
        (0.05 * rng.normal(size=(M,) + tuple(d.shape))
         + (1.0 if d.init == "ones" else 0.0)).astype(np.float32)).cuda(), Mo.model_defs(cfg))
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        b = {"tokens": torch.from_numpy(rng.integers(0, 256, (M, rows, L))).cuda()}
        if cfg.encoder_layers:
            b["enc_embeds"] = torch.from_numpy(rng.normal(
                size=(M, rows, frames, cfg.d_model)).astype(np.float32)).cuda()
        batches.append(b)
    if mode == "allreduce":
        params = _tree.map(lambda x: x[0].clone(), params)
        batches = [_tree.map(lambda x: x.reshape((M * rows,) + x.shape[2:]), b)
                   for b in batches]
    return cfg, params, batches


def _s14_steps(cfg, params, batches, mode: str, wm=None):
    """Two steps of ``make_train_step`` (momentum SGD; gossip mode on the
    fused bus over a ring of the workers) from this rank's cut on a mesh:
    (params, metrics, gossip_mix launches)."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.shardings import local_tree, param_pspecs
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd

    opt, gossip, specs = momentum_sgd(0.05, 0.9), None, None
    if mode == "gossip":
        ring = T.undirected_ring(S14_NARROW_SHAPE[0])
        gossip = GossipSpec(topology=ring, backend="fused") if wm is None else \
            GossipSpec.for_mesh(ring, wm, backend="fused")
    if wm is not None:
        specs = param_pspecs(cfg, wm, mode)
        params = local_tree(params, specs, wm)
        batches = [local_tree(b, _tree.map(lambda _: wm.worker_spec(), b), wm)
                   for b in batches]
    step = make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt, gossip=gossip, mode=mode,
                           mesh=wm, param_specs=specs)
    state = init_state(_tree.map(torch.clone, params), opt)
    reset_launches()
    metrics = []
    for b in batches:
        state, m = step(state, b)
        metrics.append(torch.stack([f.float() for f in m]))
    torch.cuda.synchronize()
    return state.params, torch.stack(metrics), read_launches()


def _s14_close(got, want) -> tuple[bool, float]:
    """(every pair within rtol 1e-5 / atol 1e-6, the largest |difference|)."""
    import torch

    ok, err = True, 0.0
    for a, b in zip(got, want):
        ok = ok and a.shape == b.shape and bool(torch.allclose(a, b, rtol=S14_RTOL,
                                                               atol=S14_ATOL))
        err = max(err, (a - b).abs().max().item())
    return ok, err


def _s14_narrow(wm, archs: dict = S14_ARCHS) -> tuple[dict, dict]:
    """C: each narrow config's two steps on the mesh against the meshless
    steps cut to this rank; the gossip_mix launches of the mesh's steps."""
    from repro_torch import _tree
    from repro_torch.launch.shardings import local_tree, param_pspecs

    out, launches = {}, {}
    for name in archs:
        cfg, params, batches = _s14_narrow_inputs(name, "gossip", archs)
        got, metrics, n = _s14_steps(cfg, params, batches, "gossip", wm)
        launches = {k: launches.get(k, 0) + v for k, v in n.items()}
        want, want_m, _ = _s14_steps(cfg, params, batches, "gossip")
        cut = local_tree(want, param_pspecs(cfg, wm, "gossip"), wm)
        ok, err = _s14_close(_tree.leaves(got) + [metrics], _tree.leaves(cut) + [want_m])
        out[name] = {"ok": ok, "err": err}
    return out, launches


def _s14_rows_cut() -> dict:
    """D: reduced mixtral routed over the whole batch (a router aux
    coefficient of 1) in allreduce mode on a (data=2, model=1) mesh of the
    two processes, each holding half of the rows, against the meshless
    allreduce step over all of them."""
    from repro_torch import _tree
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh

    wm = WorkerMesh.from_mesh(make_host_mesh(data=S13_RANKS, model=1, device="cuda",
                                             backend="gloo"))
    cfg, params, batches = _s14_narrow_inputs("mixtral-8x7b", "allreduce")
    got, metrics, _ = _s14_steps(cfg, params, batches, "allreduce", wm)
    want, want_m, _ = _s14_steps(cfg, params, batches, "allreduce")
    ok, err = _s14_close(_tree.leaves(got) + [metrics], _tree.leaves(want) + [want_m])
    return {"ok": ok, "err": err, "loss": [float(x) for x in metrics[:, 0]]}


def _tp_twin(rank: int, kept, mark) -> dict | None:
    """A trained config's meshless twins, computed by rank 0 while rank 1
    waits (its part freed): the meshless bf16 train() of the same inputs
    (losses, ms/step, peak, its params' distance from the ranks') and the
    step-0 token losses of bf16 and float32 forwards of the same params and
    batch, one worker at a time. ``kept`` is :func:`_tp_train`'s; None on
    rank 1."""
    import torch
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.models import model as Mo
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import train

    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    twin = None
    if rank == 0:
        cfg, params0, batches, whole, tok_tp = kept
        workers = params0["embed"].shape[0]
        torch.cuda.reset_peak_memory_stats()
        state, hist = train(lambda p, b: Mo.loss_fn(p, cfg, b), params0, momentum_sgd(LR, 0.9),
                            iter(batches), steps=S14_STEPS,
                            gossip=GossipSpec(topology=T.undirected_ring(workers),
                                              backend="fused"),
                            log_every=S14_STEPS, device="cuda", verbose=False)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 1e9
        err = max((a.float() - b.to(a.device).float()).abs().max().item()
                  for a, b in zip(_tree.leaves(state.params), whole))
        del state
        mark(f"{cfg.name}: bf16 twin")
        reserved = torch.cuda.max_memory_reserved() / 1e9
        tok_bf16 = _s14_step0(params0, batches[0], cfg)
        tok_f32 = _s14_step0(params0, batches[0], cfg, f32=True)
        mark(f"{cfg.name}: step-0 forwards, bf16 and float32")
        twin = {"loss": hist.loss, "ms": hist.step_time[-1] * 1e3, "peak_gb": peak,
                "reserved_gb": reserved, "err": err,
                "tok_tp": (tok_tp - tok_f32).abs().mean().item(),
                "tok_bf16": (tok_bf16 - tok_f32).abs().mean().item(),
                "loss0": (tok_tp.mean().item(), tok_bf16.mean().item(), tok_f32.mean().item()),
                "finite": all(bool(torch.isfinite(x).all()) for x in whole)
                and bool(torch.isfinite(tok_tp).all())}
        print(f"{cfg.name} meshless bf16: losses {[round(x, 4) for x in hist.loss]}",
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return twin


def _s15_rank(rank: int, tmp: str, wm, mark) -> dict:
    """Slice 15 on one rank of slice 13's (data=1, model=2) mesh; writes
    its numbers to ``tmp/s15-rank{rank}.pt``. A, B: mamba2-2.7b and
    recurrentgemma-2b through :func:`_tp_train` (their sharded saves are
    served below). C: their narrow float32 configs, two steps on the mesh
    against the meshless step. E: serving on the mesh (:func:`_s15_serve`).
    After each A/B config rank 0 computes its twins (:func:`_tp_twin`,
    written to ``tmp/s15-twins.pt``)."""
    import torch

    out, twins = {"train": {}}, {}
    for name, layers, workers, batch, seq in S15_TRAIN:
        out["train"][name], kept = _tp_train(rank, tmp, wm, mark, "s15", name, layers,
                                             workers, batch, seq, keep=True)
        twins[name] = _tp_twin(rank, kept, mark)
        del kept
    out["narrow"], out["narrow_launches"] = _s14_narrow(wm, S15_ARCHS)
    mark("narrow float32 configs")
    out["serve"] = _s15_serve(rank, tmp, wm, mark)
    torch.save(out, os.path.join(tmp, f"s15-rank{rank}.pt"))
    if rank == 0:
        torch.save(twins, os.path.join(tmp, "s15-twins.pt"))


def _s15_config(name: str, layers):
    """A served config: published widths, cut to ``layers`` (None: all)."""
    from repro_torch.configs import get_config

    return get_config(name) if layers is None else family_config(name, layers)


def _s15_path(tmp: str, name: str) -> str:
    trained = name in {n for n, *_ in S15_TRAIN}
    return os.path.join(tmp, f"s15-{name}" if trained else f"s15-serve-{name}", "ck.npz")


def _s15_checkpoint(rank: int, tmp: str, name: str, cfg) -> str:
    """The checkpoint a served config's consensus comes from: a trained
    config's sharded save (:func:`_tp_train`, M = 2), else a consensus of
    seeded weights (seed 0, on the card) that rank 0 saves while rank 1
    waits."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import model as Mo
    from repro_torch.train import checkpoint as ckpt_lib

    path = _s15_path(tmp, name)
    if name in {n for n, *_ in S15_TRAIN}:
        return path
    if rank == 0:
        params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
        ckpt_lib.save(path, params)
        del params
        torch.cuda.empty_cache()
    dist.barrier()
    return path


def _s15_inputs(cfg, rows: int, prompt_len: int):
    """(prompts (rows, prompt_len) numpy, the same on the card, an
    encoder-decoder's bf16 frame embeddings or None), from seeds."""
    import torch

    from repro_torch.data import token_stream

    prompts, _ = token_stream(S=rows, seq_len=prompt_len - 1, vocab=cfg.vocab_size, seed=1)
    enc = None
    if cfg.encoder_layers:
        enc = torch.randn((rows, cfg.encoder_seq, cfg.d_model), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1),
                          dtype=torch.bfloat16)
    return prompts, torch.from_numpy(prompts).cuda(), enc


def _s15_serve(rank: int, tmp: str, wm, mark) -> dict:
    """E: each S15_SERVE config's consensus loaded onto the mesh
    (``load_consensus_params(mesh=)``) and served inside
    ``model_parallel(wm)``: the last prefill position's logits (gathered
    over the vocab's cut), then one WaveBatcher wave (an encoder-decoder:
    ``generate(enc_embeds=)``), its launches counted; granite through
    ``ContinuousBatcher(mesh=)`` on slice 7's trace; after each config,
    rank 0's meshless twins of it (:func:`_s15_twin`, written to
    ``tmp/s15-serve-twins.pt``), then its checkpoint dropped; the narrow
    float32 configs' greedy tokens on the mesh and meshless."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.launch.mesh import model_parallel
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.serving import WaveBatcher, generate, load_consensus_params

    out, twins = {}, {}
    for name, layers, rows, prompt_len, n_new in S15_SERVE:
        cfg = _s15_config(name, layers)
        path = _s15_checkpoint(rank, tmp, name, cfg)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = load_consensus_params(path, cfg, mesh=wm)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        prompts, tok, enc = _s15_inputs(cfg, rows, prompt_len)
        max_len = prompt_len + n_new
        with torch.no_grad(), model_parallel(wm):
            caches = Mo.init_cache(params, cfg, rows, max_len)
            kinds = sorted({type(c).__name__ for c in _layer_caches(caches)})
            del caches
            logits = Mo.prefill(params, cfg, tok, max_len=max_len, enc_embeds=enc)[0][:, -1]
            logits = logits.float().cpu()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            if cfg.encoder_layers:     # a wave carries no frames: generate() serves it
                tokens = generate(params, cfg, prompts, n_new=n_new, enc_embeds=enc).tokens
            else:
                wb = WaveBatcher(params, cfg, rows, max_len)
                rids = [wb.submit(p, n_new) for p in prompts]
                wb.run_wave()
                tokens = np.stack([wb.done[r] for r in rids])
            torch.cuda.synchronize()
            wave_s = time.perf_counter() - t0
            launches = read_launches()
        out[name] = {"logits": logits, "tokens": tokens, "launches": launches,
                     "n_attn": _attention_layers(cfg, prompt_len), "wave_s": wave_s,
                     "load_s": load_s, "caches": kinds,
                     "share": sum(x.numel() for x in _tree.leaves(params))
                     / count_params(Mo.model_defs(cfg)),
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"serve {name} on {wm.describe()}: launches {launches}, caches {kinds}, "
              f"wave {wave_s:.2f} s", flush=True)
        if name == "granite-3-2b":
            out["continuous"] = _s15_continuous(params, cfg, wm)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        mark(f"serve {name}")
        dist.barrier()                 # rank 1 waits off the card's compute
        if rank == 0:
            twins[name] = _s15_twin(cfg, path, rows, prompt_len, n_new)
            mark(f"serve {name}: meshless twins")
        _drop_checkpoint(rank, path)
    out["narrow"] = _s15_narrow_serve(wm)
    mark("narrow float32 serving")
    if rank == 0:
        torch.save(twins, os.path.join(tmp, "s15-serve-twins.pt"))
    return out


def _s15_continuous(params, cfg, wm) -> dict:
    """granite's rank cut through ``ContinuousBatcher(mesh=)``: the first
    S15_CB_REQUESTS requests of slice 7's trace, all queued at once, at
    most S15_CB_MAX_NEW new tokens each."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.serving import ContinuousBatcher

    trace = serving_trace(S15_CB_REQUESTS, max_prompt=CB_MAX_PROMPT, short_new=CB_SHORT_NEW,
                          long_new=CB_LONG_NEW, long_frac=CB_LONG_FRAC, seed=0)
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, cfg.vocab_size, size=r["prompt_len"]).astype(np.int32),
             min(r["n_new"], S15_CB_MAX_NEW)) for r in trace]
    cb = ContinuousBatcher(params, cfg, CB_SLOTS, CB_MAX_LEN, page_size=CB_PAGE,
                           max_new=S15_CB_MAX_NEW, mesh=wm)
    rids = [cb.submit(p, n) for p, n in reqs]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cb.run_until_done()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    stats = cb.stats()
    print(f"continuous on {wm.describe()}: {stats}", flush=True)
    return {"complete": all(len(cb.done.get(r, ())) == n for r, (_, n) in zip(rids, reqs)),
            "tokens": sum(n for _, n in reqs), "s": secs, "stats": stats,
            "launches": read_launches(), "pool": tuple(_tree.leaves(cb.caches)[0].shape)}


def _s15_narrow_serve(wm) -> dict:
    """The narrow float32 configs (a consensus of numpy-seeded weights): the
    greedy tokens of ``generate`` on the rank's cut inside
    ``model_parallel`` and meshless, 2 rows of 12 tokens (an
    encoder-decoder 8 tokens over 16 frames) and 4 new."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import model_parallel
    from repro_torch.launch.shardings import local_tree, param_pspecs
    from repro_torch.models import model as Mo
    from repro_torch.serving import generate

    out = {}
    for name, extra in S15_NARROW_SERVE.items():
        cfg = get_config(name, reduced=True, **{**S14_NARROW, **extra})
        rng = np.random.default_rng(11)
        params = _tree.map(lambda d: torch.from_numpy(
            (0.05 * rng.normal(size=d.shape) + (1.0 if d.init == "ones" else 0.0))
            .astype(np.float32)).cuda(), Mo.model_defs(cfg))
        prompts = rng.integers(0, cfg.vocab_size, size=(2, 12)).astype(np.int32)
        enc = None
        if cfg.encoder_layers:
            enc = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
            prompts = prompts[:, :8]
        want = generate(params, cfg, prompts, n_new=4, enc_embeds=enc)
        local = local_tree(params, param_pspecs(cfg, wm, "allreduce"), wm)
        with model_parallel(wm):
            got = generate(local, cfg, prompts, n_new=4, enc_embeds=enc)
        out[name] = {"equal": bool(np.array_equal(got.tokens, want.tokens)),
                     "lp_err": float(np.abs(got.logprobs - want.logprobs).max())}
    return out


def _s15_twin(cfg, path: str, rows: int, prompt_len: int, n_new: int) -> dict:
    """Rank 0, rank 1 waiting: a served config's meshless bf16 prefill's
    last-position logits (the kernel route) and a float32 forward's of the
    same consensus and prompts (:func:`_f32_forward`, an encoder-decoder's
    memory encoded in float32), and the meshless greedy tokens with each
    step's gap between its two largest logits (for the report: where the
    mesh's tokens first part from them, and whether that step was a
    near-tie), decoded as ``generate`` decodes them."""
    import torch

    from repro_torch.models import model as Mo
    from repro_torch.serving import load_consensus_params

    params = load_consensus_params(path, cfg, device="cuda")
    _, tok, enc = _s15_inputs(cfg, rows, prompt_len)
    with torch.no_grad():
        logits, caches, cross_kvs, memory = Mo.prefill(
            params, cfg, tok, max_len=prompt_len + n_new, enc_embeds=enc)
        logits = logits[:, -1]
        bf16 = logits.float().cpu()
        toks, gaps = [], []
        for t in range(n_new):
            top2 = logits.float().topk(2, dim=-1).values
            gaps.append(top2[:, 0] - top2[:, 1])
            toks.append(torch.argmax(logits, dim=-1))
            if t + 1 < n_new:
                logits, caches = Mo.decode_step(params, cfg, caches, toks[-1][:, None],
                                                memory=memory, cross_kvs=cross_kvs)
                logits = logits[:, -1]
        del caches, cross_kvs, memory
        memory = None if enc is None else _f32_encode(params, cfg, enc)
        f32 = _f32_forward(params, cfg, tok, memory=memory)[0].cpu()
        del memory
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"bf16": bf16, "f32": f32, "tokens": torch.stack(toks, 1).int().cpu().numpy(),
            "gaps": torch.stack(gaps, 1).cpu().numpy()}


def _first_parting(got, want, gaps) -> str:
    """Where each row of greedy tokens ``got`` first differs from ``want``
    (every later token follows another prefix, so it is not counted), the
    meshless top-2 logit gap at that step, and the median gap of all
    steps."""
    import numpy as np

    rows = []
    for r in range(want.shape[0]):
        diff = np.flatnonzero(got[r] != want[r])
        rows.append(f"step {diff[0]} (gap {gaps[r, diff[0]]:.4g})" if diff.size
                    else "none")
    return (f"first differing step per row: {', '.join(rows)}; median gap "
            f"{float(np.median(gaps)):.4g}")


def _gate_slice15(ranks: list, twins: dict, serve_twins: dict) -> dict:
    """Slice 15's gates. A, B: :func:`_gate_tp_train`. C: the narrow
    float32 steps within rtol 1e-5 / atol 1e-6 of meshless. E, per served
    config and rank: one flash_attention launch per attention layer of the
    wave and nothing else; the same tokens on both ranks; the last prefill
    position's bf16 logits within twice the meshless bf16 prefill's mean
    distance from a float32 forward (a bf16 row-parallel sum can flip a
    near-tied argmax, so the bf16 tokens are only reported beside
    meshless'); every continuous request in full, its decode eager over
    the model group; the narrow float32 configs' greedy tokens equal to
    meshless. Returns launches by path."""
    tag = "slice15"
    by_path = _gate_tp_train(tag, [name for name, *_ in S15_TRAIN], ranks, twins)
    for i, r in enumerate(ranks):
        bad = {n: c for n, c in r["narrow"].items() if not c["ok"]}
        if bad or r["narrow_launches"]["gossip_mix"] != 2 * len(S15_ARCHS):
            raise AssertionError(f"{tag} rank {i}: narrow float32 configs off the meshless "
                                 f"step: {bad}; launches {r['narrow_launches']}")
        by_path[f"slice15_narrow_f32_rank{i}"] = r["narrow_launches"]
    log(f"[{tag}] narrow float32 on the (1, 2) mesh vs meshless, max|err| per config: "
        + ", ".join(f"{n} {c['err']:.3g}" for n, c in ranks[0]["narrow"].items())
        + f" (rtol {S14_RTOL} / atol {S14_ATOL}: held)")
    for name, layers, rows, prompt_len, n_new in S15_SERVE:
        twin = serve_twins[name]
        runs = [r["serve"][name] for r in ranks]
        own = (twin["bf16"] - twin["f32"]).abs().mean().item()
        for i, r in enumerate(runs):
            want = {"gossip_mix": 0, "quant_pack": 0, "flash_attention": r["n_attn"],
                    "consensus_stats": 0}
            if r["launches"] != want:
                raise AssertionError(f"{tag} {name} rank {i}: the wave launched "
                                     f"{r['launches']}, want {want}")
            if r["tokens"].shape != (rows, n_new) or not (r["tokens"] == runs[0]["tokens"]).all():
                raise AssertionError(f"{tag} {name} rank {i}: tokens differ between the ranks")
            err = (r["logits"] - twin["f32"]).abs().mean().item()
            finite = bool(r["logits"].isfinite().all())
            if not finite or err > 2 * own:
                raise AssertionError(f"{tag} {name} rank {i}: last-position logits {err:.4g} "
                                     f"from float32 on the mean (meshless bf16 {own:.4g}; "
                                     f"finite {finite}); gate twice")
            by_path[f"slice15_serve_{name}_rank{i}"] = r["launches"]
        err = (runs[0]["logits"] - twin["f32"]).abs().mean().item()
        agree = int((runs[0]["tokens"] == twin["tokens"]).sum())
        moved = (runs[0]["logits"] - twin["bf16"]).abs().max().item()
        log(f"[{tag}] {name} served on the mesh ({runs[0]['share']:.3f} of the params per "
            f"rank; caches {runs[0]['caches']}): last-position logits mean|err| {err:.4g} from "
            f"float32 (meshless bf16 {own:.4g}); gate twice: held; flash_attention "
            f"{runs[0]['n_attn']} per rank per wave; greedy tokens equal to meshless bf16's "
            f"{agree}/{rows * n_new} (not gated), "
            f"{_first_parting(runs[0]['tokens'], twin['tokens'], twin['gaps'])}, the mesh's "
            f"last prefill logits max|diff| {moved:.4g} from meshless bf16's; wave "
            f"{runs[0]['wave_s'] * 1e3:.1f} ms (gloo-staged), load {runs[0]['load_s']:.2f} s, "
            f"peak {runs[0]['peak_gb']:.2f} GB")
    for i, r in enumerate(ranks):
        cb = r["serve"]["continuous"]
        st = cb["stats"]
        if not cb["complete"] or st["decode"] != "eager" or st["eager_decodes"] == 0 or \
                "model factor" not in (st["decode_reason"] or ""):
            raise AssertionError(f"{tag} rank {i}: ContinuousBatcher(mesh=) complete "
                                 f"{cb['complete']}, stats {st}")
        by_path[f"slice15_continuous_rank{i}"] = cb["launches"]
        bad = {n: c for n, c in r["serve"]["narrow"].items() if not c["equal"]}
        if bad:
            raise AssertionError(f"{tag} rank {i}: narrow float32 greedy tokens on the mesh "
                                 f"differ from meshless: {bad}")
    cb = ranks[0]["serve"]["continuous"]
    log(f"[{tag}] granite-3-2b through ContinuousBatcher(mesh=): {S15_CB_REQUESTS} requests "
        f"in full, {cb['tokens']} tokens in {cb['s']:.2f} s ({cb['tokens'] / cb['s']:.1f} "
        f"tokens/s, gloo-staged), decode {cb['stats']['decode']} "
        f"({cb['stats']['eager_decodes']} steps: {cb['stats']['decode_reason']}), pools "
        f"{cb['pool']}")
    log(f"[{tag}] narrow float32 serving on the mesh: greedy tokens equal to meshless for "
        f"{len(ranks[0]['serve']['narrow'])} configs, logprobs max|err| "
        + ", ".join(f"{n} {c['lp_err']:.3g}" for n, c in ranks[0]["serve"]["narrow"].items()))
    return by_path


def _same_checkpoints(got_dir: str, want_dir: str) -> int:
    """The two directories hold the same files, each npz's members equal
    byte for byte (the zip headers carry each write's time) and each meta
    equal. Returns the number of files."""
    import zipfile

    names = sorted(os.listdir(want_dir))
    if sorted(os.listdir(got_dir)) != names:
        raise AssertionError(f"checkpoint files {sorted(os.listdir(got_dir))} vs {names}")
    for name in names:
        pair = [os.path.join(d, name) for d in (got_dir, want_dir)]
        if name.endswith(".npz"):
            content = []
            for f in pair:
                with zipfile.ZipFile(f) as z:
                    content.append([(n, z.read(n)) for n in z.namelist()])
        else:
            content = [open(f, "rb").read() for f in pair]
        if content[0] != content[1]:
            raise AssertionError(f"checkpoint file {name} differs from the meshless run's")
    return len(names)


def _sim_on_worker_mesh(tag: str) -> None:
    """``run_simulated(mesh=WorkerMesh)`` at slice 1's width: the hier
    protocol on ``hier(2, 2)`` for SIM_ROUNDS rounds, the mesh an abstract
    (pod, data) = (2, 2) WorkerMesh mirrored into the engine; each link
    class's bytes must be its messages times the mesh's payload."""
    import torch

    from repro_torch import _tree
    from repro_torch.core import topology as T
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch.mesh import AbstractMesh, WorkerMesh
    from repro_torch.optim import momentum_sgd
    from repro_torch.sim import scenarios
    from repro_torch.train.loop import run_simulated

    fresh_gb("the simulator on a worker mesh", tag)
    params0, batches, loss, _ = _sim_inputs(tag)
    wm = WorkerMesh.from_mesh(AbstractMesh((2, 2), ("pod", "data")))
    t0 = time.perf_counter()
    run = run_simulated(loss, params0, momentum_sgd(LR, 0.9), batches(),
                        gossip=GossipSpec(topology=T.hier(2, 2), backend="einsum"),
                        protocol="hier", mesh=wm, rounds=SIM_ROUNDS, device="cuda",
                        scenario=scenarios.Scenario(name="pods", link_classes=(
                            scenarios.two_class_links(dci_latency=4.0))))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    template = _tree.map(lambda x: torch.empty(x.shape[1:], dtype=x.dtype, device="meta"),
                         params0)
    mirror = wm.sim_spec(params_template=template)
    acct = run.trace.link_accounting()
    bad = {c: a for c, a in acct.items() if a["bytes"] != a["messages"] * mirror.payload_for(c)}
    if bad or not acct.get("dci", {}).get("messages") or not mirror.payload_bytes:
        raise AssertionError(f"{tag} sim: link accounting {acct} against the payload "
                             f"{mirror.payload_bytes}")
    log(f"[{tag} sim] hier protocol on {wm.describe()} (abstract), {SIM_ROUNDS} rounds in "
        f"{wall:.2f} s host: payload {mirror.payload_bytes:,} B per message; "
        + "; ".join(f"{c}: {int(a['messages'])} messages, {int(a['bytes']):,} B"
                    for c, a in sorted(acct.items()))
        + " (bytes = messages x payload)")


def _serve_encdec() -> dict:
    """seamless-m4t-large-v2 at full depth: one generate(enc_embeds=) of
    S10_SERVE's requests (the main path, its launches counted: one
    flash_attention per encoder layer, nothing else), a second one (the
    same greedy tokens), prefill and decode timings, the kernel-vs-blockwise
    prefill check, the decode check over the precomputed cross K/V, a
    profiled prefill and decode step, and the logits product's share of
    the decode step."""
    import numpy as np
    import torch

    from repro_torch import _tree
    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.serving import generate, make_serve_step

    tag = f"slice10 {S10_NAME}"
    fresh_gb(S10_NAME, tag)
    cfg = get_config(S10_NAME)
    B, Lp, n_new = S10_SERVE
    t0 = time.perf_counter()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    enc = torch.randn((B, cfg.encoder_seq, cfg.d_model), device="cuda", dtype=torch.bfloat16,
                      generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    prompts, _ = token_stream(S=B, seq_len=Lp - 1, vocab=cfg.vocab_size, seed=1)
    n_attn = _attention_layers(cfg, Lp)
    log(f"[{tag}] {cfg.encoder_layers} encoder + {cfg.n_layers} decoder layers, d_model="
        f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} {cfg.mlp_type} "
        f"d_ff={cfg.d_ff} vocab={cfg.vocab_size} {cfg.param_dtype}: "
        f"{count_params(Mo.model_defs(cfg)):,} params, initialised on the card in {init_s:.1f} "
        f"s (peak {init_gb:.2f} GB); {B} requests of {cfg.encoder_seq} frames + {Lp} prompt "
        f"+ {n_new} new tokens")

    # the user's path: generate → prefill (encoder through the kernel,
    # cross K/V precomputed) → decode steps over the caches and cross K/V
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = generate(params, cfg, prompts, n_new=n_new, enc_embeds=enc)
    wave_s = time.perf_counter() - t0        # generate() ends in a host transfer
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"gossip_mix": 0, "quant_pack": 0, "flash_attention": n_attn,
                    "consensus_stats": 0}:
        raise AssertionError(f"{S10_NAME}'s generate launched {launches}, want one "
                             f"flash_attention per encoder layer ({n_attn}) and nothing else")
    if res.tokens.shape != (B, n_new) or not np.isfinite(res.logprobs).all():
        raise AssertionError(f"{S10_NAME}: tokens {res.tokens.shape}, finite logprobs "
                             f"{np.isfinite(res.logprobs).all()}")
    log(f"[{tag}] generate: {wave_s * 1e3:.1f} ms, {B * n_new / wave_s:,.1f} generated tokens/s "
        f"end to end, flash_attention launches {launches['flash_attention']} (one per encoder "
        f"layer, non-causal), logprobs finite (mean {res.logprobs.mean():.4f}), peak memory "
        f"{peak_gb:.2f} GB")

    tok = torch.from_numpy(prompts).cuda()
    with torch.no_grad():
        t0 = time.perf_counter()
        again = generate(params, cfg, prompts, n_new=n_new, enc_embeds=enc)
        again_s = time.perf_counter() - t0
        if not np.array_equal(again.tokens, res.tokens):
            raise AssertionError(f"{S10_NAME}: a second generate() gave other greedy tokens")
        prefill_s = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, caches, cross_kvs, memory = Mo.prefill(params, cfg, tok, max_len=Lp + n_new,
                                                           enc_embeds=enc)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
        pf = sum(prefill_s) / len(prefill_s)
        step_s = sum((r - pf) / (n_new - 1) for r in (wave_s, again_s)) / 2
        ckv_gb = sum(t.numel() * t.element_size() for t in _tree.leaves(cross_kvs)) / 1e9
        log(f"[{tag}] a second generate(): the same greedy tokens, {again_s * 1e3:.1f} ms; "
            f"prefill {[round(x * 1e3, 2) for x in prefill_s]} ms, mean {pf * 1e3:.2f} ms = "
            f"time to first token; decode {step_s * 1e3:.2f} ms/step ((run - prefill) / "
            f"{n_new - 1} over both runs); cross K/V {ckv_gb:.3f} GB")

        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
        serve_step = make_serve_step(cfg)
        rows = profile_call("one decode step", lambda: serve_step(params, caches, nxt, memory,
                                                                  cross_kvs))
        _logits_share(params, cfg, B, sum(r[1] for r in rows), tag)
        del caches, cross_kvs, memory, logits
        check_prefill(params, cfg, tok, Lp + n_new, tag, enc=enc)
        _check_encdec_decode(params, cfg, tok, enc, tag)
        profile_flash_route(f"{S10_NAME} prefill",
                            lambda: Mo.prefill(params, cfg, tok, max_len=Lp + n_new,
                                               enc_embeds=enc), n_attn, tag)
    del params, enc
    return launches


def _logits_share(params, cfg, B: int, step_ms: float, tag: str) -> None:
    """The logits product of one decode step (B rows against the (D, V)
    head) timed alone, against its byte bound and the same product over a
    16-byte-aligned copy of the head (row stride padded to a multiple of 8
    bf16 values, the same V columns): how much of a decode step's device
    time the unaligned vocab costs."""
    import torch

    from repro_torch.launch.roofline import memory_rate

    from repro_torch.models import model as Mo
    from repro_torch.models.attention import f32_product

    W = Mo._unembed(params, cfg)
    h = torch.randn((B, 1, cfg.d_model), device="cuda", dtype=W.dtype,
                    generator=torch.Generator(device="cuda").manual_seed(2))
    ms = time_cuda(lambda: Mo.logits_from_hidden(params, cfg, h), 20)
    V = W.shape[1]
    padded = W.new_empty((W.shape[0], -(-V // 8) * 8))
    padded[:, :V] = W
    aligned = padded[:, :V]
    aligned_ms = time_cuda(lambda: f32_product("bld,dv->blv", h, aligned), 20)
    del padded, aligned
    bound_ms = W.numel() * W.element_size() / memory_rate(torch.cuda.get_device_name(0)) * 1e3
    share = f"{100 * ms / step_ms:.1f}%" if step_ms else "not measured"
    log(f"[{tag}] logits product ({B} x {cfg.d_model} by {cfg.d_model} x {V}, row stride "
        f"{W.stride(0) * W.element_size()} bytes): {ms:.3f} ms, {share} of a decode step's "
        f"{step_ms:.2f} ms device time; bound {bound_ms:.3f} ms (bytes); over a 16-byte-aligned "
        f"copy of the head {aligned_ms:.3f} ms")


def _check_encdec_decode(params, cfg, tok, enc, tag) -> None:
    """prefill of the prompt and one decode step over the caches and the
    precomputed cross K/V (dense attention), against an uncached forward of
    the prompt and that token over the same memory (cross-attention
    projecting the memory, blockwise over its frames), both bf16.
    Tolerance: twice the forward's distance from a float32 forward of the
    same tokens over the same memory, plus 1e-5."""
    import torch

    from repro_torch.models import model as Mo

    B, Lp = tok.shape
    logits, caches, cross_kvs, memory = Mo.prefill(params, cfg, tok, max_len=Lp + 1,
                                                   enc_embeds=enc)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None]
    got = Mo.decode_step(params, cfg, caches, nxt, memory=memory, cross_kvs=cross_kvs)[0][:, -1]
    del caches, cross_kvs
    ext = torch.cat([tok, nxt.to(tok.dtype)], dim=1)
    h, _ = Mo.forward(params, cfg, ext, memory=memory)
    want = Mo.logits_from_hidden(params, cfg, h[:, -1:])[:, -1]
    exact = _f32_forward(params, cfg, ext, memory=memory)[0]
    e_gw = (got - want).abs().max().item()
    e_wf = (want - exact).abs().max().item()
    tol = 2 * e_wf + 1e-5
    log(f"[{tag}] {Lp}-token prefill + 1 decode step over the cross K/V vs an uncached "
        f"forward of {Lp + 1} tokens over the same memory: max|err| {e_gw:.4g} (tol {tol:.4g}); "
        f"vs float32: decode {(got - exact).abs().max().item():.4g}, forward {e_wf:.4g}; argmax "
        f"agree {int((got.argmax(-1) == want.argmax(-1)).sum())}/{B}")
    if not bool(torch.isfinite(got).all()) or e_gw > tol:
        raise AssertionError(f"{tag}: decode over the cross K/V off the uncached forward: "
                             f"{e_gw} > {tol}")


def _attention_layers(cfg, prompt_len: int) -> int:
    """Layers whose prefill takes the flash kernel: the decoder's attention
    kinds for a prompt past the dense threshold, and an encoder's layers
    over more frames than it."""
    from repro_torch.models.attention import BLOCK_THRESHOLD

    n = 0
    if prompt_len > BLOCK_THRESHOLD:
        n += sum(kind in ("attn", "local") for kind in cfg.layer_kinds)
    if cfg.encoder_seq > BLOCK_THRESHOLD:
        n += cfg.encoder_layers
    return n


def _serve_wave(slice_tag, name, layers, slots, prompt_len, n_new) -> dict:
    """One WaveBatcher wave of ``slots`` requests (the main path, its
    launches counted: one flash_attention per attention layer, nothing
    else), then generate() of the same wave (same tokens, finite logprobs),
    the serving-vs-training-route prefill check, a profiled prefill (the
    wgmma kernel once per attention layer, no float32 one), and for a
    windowed config the ring cache against a full-length cache, for a
    Mamba-2 config its recurrent decode against a re-prefill."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import token_stream
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.serving import WaveBatcher, generate

    tag = f"{slice_tag} {name}"
    fresh_gb(f"{name}", tag)
    cfg = get_config(name) if layers is None else get_config(name, n_layers=layers)
    t0 = time.perf_counter()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_gb = torch.cuda.max_memory_allocated() / 1e9
    prompts, _ = token_stream(S=slots, seq_len=prompt_len - 1, vocab=cfg.vocab_size, seed=1)
    n_attn = _attention_layers(cfg, prompt_len)
    kinds = ", ".join(f"{k} x{cfg.layer_kinds.count(k)}" for k in dict.fromkeys(cfg.layer_kinds))
    log(f"[{tag}] layers {cfg.n_layers} of {get_config(name).n_layers} ({kinds}), d_model="
        f"{cfg.d_model} heads={cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} {cfg.attention_type} "
        f"{cfg.mlp_type} d_ff={cfg.d_ff} experts={cfg.n_experts} window={cfg.window} vocab="
        f"{cfg.vocab_size} {cfg.param_dtype}: {count_params(Mo.model_defs(cfg)):,} params, "
        f"initialised on the card in {init_s:.1f} s (peak {init_gb:.2f} GB); a wave of {slots} "
        f"x {prompt_len} prompt + {n_new} new tokens")

    wb = WaveBatcher(params, cfg, slots, prompt_len + n_new)
    rids = [wb.submit(p, n_new) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    wb.run_wave()
    wave_s = time.perf_counter() - t0
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches != {"gossip_mix": 0, "quant_pack": 0, "flash_attention": n_attn,
                    "consensus_stats": 0}:
        raise AssertionError(f"{name}'s wave launched {launches}, want one flash_attention "
                             f"per attention layer ({n_attn}) and nothing else")
    if sorted(wb.done) != rids or any(len(wb.done[r]) != n_new for r in rids):
        raise AssertionError(f"{name}: WaveBatcher did not serve every request in full")
    log(f"[{tag}] wave: {wave_s * 1e3:.1f} ms, {slots * n_new / wave_s:,.1f} generated tokens/s "
        f"end to end, flash_attention launches {launches['flash_attention']} (one per attention "
        f"layer), peak memory {peak_gb:.2f} GB")

    tok = torch.from_numpy(prompts).cuda()
    with torch.no_grad():
        res = generate(params, cfg, prompts, n_new=n_new)
        if not np.isfinite(res.logprobs).all():
            raise AssertionError(f"{name}: non-finite logprobs")
        if not all(np.array_equal(res.tokens[i], wb.done[r]) for i, r in enumerate(rids)):
            raise AssertionError(f"{name}: generate() and WaveBatcher disagree")
        log(f"[{tag}] the wave again through generate(): the same tokens, logprobs finite "
            f"(mean {res.logprobs.mean():.4f})")
        check_prefill(params, cfg, tok, prompt_len + n_new, tag)
        if cfg.n_experts:
            count_route_flips(params, cfg, tok, prompt_len + n_new, tag)
        profile_flash_route(f"{name} prefill wave",
                            lambda: Mo.prefill(params, cfg, tok, max_len=prompt_len + n_new),
                            n_attn, tag)
        fed = torch.from_numpy(res.tokens[:, :CHECK_STEPS]).cuda()
        if cfg.window:
            _check_ring(params, cfg, tok, fed, tag)
        if "ssm" in cfg.layer_kinds:
            _check_recurrent_decode(params, cfg, tok, fed, tag)
    del params, wb, res
    return launches


def _f32_caches(cfg, batch: int, max_len: int, device) -> list:
    """One empty float32 cache per layer, in layer order, for _f32_forward:
    full-length KV caches (a windowed layer masks instead of a ring), the
    recurrent kinds' own caches."""
    import dataclasses

    import torch

    from repro_torch.models import model as Mo

    full = dataclasses.replace(cfg, window=None)
    return [Mo._layer_cache(full, kind, batch, max_len, torch.float32, torch.device(device))
            for kind in cfg.layer_kinds]


def _f32_forward(params, cfg, tok, caches=None, memory=None):
    """(float32 logits of the last position, new per-layer caches or None):
    the bf16 weights run in float32, each layer's weights upcast only while
    it runs, the vocab in chunks (a float32 copy of nemotron's or mixtral's
    cut model would not fit beside the bf16 one). ``caches``: one float32
    cache per layer, in layer order (:func:`_f32_caches`); ``memory``: an
    encoder-decoder's encoder output, which cross-attention projects
    (in float32)."""
    import dataclasses

    import torch

    from repro_torch import _tree
    from repro_torch.models import attention as A
    from repro_torch.models import layers as Ly
    from repro_torch.models import model as Mo

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    x = Mo._embed(params, cfg32, tok)
    new, i = [], 0
    for seg, sp in zip(Mo.plan_segments(cfg), params["segments"]):
        for li in range(seg.length):
            layer = _tree.map(lambda a: a[li], sp) if seg.scanned else sp[li]
            bp = _tree.map(lambda a: a.float(), layer)
            x, c, _ = Mo._block_apply(bp, cfg32, seg, x, caches[i] if caches else None,
                                      memory=None if memory is None else memory.float())
            new.append(c)
            i += 1
            del bp
    h = Ly.rmsnorm_apply({"scale": params["out_norm"]["scale"].float()}, x[:, -1:],
                         cfg.norm_eps)
    W = Mo._unembed(params, cfg)
    logits = torch.cat([A.f32_product("bld,dv->blv", h, W[:, j:j + 32768].float())
                        for j in range(0, W.shape[1], 32768)], dim=-1)
    return logits[:, -1], (new if caches else None)


def _f32_encode(params, cfg, enc):
    """The encoder's memory in float32 from the bf16 weights, each layer
    upcast only while it runs (attention blockwise, as the training route)."""
    import dataclasses

    from repro_torch import _tree
    from repro_torch.models import layers as Ly
    from repro_torch.models import model as Mo

    cfg32 = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32")
    layers = params["encoder"]["layers"]
    x = enc.float()
    for li in range(cfg.encoder_layers):
        layer = layers[li] if isinstance(layers, list) else _tree.map(lambda a: a[li], layers)
        x = Mo._encoder_block_apply(_tree.map(lambda a: a.float(), layer), cfg32, x)
    return Ly.rmsnorm_apply({"scale": params["encoder"]["out_norm"]["scale"].float()}, x,
                            cfg.norm_eps)


def _layer_caches(caches) -> list:
    """The per-layer caches of a segment list, a scanned segment's stacked
    cache counted once."""
    return [c for seg in caches for c in (seg if isinstance(seg, list) else [seg])]


def _check_ring(params, cfg, tok, fed, tag) -> None:
    """A windowed model's prompt (longer than the window: the ring wraps in
    the prefill) and ``fed``'s decode steps (wrapping it again) through the
    ring cache, against the same steps through a full-length cache with the
    window mask (the reference's non-ring branch), both bf16. Tolerance:
    twice the full route's distance from a float32 run of the same steps,
    plus 1e-5."""
    import dataclasses

    import torch

    from repro_torch.models import attention as A
    from repro_torch.models import model as Mo

    B, Lp = tok.shape
    steps = fed.shape[1]
    max_len = Lp + steps
    logits, ring, *_ = Mo.prefill(params, cfg, tok, max_len=max_len)
    kv = [c for c in _layer_caches(ring) if isinstance(c, A.KVCache)]
    if not kv or kv[0].k.shape[-3] != cfg.window or Lp < cfg.window:   # k: ..., S, Kh, hd
        raise AssertionError(f"{tag}: the check wants a ring cache that wraps in the prefill")
    for t in range(steps):
        logits, ring = Mo.decode_step(params, cfg, ring, fed[:, t:t + 1])
    got = logits[:, -1]
    del ring, kv
    full = Mo.init_cache(params, dataclasses.replace(cfg, window=None), B, max_len)
    h, full = Mo.forward(params, cfg, tok, caches=full)
    for t in range(steps):
        logits, full = Mo.decode_step(params, cfg, full, fed[:, t:t + 1])
    want = logits[:, -1]
    del full, h
    c32 = _f32_caches(cfg, B, max_len, tok.device)
    exact, c32 = _f32_forward(params, cfg, tok, c32)
    for t in range(steps):
        exact, c32 = _f32_forward(params, cfg, fed[:, t:t + 1], c32)
    del c32
    e_rf = (got - want).abs().max().item()
    e_ff = (want - exact).abs().max().item()
    tol = 2 * e_ff + 1e-5
    log(f"[{tag}] {Lp}-token prompt (window {cfg.window}) + {steps} decode steps: ring cache "
        f"({cfg.window} slots) vs full-length cache max|err| {e_rf:.4g} (tol {tol:.4g}); vs "
        f"float32: ring {(got - exact).abs().max().item():.4g}, full {e_ff:.4g}")
    if not bool(torch.isfinite(got).all()) or e_rf > tol:
        raise AssertionError(f"{tag}: ring decode off the full-length cache: {e_rf} > {tol}")


def _check_recurrent_decode(params, cfg, tok, fed, tag) -> None:
    """Mamba-2's O(1) recurrent decode against its chunked form: the prompt
    prefilled and ``fed``'s tokens decoded one at a time through the SSM
    state, against one prefill of the prompt extended by the same tokens,
    both bf16. Tolerance: twice the re-prefill's distance from a float32
    forward of the extended sequence, plus 1e-5."""
    import torch

    from repro_torch.models import model as Mo

    B, Lp = tok.shape
    steps = fed.shape[1]
    logits, caches, *_ = Mo.prefill(params, cfg, tok, max_len=Lp + steps)
    for t in range(steps):
        logits, caches = Mo.decode_step(params, cfg, caches, fed[:, t:t + 1])
    got = logits[:, -1]
    del caches
    ext = torch.cat([tok, fed.to(tok.dtype)], dim=1)
    want = Mo.prefill(params, cfg, ext, max_len=Lp + steps)[0][:, -1]
    exact = _f32_forward(params, cfg, ext)[0]
    e_rw = (got - want).abs().max().item()
    e_wf = (want - exact).abs().max().item()
    tol = 2 * e_wf + 1e-5
    log(f"[{tag}] {Lp}-token prompt + {steps} recurrent decode steps vs one prefill of the "
        f"{Lp + steps} tokens (chunked): max|err| {e_rw:.4g} (tol {tol:.4g}); vs float32: "
        f"recurrent {(got - exact).abs().max().item():.4g}, re-prefill {e_wf:.4g}; argmax agree "
        f"{int((got.argmax(-1) == want.argmax(-1)).sum())}/{B}")
    if not bool(torch.isfinite(got).all()) or e_rw > tol:
        raise AssertionError(f"{tag}: recurrent decode off the re-prefill: {e_rw} > {tol}")


def _continuous_family(slice_tag, name, paged_check: bool = False) -> dict:
    """``name`` at its published widths and full depth through
    ContinuousBatcher: the paged path and its CUDA graph. Gates: every
    request in full, one graph replay per decode, bucket_misses == 0, graph
    step = eager step bit for bit; with ``paged_check``, paged against dense
    next logits as slice 7 holds them."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import ContinuousBatcher
    from repro_torch.serving.batcher import default_buckets

    tag = f"{slice_tag} continuous"
    fresh_gb(f"{name} continuous", tag)
    cfg = get_config(name)
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in rng.integers(20, S8_CB_BUCKET + 1, size=S8_CB_REQUESTS)]
    n_news = [int(n) for n in rng.choice([16, 48], size=S8_CB_REQUESTS)]
    buckets = default_buckets(S8_CB_PAGE, S8_CB_BUCKET)
    cb = ContinuousBatcher(params, cfg, S8_CB_SLOTS, S8_CB_MAX_LEN, page_size=S8_CB_PAGE,
                           max_new=max(n_news), buckets=buckets)
    cb.warmup()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    rids = [cb.submit(p, n) for p, n in zip(prompts, n_news)]
    cb.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = cb.stats()
    steps = len(cb._occupancy)
    if sorted(cb.done) != rids or any(len(cb.done[r]) != n for r, n in zip(rids, n_news)):
        raise AssertionError(f"{name} ContinuousBatcher did not serve every request in full")
    if (stats["bucket_misses"], stats["decode"]) != (0, "cuda graph") or \
            (stats["decode_replays"], stats["eager_decodes"]) != (steps, 0):
        raise AssertionError(f"{name} ContinuousBatcher after the pass ({steps} decodes): {stats}")
    if any(launches.values()):
        raise AssertionError(f"{name} continuous serving launched {launches}")
    if not all(np.isfinite(cb.done_logprobs[r]).all() for r in rids):
        raise AssertionError(f"{name} continuous: non-finite logprobs")
    log(f"[{tag}] {name}, {S8_CB_SLOTS} slots, max_len {S8_CB_MAX_LEN}, buckets {buckets}: "
        f"{S8_CB_REQUESTS} requests ({sum(n_news)} tokens) in {wall:.3f} s, {steps} decode "
        f"steps, {stats['decode_replays']} graph replays, {stats['eager_decodes']} eager, "
        f"bucket misses {stats['bucket_misses']}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    with torch.no_grad():
        if paged_check:
            # decode timings on the emptied state (the shapes are the pool's)
            graph_ms = time_cuda(cb._decode, 20)
            eager_ms = time_cuda(lambda: cb.decode_eager(*cb.state()), 5, warmup=1)
            log(f"[{tag}] decode step ({S8_CB_SLOTS} slots): CUDA graph replay {graph_ms:.3f} "
                f"ms, the same step eagerly {eager_ms:.3f} ms")
            profile_call(f"{name} one graph decode step", cb._decode)
            check_paged_vs_dense(params, cfg, cb, prompts[0])
        check_graph_vs_eager(cb, prompts[:S8_CB_SLOTS])
    del cb, params
    return launches


def family_config(name, layers, **overrides):
    """The config at its published widths cut to ``layers`` layers (an
    encoder-decoder's encoder too), or reduced in bf16 (``layers`` None)."""
    import dataclasses

    from repro_torch.configs import get_config

    if layers is None:
        return get_config(name, reduced=True, param_dtype="bfloat16", compute_dtype="bfloat16",
                          **overrides)
    pattern = get_config(name).layer_pattern
    if pattern is not None:
        overrides.setdefault("layer_pattern", pattern[:layers])
    cfg = get_config(name, n_layers=layers, **overrides)
    if cfg.encoder_layers:
        cfg = dataclasses.replace(cfg, encoder_layers=layers)
    return cfg


def family_setup(cfg, workers, batch_size, seq_len):
    """(worker-stacked params, next_batch, loss) of a training run: weights
    drawn on the card from seed 0, the token stream and worker batches of
    seed 0 (slice 1's at its shape), an encoder-decoder's batches with
    seeded random frame embeddings beside the tokens."""
    import torch

    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split, token_stream
    from repro_torch.models import model as Mo

    params0 = replicate_for_workers(
        Mo.init(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda"), workers)
    toks, _ = token_stream(S=workers * batch_size * 8, seq_len=seq_len,
                           vocab=cfg.vocab_size, seed=0)
    batcher = WorkerBatcher((toks,), pad_to_equal(random_split(len(toks), workers)),
                            batch_size=batch_size, seed=0)
    frames = torch.Generator(device="cuda").manual_seed(1)

    def next_batch():
        b = {"tokens": batcher.next()[0]}
        if cfg.encoder_layers:
            b["enc_embeds"] = torch.randn((workers, batch_size, cfg.encoder_seq, cfg.d_model),
                                          generator=frames, device="cuda",
                                          dtype=torch.bfloat16)
        return b

    return params0, next_batch, (lambda p, b: Mo.loss_fn(p, cfg, b))


def _train_family(slice_tag, name, layers, batch_size, seq_len, workers=M_WORKERS,
                  topology="ring") -> dict:
    """Five train() steps in bf16 on ``topology`` over ``workers`` (fused
    bus) of the config at its published widths cut to ``layers`` layers (an
    encoder-decoder's encoder too), or reduced (``layers`` None): finite
    losses, one gossip_mix launch per step, and a fused step against an
    einsum step within the bf16 tolerance. An encoder-decoder's batches
    carry seeded random frame embeddings beside the tokens."""
    import torch

    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.models import model as Mo
    from repro_torch.models.params import count_params
    from repro_torch.optim import momentum_sgd
    from repro_torch.train import train

    tag = f"{slice_tag} train {name}"
    fresh_gb(f"{name} training", tag)
    cfg = family_config(name, layers)
    params0, next_batch, loss = family_setup(cfg, workers, batch_size, seq_len)

    def batches():
        while True:
            yield next_batch()

    opt = momentum_sgd(LR, 0.9)
    topo = T.make(topology, workers)
    spec = GossipSpec(topology=topo, backend="fused")
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    state, hist = train(loss, params0, opt, batches(), steps=STEPS, gossip=spec,
                        log_every=STEPS, device="cuda", verbose=False)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = read_launches()
    if not all(math.isfinite(x) for x in hist.loss):
        raise AssertionError(f"{tag}: non-finite loss {hist.loss}")
    if launches != {"gossip_mix": STEPS, "quant_pack": 0, "flash_attention": 0,
                    "consensus_stats": stats_launches(state.params, STEPS)}:
        raise AssertionError(f"{tag}: {launches} in {STEPS} steps, want 1 gossip_mix per step")
    batch = to_device(next_batch(), "cuda")
    s_f, m_f = make_train_step(loss, opt, gossip=spec)(state, batch)
    s_e, m_e = make_train_step(loss, opt, gossip=GossipSpec(topology=topo,
                                                            backend="einsum"))(state, batch)
    err, finite = _params_err(s_f.params, s_e.params)
    if not finite or err > TOL["bfloat16"]:
        raise AssertionError(f"{tag}: fused step vs einsum step max|err| {err}, finite {finite}")
    frames_note = (f" and {batch_size} x {cfg.encoder_seq} frames" if cfg.encoder_layers
                   else "")
    log(f"[{tag}] {cfg.name} (d_model {cfg.d_model}, {cfg.n_layers} layers, {cfg.encoder_layers} "
        f"encoder layers, experts {cfg.n_experts}, window {cfg.window}; "
        f"{count_params(Mo.model_defs(cfg)):,} params per worker) bf16, M={workers} "
        f"{topo.name}, {batch_size} x {seq_len} tokens{frames_note} per worker, fused "
        f"bus: {STEPS} steps in {train_s:.2f} s, losses {[round(x, 4) for x in hist.loss]}, "
        f"gossip_mix launches {launches['gossip_mix']} in {STEPS} steps; fused vs einsum step "
        f"params max|err| {err:.3g} (tol {TOL['bfloat16']}), losses {m_f.loss.item():.4f} / "
        f"{m_e.loss.item():.4f}; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del state, s_f, s_e, params0
    return launches


def check_paged_vs_dense(params, cfg, cb, prompt) -> None:
    """One request admitted alone and stepped 4 times; its next logits from
    the paged caches against the dense-cache route (prefill + decode_step of
    the same tokens), both bf16. Tolerance as check_prefill: twice the dense
    route's distance from a float32 forward of the same weights, plus 1e-5."""
    import torch

    from repro_torch import _tree
    from repro_torch.models import model as Mo

    rid = cb.submit(prompt, 16)
    for _ in range(4):
        cb.step()
    slot = next(s for s, f in enumerate(cb.slots) if f is not None and f.rid == rid)
    caches = _tree.map(torch.clone, cb.caches)
    paged = Mo.decode_step(params, cfg, caches, cb.cur[:, None].clone())[0][slot, -1]
    del caches
    fed = cb.out_toks[slot, :5].clone()   # the first token, then the 4 steps' tokens
    tok = torch.from_numpy(prompt[None]).cuda()

    def dense_route(p, c):
        logits, caches, *_ = Mo.prefill(p, c, tok, max_len=len(prompt) + 8)
        for t in range(5):
            logits, caches = Mo.decode_step(p, c, caches, fed[None, t:t + 1])
        return logits[0, -1]

    dense = dense_route(params, cfg)
    # the same route in float32, each layer upcast only while it runs (a
    # float32 copy of deepseek-v2-lite would not fit beside its bf16 weights)
    c32 = _f32_caches(cfg, 1, len(prompt) + 8, tok.device)
    exact, c32 = _f32_forward(params, cfg, tok, c32)
    for t in range(5):
        exact, c32 = _f32_forward(params, cfg, fed[None, t:t + 1], c32)
    exact = exact[0]
    del c32
    e_pd = (paged - dense).abs().max().item()
    e_df = (dense - exact).abs().max().item()
    tol = 2 * e_df + 1e-5
    log(f"[continuous] paged vs dense decode ({len(prompt)}-token prompt, 4 steps, |logit| ≤ "
        f"{exact.abs().max().item():.3f}): max|err| {e_pd:.4g} (tol {tol:.4g}); vs float32: "
        f"paged {(paged - exact).abs().max().item():.4g}, dense {e_df:.4g}; argmax "
        f"{'agrees' if int(paged.argmax()) == int(dense.argmax()) else 'differs'}")
    if not bool(torch.isfinite(paged).all()) or e_pd > tol:
        raise AssertionError(f"paged decode off the dense route: {e_pd} > {tol}")
    cb.run_until_done()


def check_graph_vs_eager(cb, prompts) -> None:
    """Fill every slot, then one decode step through the graph against the
    same step run eagerly on a copy of the state: equal bit for bit (the
    pools' dump page, garbage by design, left out)."""
    import torch

    from repro_torch import _tree

    for p in prompts:
        cb.submit(p, 8)
    cb.step()                                     # admits them, one decode
    active = sum(f is not None for f in cb.slots)
    twin = _tree.map(torch.clone, cb.state())
    cb.step()                                     # the graph
    cb.decode_eager(*twin)
    torch.cuda.synchronize()
    keep = torch.tensor([i for i in range(cb.pool.n_pages) if i != cb.pool.dump],
                        device=cb.cur.device)

    def pairs():
        """(graph, eager) state tensors; each paged cache's two pools without
        the dump page (its pages dim: 1 when stacked on a layer dim, else 0)."""
        for seg_g, seg_e in zip(cb.caches, twin[0]):
            stacked = not isinstance(seg_g, list)
            for g, e in (zip([seg_g], [seg_e]) if stacked else zip(seg_g, seg_e)):
                for i, (a, b) in enumerate(zip(g, e)):
                    if i < 2:
                        a, b = (t.index_select(int(stacked), keep) for t in (a, b))
                    yield a, b
        yield from zip(cb.state()[1:], twin[1:])

    n = 0
    for got, want in pairs():
        if not torch.equal(got, want):
            raise AssertionError(f"graph and eager decode differ in a state tensor of shape "
                                 f"{tuple(got.shape)}")
        n += got.numel()
    log(f"[continuous] one graph decode step with {active} active slots equals the eager step "
        f"bit for bit ({n:,} state elements, the dump page left out)")
    cb.run_until_done()


def check_prefill(params, cfg, tok, max_len: int, tag: str, enc=None) -> None:
    """The wave's last-position prefill logits through the kernel (the
    serving route) against the same prefill through the training path's
    blockwise_attention, both bf16 on the card. Tolerance: twice the
    blockwise route's own distance from a float32 forward of the same
    weights (plus 1e-5 for float32 sums in another order). The two bf16
    routes round differently only inside attention, so a kernel as accurate
    as the blockwise route stays within it; a wrong kernel (mask, GQA head,
    tile edge) moves the logits by far more. An encoder-decoder (``enc``,
    its frame embeddings) takes the kernel in its encoder: the blockwise
    route encodes through blockwise_attention and runs the same decoder
    over that memory's cross K/V; the float32 forward encodes in float32."""
    import torch

    from repro_torch.models import model as Mo

    kernel = Mo.prefill(params, cfg, tok, max_len=max_len, enc_embeds=enc)[0][:, -1]
    before = read_launches()["flash_attention"]
    memory = cross_kvs = None
    if enc is not None:
        memory = Mo.encode(params, cfg, enc)
        cross_kvs = Mo.precompute_cross_kv(params, cfg, memory)
    h, _ = Mo.forward(params, cfg, tok, memory=memory, cross_kvs=cross_kvs)
    if read_launches()["flash_attention"] != before:
        raise AssertionError("the training path launched flash_attention")
    block = Mo.logits_from_hidden(params, cfg, h[:, -1:])[:, -1]
    del h, memory, cross_kvs
    exact = _f32_forward(params, cfg, tok,
                         memory=None if enc is None else _f32_encode(params, cfg, enc))[0]
    e_kb = (kernel - block).abs().max().item()
    e_bf = (block - exact).abs().max().item()
    e_kf = (kernel - exact).abs().max().item()
    finite = bool(torch.isfinite(kernel).all())
    tol = 2 * e_bf + 1e-5
    log(f"[{tag}] last-position prefill logits (|logit| ≤ {exact.abs().max().item():.3f}): "
        f"serving route (the kernel) vs training route (blockwise) max|err| {e_kb:.4g} (tol "
        f"{tol:.4g}); vs float32: serving {e_kf:.4g}, training {e_bf:.4g}; argmax agree "
        f"{int((kernel.argmax(-1) == block.argmax(-1)).sum())}/{kernel.shape[0]}")
    if not finite or e_kb > tol:
        raise AssertionError(f"{tag}: prefill through the kernel off the blockwise route: "
                             f"{e_kb} > {tol} (finite {finite})")


def count_route_flips(params, cfg, tok, max_len: int, tag: str) -> None:
    """Not gated: per MoE layer, the tokens whose top-k expert set differs
    between the serving route's prefill (the kernel) and the training
    route's forward (blockwise). Both are bf16, so a router near-tie can
    flip on the last bits of the attention output; a flipped token moves
    the logits by more than rounding does."""
    from repro_torch.models import layers as Ly
    from repro_torch.models import model as Mo

    real = Ly._route_logits
    runs = []
    for fn in (lambda: Mo.prefill(params, cfg, tok, max_len=max_len),
               lambda: Mo.forward(params, cfg, tok)):
        picks = []

        def recording(c, logits, rows=None, picks=picks):
            out = real(c, logits, rows)
            picks.append(out[1].sort(-1).values)      # the top-k set of each token
            return out

        Ly._route_logits = recording
        try:
            fn()
        finally:
            Ly._route_logits = real
        runs.append(picks)
    flips = [int((a != b).any(-1).sum()) for a, b in zip(*runs)]
    log(f"[{tag}] router top-{cfg.top_k} sets, kernel vs blockwise route, tokens that differ "
        f"per MoE layer ({tok.numel()} tokens each): {flips} (total {sum(flips)}; not gated)")


def profile_flash_route(label: str, fn, n_layers: int, tag: str = "serve") -> None:
    """Profile ``fn`` (after one traced warm-up call) and hold its flash
    route to :func:`check_flash_route`, in up to PROFILE_SESSIONS sessions:
    late in a run the profiler can lose launches from a window while the
    launch counters hold (17 of 18, 23 of 24 wgmma launches seen), so a
    profile that shows fewer wgmma launches than layers, and nothing else
    of the flash kernels, is taken again. A float32 launch or more launches
    than layers fail at once."""
    for attempt in range(1, PROFILE_SESSIONS + 1):
        rows = profile_call(label, fn, warmup=1)
        flash = [(name, count) for name, _, count in rows if "flash_attention_fwd" in name]
        seen = sum(count for _, count in flash)
        if not rows or seen >= n_layers or any("wgmma" not in name for name, _ in flash):
            break
        log(f"[{tag}] profile session {attempt}: {seen} of {n_layers} wgmma launches seen")
    check_flash_route(rows, n_layers, tag)


def check_flash_route(rows, n_layers: int, tag: str = "serve") -> None:
    """The profiled bf16 prefill ran the wgmma kernel once per attention
    layer (``n_layers``; none for an attention-free model) and never the
    float32 CUDA-core kernel."""
    flash = [(name, count) for name, _, count in rows if "flash_attention_fwd" in name]
    if not rows:
        log(f"[{tag}] flash_attention route of the prefill: not measured (no profile)")
        return
    launches = sum(count for _, count in flash)
    if launches != n_layers or any("wgmma" not in name for name, _ in flash):
        raise AssertionError(f"the bf16 prefill ran {flash}, want {n_layers} launches of "
                             f"the wgmma kernel and nothing else")
    kernel = flash[0][0][:60] if flash else "the wgmma kernel"
    log(f"[{tag}] the profiled prefill ran {launches} launches of {kernel} and none of the "
        f"float32 kernel")


def check_round1(got, exact, amax: float) -> None:
    """Round 1 of the int8 lane against the exact two-stage mix: every
    element within half the largest row scale (amax/127) plus one bf16 ulp
    of the value (the two casts to bf16 round apart)."""
    from repro_torch import _tree

    half_scale = 0.5 * amax / 127 * (1 + 1e-5)   # float32 rounding of deq and the sums
    worst = 0.0
    for g, e in zip(_tree.leaves(got), _tree.leaves(exact)):
        diff = (g.float() - e.float()).abs()
        ulp = 2.0 ** -7 * g.float().abs().maximum(e.float().abs())
        excess = (diff - half_scale - ulp).max().item()
        if excess > 0:
            raise AssertionError(f"round 1 off the exact mix by {excess:.3g} beyond "
                                 f"half the largest row scale {half_scale:.3g} + 1 ulp")
        worst = max(worst, diff.max().item())
    log(f"[slice2] round 1 vs exact hierarchical_mix: max|err| {worst:.4g} "
        f"(bound: half the largest row scale {half_scale:.4g} + 1 bf16 ulp)")


def profile_call(label: str, fn, warmup: int = 0) -> list[tuple[str, float, int]]:
    """Device time of one call of ``fn`` by kernel (torch.profiler, CUPTI);
    returns (kernel name, device ms, launches) rows, none if the profiler saw
    no device kernels. ``warmup`` calls of ``fn`` run first under the
    profiler's warm-up schedule, traced but discarded: in a long run the
    profiler has lost the start of a window (a prefill's first flash
    launch, a mesh route's first kernels), so every profile that a gate
    reads takes one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    kw = {"schedule": schedule(wait=0, warmup=warmup, active=1)} if warmup else {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **kw) as prof:
        for _ in range(warmup):
            fn()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del out
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy == 0:
        log("[profile] device time: not measured (the profiler saw no device kernels)")
        return []
    log(f"[profile] {label}: device busy {busy:.1f} ms of {wall_ms:.1f} ms wall "
        f"(under the profiler), {sum(r[2] for r in rows)} kernel launches")
    by_kind: dict[str, float] = {}
    for name, ms, _ in rows:
        by_kind[_kernel_kind(name)] = by_kind.get(_kernel_kind(name), 0.0) + ms
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        log(f"[profile]   {ms:8.2f} ms {100 * ms / busy:5.1f}%  {kind}")
    for name, ms, count in rows[:8]:
        log(f"[profile]   top: {ms:8.2f} ms x{count:<4d} {name[:100]}")
    return rows


def _kernel_kind(name: str) -> str:
    n = name.lower()
    if "gossip_mix" in n:
        return "gossip_mix kernel (bus mix + update)"
    if "flash_attention_fwd" in n:
        return "flash_attention kernel (prefill attention)"
    if "quant_pack" in n:
        return "quant_pack kernel (int8 wire)"
    if "scatter_gather" in n:
        return "gather / scatter along a dim (paged attention's block tables)"
    if "indexselect" in n or "index_elementwise" in n:
        return "indexed gathers and writes (bus x[perm]; embedding, cache writes)"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma")):
        return "matrix products"
    if "copy" in n:
        return "copies and casts (incl. bus pack)"
    return "other elementwise and reductions"


# ---------------------------------------------------------------------------
# [launch]: the dry run's cost recorder on meta and on the card
# ---------------------------------------------------------------------------

LAUNCH_DRYRUN = ("--arch", "granite-3-2b", "--shape", "train_4k", "--tag", "chip_smoke")
LAUNCH_DRYRUN_TIMEOUT = 60     # seconds the report waits for it, at most
LAUNCH_SHARE_MAX = 1.05     # a bound above the measured step means a wrong count


def start_dryrun(argv, log_path: str) -> subprocess.Popen:
    """The dry-run CLI (``repro_torch.launch.dryrun``) in a process of its
    own, on the host's CPU: meta tensors over the fake process group, with
    no card (``CUDA_VISIBLE_DEVICES`` empty) and one thread, so that it
    runs beside the card's phases."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    os.makedirs(os.path.dirname(log_path), exist_ok=True)
    with open(log_path, "w") as out:
        return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun", *argv],
                                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT)


def _finish_dryrun(proc: subprocess.Popen, log_path: str, what: str, timeout: float) -> str:
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"the dry run ({what}) took over {timeout} s")
    with open(log_path) as f:
        text = f.read()
    if rc != 0:
        raise AssertionError(f"the dry run ({what}) exited {rc}:\n{text[-4000:]}")
    return text


def _to_meta(tree):
    import torch

    from repro_torch import _tree

    return _tree.map(lambda x: torch.empty_like(x, device="meta"), tree)


def _same_cost(tag: str, meta, card, kernel: str, events: int) -> None:
    """Gate: the meta run and the card run of one call count the same
    FLOPs and bytes, ``events`` calls of ``kernel`` each, and no collective."""
    for c in (meta, card):
        if c.kernel_events(kernel) != events or c.collectives or c.unreported_c10d():
            raise AssertionError(f"[launch] {tag}: {c.kernel_events(kernel)} {kernel} events "
                                 f"(want {events}), collectives {c.collectives}, c10d "
                                 f"{c.c10d_ops}")
    if meta.flops != card.flops or meta.bytes != card.bytes:
        raise AssertionError(f"[launch] {tag}: meta counts {meta.flops} FLOP, {meta.bytes} B; "
                             f"the card {card.flops} FLOP, {card.bytes} B")


def phase_launch(slice1: dict, card: str) -> dict:
    """The [launch] phase: slice 1's step under ``launch.cost.measure`` on
    meta (A) and on the card from the same state (B), slice 3's prefill
    wave on both (C), B's roofline terms against slice 1's measured step
    (D), and the dry-run CLI's ``--smoke`` (E; its full-width run, started
    beside the card's phases, is read by :func:`finish_launch`)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.convert import to_device
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import TrainState, init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.data import token_stream
    from repro_torch.launch import cost, roofline
    from repro_torch.models import model as Mo

    fresh_gb("[launch]", "launch")
    params0, batcher, _, loss, opt = slice_setup("launch")
    step = make_train_step(loss, opt, gossip=GossipSpec(topology=T.undirected_ring(M_WORKERS),
                                                        backend="fused"))
    state = init_state(params0, opt)
    del params0
    batch = to_device({"tokens": batcher.next()[0]}, "cuda")
    m_state = TrainState(state.step, _to_meta(state.params), _to_meta(state.opt_state))
    m_batch = _to_meta(batch)
    step(m_state, m_batch)                  # first calls copy the permutation index
    _, meta = cost.measure(step, m_state, m_batch)
    step(state, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out, card_cost = cost.measure(step, state, batch)
    launches = {"launch_card_step": read_launches()}
    card_peak = torch.cuda.max_memory_allocated()
    del out
    _same_cost("slice 1's step", meta, card_cost, "gossip_mix", 1)
    _same_cost("slice 1's step", meta, card_cost, "consensus_stats", 1)
    log(f"[launch] A/B slice 1's step: meta {meta.flops / 1e12:.3f} TFLOP, "
        f"{meta.bytes / 1e9:.3f} GB moved, 1 gossip_mix event ({meta.seconds:.2f} s on the "
        f"host); the card the same, exactly ({card_cost.seconds * 1e3:.1f} ms measured); peak "
        f"live {meta.peak_bytes / 1e9:.3f} GB on meta, {card_peak / 1e9:.3f} GB "
        f"max_memory_allocated on the card (ratio {meta.peak_bytes / card_peak:.3f}, not gated)")

    cfg = slice_config()
    tokens = M_WORKERS * PER_WORKER_BATCH * SEQ_LEN
    terms = roofline.analyze(card_cost, cfg, chips=1, n_tokens=tokens, kind="train", card=card)
    step_s = slice1["step_s"]
    share = terms.t_bound / step_s
    mfu = terms.model_flops_total / (step_s * roofline.BF16_PEAK)
    log(f"[launch] D slice 1's roofline on {card}: t_compute {terms.t_compute * 1e3:.2f} ms, "
        f"t_memory {terms.t_memory * 1e3:.2f} ms, bound {terms.t_bound * 1e3:.2f} ms "
        f"({terms.bottleneck}); measured {step_s * 1e3:.1f} ms/step, the bound's share "
        f"{share:.3f}; model FLOPs {terms.model_flops_total / 1e12:.2f} T (useful share "
        f"{terms.useful_flops_ratio:.3f}), MFU {mfu:.4f}")
    if share > LAUNCH_SHARE_MAX:
        raise AssertionError(f"[launch] the roofline bound is {share:.3f} of the measured step: "
                             "the card cannot beat its own roofline, so a count is wrong")
    del state, m_state, batch, m_batch
    collect()
    torch.cuda.empty_cache()

    scfg = serve_config()
    params = Mo.init(torch.Generator(device="cuda").manual_seed(0), scfg, device="cuda")
    prompts, _ = token_stream(S=SERVE_SLOTS, seq_len=PROMPT_LEN - 1, vocab=scfg.vocab_size,
                              seed=1)
    tok = torch.from_numpy(prompts).cuda()
    with torch.no_grad():
        wave = lambda p, t: Mo.prefill(p, scfg, t, max_len=SERVE_MAX_LEN)[0]  # noqa: E731
        _, m_wave = cost.measure(wave, _to_meta(params), _to_meta(tok))
        reset_launches()
        _, c_wave = cost.measure(wave, params, tok)
        launches["launch_card_prefill"] = read_launches()
    del params
    torch.cuda.empty_cache()
    if m_wave.flops != c_wave.flops:
        raise AssertionError(f"[launch] C slice 3's wave: meta {m_wave.flops} FLOP, the card "
                             f"{c_wave.flops}")
    for c in (m_wave, c_wave):
        if c.kernel_events("flash_attention") != scfg.n_layers:
            raise AssertionError(f"[launch] C: {c.kernel_events('flash_attention')} "
                                 f"flash_attention events, want {scfg.n_layers}")
    log(f"[launch] C slice 3's prefill wave ({SERVE_SLOTS} x {PROMPT_LEN}): "
        f"{m_wave.flops / 1e12:.3f} TFLOP on meta and on the card, {scfg.n_layers} "
        f"flash_attention events each; bytes {m_wave.bytes / 1e9:.3f} / "
        f"{c_wave.bytes / 1e9:.3f} GB")

    smoke_log = os.path.join(ROOT, "build", "dryrun_smoke.log")
    smoke = _finish_dryrun(start_dryrun(("--smoke",), smoke_log), smoke_log, "--smoke", 300)
    log(f"[launch] E {smoke.strip().splitlines()[-1]}")
    return {"launches": launches, "share": share, "mfu": mfu}


# ---------------------------------------------------------------------------
# [examples]: the entry points users run (repro_torch.examples)
# ---------------------------------------------------------------------------

EX_TRAIN = ("--preset", "full")     # 300 steps, M = 4 ring, 4 x 8 x 128 tokens per step


def _fig5_claim(rec: dict) -> tuple[bool, str]:
    import numpy as np

    s = rec["summary"]
    ring, clique = s["ring_time_to_target"], s["clique_time_to_target"]
    return bool(np.isfinite(ring) and ring < clique), (
        f"the ring reaches loss {s['target']:.3f} at virtual time {ring:.1f}, the clique at "
        f"{clique:.1f}")


def _straggler_claim(rec: dict) -> tuple[bool, str]:
    import numpy as np

    sparse, dense = (rec[f"degree {d}"]["time_to_target"] for d in (2, 15))
    return bool(np.isfinite(sparse) and sparse < dense), (
        f"degree 2 reaches loss {rec['summary']['target']:.2f} at virtual time {sparse:.1f}, "
        f"the clique (degree 15) at {dense:.1f}")


def _hier_claim(rec: dict) -> tuple[bool, str]:
    import numpy as np

    t = rec["summary"]["hier_crosses_ring_at_vtime"]
    return bool(np.isfinite(t)), f"hier crosses below the flat ring at virtual time {t:.1f}"


# (module, argv, its record, its claim): a claim held to the record, or one
# that the example's exit code gates (the reference's gates); longest first,
# as the pool takes them
EX_SIM = (
    ("outage_wallclock", ("--trace",), "outage_crossing.json",
     "hier through the outage beats the healthy ring: exit code"),
    ("hier_wallclock", (), "hier_crossing.json", _hier_claim),
    ("fleet_wallclock", ("--quick",), "fleet_wallclock.json",
     "the 512-ring beats hier through the composite: exit code"),
    ("dci_compress_wallclock", (), "dci_compress.json",
     "int8 DCI beats the exact wire: exit code"),
    ("straggler_wallclock", (), "straggler_wallclock.json", _straggler_claim),
    ("fig5_realloss", (), "fig5_realloss.json", _fig5_claim),
)
EX_SIM_PROCS = 3         # worker processes for the simulator examples
EX_SIM_THREADS = 2       # torch threads in each
EX_TIMEOUT = 900         # seconds from their start the started examples may take
EX_RTOL = PAPER_RTOL     # topology_matters' tail losses, card against CPU


def _example_main(name: str, argv) -> tuple[int, float]:
    """``repro_torch.examples.<name>.main(argv)`` in this process, on the
    card: (exit code, wall seconds)."""
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    t0 = time.perf_counter()
    rc = mod.main(list(argv) + ["--device", "cuda"])
    return rc, time.perf_counter() - t0


def _example_worker(name: str, argv, out_path: str) -> tuple[int, float]:
    """:func:`_example_main` in a worker process of :func:`start_examples`'s
    pool, what the example prints written to ``out_path``."""
    import contextlib

    import torch

    torch.set_num_threads(EX_SIM_THREADS)
    with open(out_path, "w") as fp, contextlib.redirect_stdout(fp):
        out = _example_main(name, argv)
    torch.cuda.empty_cache()
    return out


def _example_record(name: str) -> dict:
    from repro_torch.examples import RESULTS

    with open(os.path.join(RESULTS, name)) as fp:
        return json.load(fp)


def start_examples() -> dict:
    """Start what the [examples] phase reads: the simulator examples'
    ``main(argv)`` in a pool of ``EX_SIM_PROCS`` worker processes, and the
    command lines themselves (``python -m`` of ``train_100m --preset small
    --steps 6``, then of ``serve_demo`` of its checkpoint) in a
    subprocess. :func:`stop_examples` ends both."""
    import multiprocessing

    from repro_torch.examples import RESULTS

    logs = os.path.join(ROOT, "build", "examples")
    os.makedirs(logs, exist_ok=True)
    small = os.path.join(RESULTS, "chip_smoke_cli.npz")
    with open(os.path.join(logs, "cli.log"), "w") as fp:
        cli = subprocess.Popen(
            ["sh", "-c", 'set -e; "$0" -m repro_torch.examples.train_100m --preset small '
             '--steps 6 --ckpt "$1"; "$0" -m repro_torch.examples.serve_demo --gossip-ckpt '
             '"$1" --preset small', sys.executable, small],
            cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                               OMP_NUM_THREADS=str(EX_SIM_THREADS)),
            stdout=fp, stderr=subprocess.STDOUT)
    pool = multiprocessing.get_context("spawn").Pool(EX_SIM_PROCS)
    sims = {name: pool.apply_async(_example_worker,
                                   (name, argv, os.path.join(logs, f"{name}.log")))
            for name, argv, _, _ in EX_SIM}
    pool.close()
    log(f"[examples] started: the {len(sims)} simulator examples in {EX_SIM_PROCS} worker "
        f"processes of {EX_SIM_THREADS} threads, and the command lines in a subprocess")
    return {"pool": pool, "sims": sims, "cli": cli, "small": small, "logs": logs,
            "t0": time.perf_counter()}


def stop_examples(started: dict) -> None:
    started["pool"].terminate()
    started["pool"].join()
    if started["cli"].poll() is None:
        started["cli"].kill()
        started["cli"].wait()


def _read_started(started: dict, tag: str) -> None:
    """The examples :func:`start_examples` started: each exits 0, each
    simulator example's claim holds, the outage bundles pass the report's
    ``--check``."""
    from repro_torch.examples import RESULTS
    from repro_torch.telemetry import report

    t0 = time.perf_counter()
    deadline = started["t0"] + EX_TIMEOUT
    for name, argv, record, claim in EX_SIM:
        rc, wall = started["sims"][name].get(timeout=max(1.0, deadline - time.perf_counter()))
        with open(os.path.join(started["logs"], f"{name}.log")) as fp:
            print(fp.read(), end="", flush=True)
        rec = _example_record(record)
        ok, said = (rc == 0, claim) if isinstance(claim, str) else claim(rec)
        if rc or not ok:
            raise AssertionError(f"{name}: exit {rc}, its claim failed on the card: {said}")
        per_round = ", ".join(f"{k} {v['wall_s'] / v['rounds']:.4f}" for k, v in rec.items()
                              if isinstance(v, dict) and "wall_s" in v)
        log(f"[{tag}] {name} {' '.join(argv)}: exit 0; claim held: {said}; {wall:.1f} s; "
            f"host s per virtual round: {per_round}")
    started["pool"].join()
    for job in ("ring-nofault", "ring-outage", "hier-outage"):
        if report.main([os.path.join(RESULTS, "runs", "outage", job), "--check"]):
            raise AssertionError(f"outage bundle {job}: the report's --check failed")
    log(f"[{tag}] outage --trace bundles: python -m repro_torch.telemetry.report --check "
        f"passed for all three")
    cli = started["cli"]
    try:
        cli.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        pass
    with open(os.path.join(started["logs"], "cli.log")) as fp:
        out = fp.read()
    if cli.returncode != 0:
        raise AssertionError(f"python -m repro_torch.examples.train_100m --preset small "
                             f"--steps 6, then serve_demo of its checkpoint: exit "
                             f"{cli.returncode}\n{out[-3000:]}")
    log(f"[{tag}] python -m repro_torch.examples.train_100m --preset small --steps 6, then "
        f"python -m repro_torch.examples.serve_demo --gossip-ckpt of it: exit 0; last line: "
        f"{out.strip().splitlines()[-1]}")
    log(f"[{tag}] the started examples done {time.perf_counter() - started['t0']:.1f} s after "
        f"their start; waited {time.perf_counter() - t0:.1f} s for them here")


def _card_examples() -> dict:
    """The [examples] runs on the card, run in a process of their own
    (:func:`start_phase`) beside sim, telemetry, serve and continuous:
    ``train_100m --preset full`` meshless and ``--mesh`` (a world-size-1
    NCCL group, all M workers on the rank, the fused bus), ``serve_demo
    --gossip-ckpt`` of the mesh run's checkpoint with both batchers,
    ``topology_matters`` against its CPU run and ``quickstart``, each
    through its ``main(argv)``. Raises at the first failed gate. Returns
    launches by path."""
    import numpy as np
    import torch

    from repro_torch.examples import RESULTS, topology_matters, train_100m

    tag = "examples"
    t_phase = time.perf_counter()
    fresh_gb("the entry points", tag)
    by_path = {}
    steps = train_100m.PRESETS["full"][-1]
    ckpts = {}
    for label, extra in (("meshless", ()), ("mesh", ("--mesh",))):
        ckpts[label] = os.path.join(RESULTS, f"chip_smoke_{label}.npz")
        if os.path.exists(ckpts[label]):
            os.remove(ckpts[label])
        reset_launches()
        rc, wall = _example_main("train_100m", EX_TRAIN + extra + ("--ckpt", ckpts[label]))
        launches = read_launches()
        rec = _example_record("train_100m.json")
        loss = np.asarray(rec["loss"])
        want = steps if label == "mesh" else 0
        if rc or not np.isfinite(loss).all() or not loss[-1] < loss[0] or rec["steps"] != steps \
                or launches["gossip_mix"] != want or not os.path.exists(ckpts[label]):
            raise AssertionError(
                f"train_100m {label}: exit {rc}, {rec['steps']} steps, losses {loss[0]:.4f} -> "
                f"{loss[-1]:.4f} (finite {np.isfinite(loss).all()}), gossip_mix launches "
                f"{launches['gossip_mix']} (want {want}), checkpoint "
                f"{os.path.exists(ckpts[label])}")
        if label == "mesh":
            by_path["examples_train_100m_mesh"] = launches
        log(f"[{tag}] train_100m --preset full {label}: {rec['n_params']:,} params, "
            f"Smith lr {rec['lr']:.4f}, loss {loss[0]:.4f} -> {loss[-1]:.4f} over "
            f"{rec['steps']} steps, {rec['ms_per_step']:.2f} ms/step (steps 2 onward, host "
            f"clock), {rec['tokens_per_s']:.0f} tokens/s, peak {rec['peak_gb']:.3f} GB "
            f"allocated, gossip_mix launches {launches['gossip_mix']}; {wall:.1f} s")

    for batcher in ("continuous", "wave"):
        rc, wall = _example_main("serve_demo", ("--gossip-ckpt", ckpts["mesh"], "--preset",
                                                "full", "--batcher", batcher))
        rec = _example_record("serve_demo.json")
        short = {r: len(t) for r, t in rec["tokens"].items() if len(t) != rec["n_new"]}
        if rc or rec["batcher"] != batcher or len(rec["tokens"]) != 6 or short:
            raise AssertionError(f"serve_demo {batcher}: exit {rc}, served by "
                                 f"{rec['batcher']}, {len(rec['tokens'])} requests, short "
                                 f"answers {short}")
        log(f"[{tag}] serve_demo --gossip-ckpt (the mesh run's consensus) --batcher "
            f"{batcher}: 6 requests x {rec['n_new']} tokens in full, 2 sampled; {wall:.1f} s")

    rc, wall = _example_main("topology_matters", ())
    card = _example_record("topology_matters.json")
    n = torch.get_num_threads()
    torch.set_num_threads(1)       # thousands of tiny ops: one thread is faster
    try:
        t0 = time.perf_counter()
        cpu = topology_matters.run(device="cpu")
        cpu_s = time.perf_counter() - t0
    finally:
        torch.set_num_threads(n)
    worst = max(_rel_diff([card[s][f"{t}_tail"]], [cpu[s][f"{t}_tail"]])
                for s in topology_matters.SPLITS for t in ("ring", "clique"))
    if rc or worst > EX_RTOL:
        raise AssertionError(f"topology_matters: exit {rc}, tail losses off the CPU run by "
                             f"{worst:.3g} relative (tol {EX_RTOL})")
    log(f"[{tag}] topology_matters: tails " + ", ".join(
        f"{s} ring {card[s]['ring_tail']:.5f} clique {card[s]['clique_tail']:.5f}"
        for s in topology_matters.SPLITS)
        + f"; card vs CPU max relative difference {worst:.3g} (tol {EX_RTOL}); card "
        f"{wall:.1f} s, CPU {cpu_s:.1f} s for 4 x {topology_matters.STEPS} steps")

    rc, wall = _example_main("quickstart", ())
    if rc:
        raise AssertionError(f"quickstart: exit {rc}")
    log(f"[{tag}] quickstart: exit 0; {wall:.1f} s")
    _remove_ckpts(ckpts.values())
    log(f"[{tag}] the runs on the card took {time.perf_counter() - t_phase:.1f} s")
    return by_path


def _remove_ckpts(paths) -> None:
    """Each checkpoint of ``paths`` and the files written beside it."""
    for path in paths:
        d, base = os.path.split(path)
        for f in os.listdir(d):
            if f.startswith(base):
                os.remove(os.path.join(d, f))


def _background_phase(name: str, out_path: str) -> None:
    """One phase of ``BACKGROUND_PHASES`` in a process of its own
    (``chip_smoke.py --phase NAME OUT``), the card set up as phase 1 sets
    it; what the phase returns goes to ``OUT`` as JSON."""
    import torch

    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = BACKGROUND_PHASES[name]()
    with open(out_path, "w") as fp:
        json.dump(out, fp)


def start_phase(name: str, beside: str) -> dict:
    """Start phase ``name`` (``BACKGROUND_PHASES``) in a process of its own,
    beside the phases named by ``beside``: it holds little of the card
    (the examples ≈ 20 GB, paper 0.2 GB), so it runs beside phases whose
    own peak leaves that free; :func:`finish_phase` waits for it before a
    phase that needs the card."""
    logs = os.path.join(ROOT, "build", "phases")
    os.makedirs(logs, exist_ok=True)
    out, path = os.path.join(logs, f"{name}.json"), os.path.join(logs, f"{name}.log")
    if os.path.exists(out):
        os.remove(out)
    with open(path, "w") as fp:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--phase", name,
                                 out], stdout=fp, stderr=subprocess.STDOUT)
    log(f"[{name}] started in a process of its own, beside {beside}")
    return {"name": name, "proc": proc, "out": out, "log": path, "t0": time.perf_counter()}


def finish_phase(bg: dict) -> dict:
    """Wait for :func:`start_phase`'s process; print what it logged; fail
    if it failed. Returns what the phase returned."""
    proc, name, t0 = bg["proc"], bg["name"], time.perf_counter()
    try:
        proc.wait(timeout=max(1.0, bg["t0"] + BACKGROUND_TIMEOUT - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    with open(bg["log"]) as fp:
        out = fp.read()
    print(out, end="" if out.endswith("\n") else "\n", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"the {name} phase's process: exit {proc.returncode} (killed at "
                             f"{BACKGROUND_TIMEOUT} s if negative)")
    with open(bg["out"]) as fp:
        result = json.load(fp)
    log(f"[{name}] read {time.perf_counter() - bg['t0']:.1f} s after its start; waited "
        f"{time.perf_counter() - t0:.1f} s for it here")
    return result


def stop_phase(bg: dict) -> None:
    if bg["proc"].poll() is None:
        bg["proc"].kill()
        bg["proc"].wait()


def phase_examples(started: dict) -> dict:
    """The rest of the [examples] phase, after slices 13-15: what
    :func:`start_examples` started (the simulator examples and the command
    lines). The runs on the card (:func:`_card_examples`) were read before
    slice 8. Returns launches by path (none: the simulator examples mix
    through the einsum and leaf paths)."""
    tag = "examples"
    t_phase = time.perf_counter()
    _read_started(started, tag)
    _remove_ckpts([started["small"]])
    log(f"[{tag}] phase {time.perf_counter() - t_phase:.1f} s after slices 13-15")
    return {}


# phases run in a process of their own (:func:`start_phase`)
BACKGROUND_PHASES = {"examples": _card_examples, "paper": phase_paper}
BACKGROUND_TIMEOUT = 600     # seconds from its start such a phase may take


def finish_launch(dryrun: tuple) -> None:
    """E, the end of the [launch] phase: the full-width dry run of
    ``LAUNCH_DRYRUN``, started after the build, must have exited 0."""
    proc, path = dryrun
    t0 = time.perf_counter()
    full = _finish_dryrun(proc, path, " ".join(LAUNCH_DRYRUN), LAUNCH_DRYRUN_TIMEOUT)
    log(f"[launch] E the full-width dry run (waited {time.perf_counter() - t0:.1f} s for it): "
        + " | ".join(full.strip().splitlines()[-3:]))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails outside a checkout of the repo)
    t_start = time.perf_counter()
    smi = phase_device()
    phase_build()
    dryrun_log = os.path.join(ROOT, "build", "dryrun_full.log")
    dryrun = start_dryrun(LAUNCH_DRYRUN, dryrun_log)
    try:
        return _phases(smi, t_start, (dryrun, dryrun_log))
    finally:
        if dryrun.poll() is None:
            dryrun.kill()
            dryrun.wait()


def _phases(smi: str, t_start: float, dryrun: tuple) -> int:
    import torch

    card = torch.cuda.get_device_name(0)
    seconds = {"device and build": time.perf_counter() - t_start}

    def timed(name: str, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    entries = timed("kernel checks", lambda: [phase_kernel_check(card), phase_quant_check(card),
                                              phase_flash_check(card),
                                              phase_stats_check(card)])
    slice1 = timed("slice1", phase_slice)
    timed("checkpoint", phase_checkpoint, slice1.pop("params"))
    by_path = {"slice1_train": slice1["launches"]}
    by_path.update(timed("launch", phase_launch, slice1, card)["launches"])
    by_path.update(timed("slice2", phase_slice2, slice1))
    by_path["slice5_train"] = timed("slice5", phase_slice5, slice1)["launches"]
    # the [examples] runs on the card (≈ 20 GB) beside the four phases that
    # leave that free, read before slice 8's models fill the card
    bg = start_phase("examples", "sim, telemetry, serve and continuous")
    try:
        by_path.update(timed("sim", phase_sim))
        by_path.update(timed("telemetry", phase_telemetry))
        by_path["slice3_serve"] = timed("serve", phase_serve)["launches"]
        by_path["slice7_continuous"] = timed("continuous", phase_continuous, card)["launches"]
        by_path.update(timed("examples on the card (wait)", finish_phase, bg))
    finally:
        stop_phase(bg)
    # Fig. 2 (0.2 GB; its CPU twins in a pool, the dry run's host core free
    # by now) beside slices 8-10; slice 11's deepest run needs the whole card
    bg = start_phase("paper", "slices 8-10")
    try:
        for name, fn in (("slice8", phase_slice8), ("slice9", phase_slice9),
                         ("slice10", phase_slice10)):
            by_path.update(timed(name, fn))
        by_path["paper_fused_train"] = timed("paper (wait)", finish_phase, bg)["launches"]
    finally:
        stop_phase(bg)
    by_path.update(timed("slice11", phase_slice11))
    # the simulator examples and the command lines run beside slices 12-15
    started = start_examples()
    try:
        by_path.update(timed("slice12", phase_slice12))
        by_path.update(timed("slices13-15", phase_slice13))
        by_path.update(timed("examples", phase_examples, started))
    finally:
        stop_examples(started)
    timed("dry run wait", finish_launch, dryrun)
    log("[report] seconds by phase: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    for e in entries:
        e["launches_by_path"] = {path: n[e["name"]] for path, n in by_path.items()}
        e["launches"] = sum(e["launches_by_path"].values())
        if e["launches"] == 0:
            raise AssertionError(f"{e['name']} was never launched on the paths")
    log(f"[report] every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": entries}))
    log(smi)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-rank"]:
        _tp_rank(int(sys.argv[2]), sys.argv[3])
        sys.exit(0)
    if sys.argv[1:2] == ["--phase"]:
        _background_phase(sys.argv[2], sys.argv[3])
        sys.exit(0)
    sys.exit(main())
