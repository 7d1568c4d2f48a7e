"""Batched serving: prefill and greedy or sampled decode over KV caches.

The port of the reference's ``repro/serving/engine.py``:
``load_consensus_params`` (a monolithic npz, worker-stacked or not, or a
worker-sharded checkpoint; with ``mesh=`` the rank's cut of the
consensus), ``make_serve_step``, ``GenerationResult``, ``generate`` and
the lock-step ``WaveBatcher``. The reference's jitted ``lax.scan`` decode loop is a
Python loop here; tokens and logprobs stay on the device and come to the
host at the end, as in the reference. The KV caches are written in place;
a sliding-window config decodes over ring caches of ``window`` slots, and
a ragged wave over a ring raises, as in the reference; so does any ragged
wave of a recurrent arch (Mamba-2, RG-LRU), whose state pad tokens would
pass through: those batch equal-length prompts. An encoder-decoder is
served through ``generate(..., enc_embeds=...)``; ``WaveBatcher`` passes no
frame embeddings, as in the reference.

Greedy decoding is ``argmax`` (the first maximum, as in JAX). With
``temperature > 0`` tokens are drawn from a ``torch.Generator`` seeded by
``seed``: deterministic for a seed, but not the numbers ``jax.random``
draws. The continuous batcher over paged caches is
``repro_torch.serving.batcher.ContinuousBatcher``; ``WaveBatcher`` stays as
its baseline. Both batchers take a request's time to first token (``ttft``)
at the same point, when its first token is ready on the device
(:class:`FirstTokenClock`).

Serving on a mesh replicates over the worker axes and cuts each replica
over the model axis, as the reference's ``param_pspecs(cfg, wm,
"allreduce")`` does: every worker group serves the whole call.
``load_consensus_params(mesh=)`` gives the rank's cut, and ``generate``,
``make_serve_step`` and ``WaveBatcher`` compute on it inside
``launch.mesh.model_parallel(wm)``, which the caller enters, as a train
step's caller does: the layers run on the rank's heads, channels and
vocab columns, the caches hold the rank's cut (``model.init_cache``), and
the logits are gathered over the model group before the argmax or the
draw (``model.logits_from_hidden``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterable

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import to_device
from repro_torch.models import model as M
from repro_torch.train import checkpoint as ckpt_lib

PyTree = Any

__all__ = ["load_consensus_params", "make_serve_step", "GenerationResult",
           "generate", "WaveBatcher", "FirstTokenClock"]


def load_consensus_params(path: str, cfg: ModelConfig, *,
                          dtype: torch.dtype | str | None = None,
                          device: str | torch.device = "cuda", mesh=None) -> PyTree:
    """Decode-ready params from a gossip-trained checkpoint.

    The checkpoint may be worker-stacked (every leaf carries the leading M
    dim the decentralized trainer keeps) or already consensus-averaged; a
    stacked one is collapsed on ``device`` by
    ``checkpoint.consensus_params`` (the paper's output model
    w̄ = (1/M) Σ_j w_j) before serving. A worker-sharded checkpoint
    (``checkpoint.save_sharded``) is averaged shard by shard by
    ``checkpoint.consensus_from_sharded``, one worker replica on the host at
    a time.

    With ``mesh`` (a live WorkerMesh or DeviceMesh) the result is this
    rank's cut of the consensus under ``param_pspecs(cfg, mesh,
    "allreduce")``, on the mesh's device: of a sharded checkpoint each
    shard's leaves are cut as they arrive; of a monolithic worker-stacked
    one each leaf's workers are read one at a time onto the device,
    averaged there by ``consensus_params`` (the workers of one leaf, whole:
    its sum over them is bit for bit the meshless one's) and cut; of an
    unstacked one the rank keeps its cut. The file is memory-mapped, so
    no worker replica is copied on the host, and the same bits as the
    meshless consensus's cut come back."""
    dt = dtype or cfg.param_dtype
    dt = getattr(torch, dt) if isinstance(dt, str) else dt
    like = _tree.map(lambda d: torch.empty(d.shape, dtype=dt, device="meta"),
                     M.model_defs(cfg))
    specs = wm = None
    if mesh is not None:
        from repro_torch.launch.mesh import WorkerMesh
        from repro_torch.launch.shardings import param_pspecs

        wm = WorkerMesh.ensure(mesh)
        specs = param_pspecs(cfg, wm, "allreduce")
        device = wm.mesh.device_type
    if ckpt_lib._is_sharded(path):
        return ckpt_lib.consensus_from_sharded(
            path, like, device, shardings=None if wm is None else (specs, wm))
    data = ckpt_lib._load_npz(ckpt_lib._npz_path(path))
    # worker-stacked iff a stored leaf has one more dim than its template
    # (bf16 leaves are stored as a same-shape uint16 view)
    by_key = {ckpt_lib._path_key(p): leaf for p, leaf in _tree.flatten_with_path(like)}
    f0 = next(iter(data))
    leaf0 = by_key[ckpt_lib._base_key(f0)]
    stacked = data[f0].ndim == leaf0.dim() + 1
    if wm is not None:
        return _consensus_cut(path, like, specs, wm, device, stacked)
    if stacked:
        Mw = data[f0].shape[0]
        like_M = _tree.map(lambda t: torch.empty((Mw,) + tuple(t.shape), dtype=t.dtype,
                                                 device="meta"), like)
        return ckpt_lib.consensus_params(ckpt_lib.restore(path, like_M, device))
    return ckpt_lib.restore(path, like, device)


def _consensus_cut(path: str, like: PyTree, specs: PyTree, wm, device,
                   stacked: bool) -> PyTree:
    """:func:`load_consensus_params`' monolithic checkpoint on a mesh, leaf
    by leaf: its member of the npz memory-mapped (``checkpoint._load_npz``,
    its CRC checked), a stacked leaf's workers moved to ``device`` one at a
    time and averaged there by ``checkpoint.consensus_params``, the result
    cut to the rank (``launch.shardings.local_tree``)."""
    from repro_torch.convert import resolve_device
    from repro_torch.launch.shardings import local_tree

    dev = resolve_device(device)
    data = ckpt_lib._load_npz(ckpt_lib._npz_path(path))
    stored_by_key = {ckpt_lib._base_key(f): f for f in data}
    paths = _tree.flatten_with_path(like)
    ckpt_lib._check_keys(path, stored_by_key, paths)
    out = []
    for (p, leaf), spec in zip(paths, _tree.flatten_up_to(_tree.flatten(like)[1], specs)):
        stored = stored_by_key[ckpt_lib._path_key(p)]
        raw = data[stored]
        workers = [ckpt_lib._stored_tensor(w, stored, dev).to(leaf.dtype)
                   for w in (raw if stacked else [raw])]
        for t in workers:
            ckpt_lib._check_shape(path, stored, t, leaf)
        whole = ckpt_lib.consensus_params(torch.stack(workers)) if stacked else workers[0]
        del workers
        out.append(local_tree([whole], [spec], wm)[0].clone())
    return _tree.unflatten(_tree.flatten(like)[1], out)


def make_serve_step(cfg: ModelConfig):
    """serve_step(params, caches, token [, memory, cross_kvs]) -> (logits,
    caches): ONE new token against the KV caches (written in place); an
    encoder-decoder passes its prefill's memory and cross K/V."""

    def serve_step(params, caches, token, memory=None, cross_kvs=None):
        return M.decode_step(params, cfg, caches, token, memory=memory,
                             cross_kvs=cross_kvs)

    return serve_step


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray        # (B, n_new) int32
    logprobs: np.ndarray      # (B, n_new) float32


@torch.no_grad()
def generate(params, cfg: ModelConfig, prompt, *, n_new: int,
             max_len: int | None = None, temperature: float = 0.0,
             enc_embeds=None, seed: int = 0, lengths=None,
             on_first_token: Callable[[], None] | None = None) -> GenerationResult:
    """Prefill the prompt and decode n_new tokens (greedy or sampled).

    ``prompt`` (B, Lp), ``lengths`` and an encoder-decoder's ``enc_embeds``
    (B, S, D), its frame embeddings, may be numpy arrays or tensors; they
    are moved to the params' device. The encoder runs once, in the
    prefill; every decode step reads its memory and cross K/V. ``lengths`` (B,) marks RIGHT-padded
    ragged prompts: pad keys are masked out of prefill attention, per-row
    rope positions continue from each row's real length, and decoding starts
    from each row's last real token. The decode step after the last token
    is not run: its logits would be discarded. ``on_first_token`` is called
    once the first tokens are queued on the device (a batcher's TTFT mark).
    """
    dev = params["embed"].device
    prompt = to_device(prompt, dev)
    B, Lp = prompt.shape
    max_len = max_len or (Lp + n_new)
    if lengths is not None:
        lengths = to_device(lengths, dev).to(torch.int32)
    if enc_embeds is not None:
        enc_embeds = to_device(enc_embeds, dev)
    logits, caches, cross_kvs, memory = M.prefill(
        params, cfg, prompt, max_len=max_len, enc_embeds=enc_embeds, lengths=lengths)
    logits = logits[:, -1]
    gen = torch.Generator(device=dev).manual_seed(seed) if temperature > 0 else None
    toks, lps = [], []
    for t in range(n_new):
        lp = torch.log_softmax(logits, dim=-1)
        if gen is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        toks.append(nxt)
        lps.append(torch.gather(lp, -1, nxt[:, None])[:, 0])
        if t == 0 and on_first_token is not None:
            on_first_token()
        if t + 1 < n_new:
            logits, caches = M.decode_step(
                params, cfg, caches, nxt[:, None], memory=memory, cross_kvs=cross_kvs,
                lengths=lengths, prompt_len=Lp if lengths is not None else None)
            logits = logits[:, -1]
    return GenerationResult(torch.stack(toks, dim=1).to(torch.int32).cpu().numpy(),
                            torch.stack(lps, dim=1).cpu().numpy())


class FirstTokenClock:
    """When each request's first token is ready on the device, on the host's
    ``time.perf_counter`` clock, with no sync on the serving path.

    ``mark`` records one CUDA event behind the work that makes a group's
    first tokens; ``read``, called once the host has synced past it (a
    batcher's transfer of finished tokens), turns the event into host time
    through an anchor event recorded on an idle device. On the CPU the work
    is done when ``mark`` runs, so ``mark`` reads the host clock."""

    def __init__(self, dev: torch.device):
        self.dev = torch.device(dev)
        self._marks: dict[int, Any] = {}
        self.anchor()

    def anchor(self) -> None:
        """Tie the device's event clock to the host's (one sync)."""
        if self.dev.type != "cuda":
            return
        torch.cuda.synchronize(self.dev)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.dev))
        ev.synchronize()
        self._anchor = (ev, time.perf_counter())

    def mark(self, rids: Iterable[int]) -> None:
        if self.dev.type == "cuda":
            at = torch.cuda.Event(enable_timing=True)
            at.record(torch.cuda.current_stream(self.dev))
        else:
            at = time.perf_counter()
        for rid in rids:
            self._marks[rid] = at

    def read(self, rid: int) -> float:
        """The host time at which ``rid``'s mark was reached (drops it)."""
        at = self._marks.pop(rid)
        if isinstance(at, float):
            return at
        at.synchronize()                  # already past: returns at once
        ev, t = self._anchor
        return t + ev.elapsed_time(at) / 1e3


@dataclasses.dataclass
class _Request:
    rid: int
    prompt: np.ndarray
    n_new: int
    t_submit: float


class WaveBatcher:
    """Wave-based batched serving: requests are grouped into fixed-size
    waves, RIGHT-padded to the wave's longest prompt, prefilled together and
    decoded in lock-step (one shared cache position per wave). Ragged waves
    pass per-row ``lengths`` so pad positions never leak into attention;
    recurrent archs (ssm/rglru) refuse them and must batch equal-length
    prompts.
    ``ttft[rid]``: seconds from submit until the wave's prefill has made the
    request's first token on the device.
    """

    def __init__(self, params, cfg: ModelConfig, batch_slots: int, max_len: int,
                 pad_id: int = 0):
        self.params, self.cfg = params, cfg
        self.B, self.max_len, self.pad_id = batch_slots, max_len, pad_id
        self.queue: list[_Request] = []
        self.done: dict[int, np.ndarray] = {}
        self.ttft: dict[int, float] = {}
        self._clock = FirstTokenClock(params["embed"].device)
        self._rid = 0

    def submit(self, prompt: np.ndarray, n_new: int) -> int:
        self._rid += 1
        self.queue.append(_Request(self._rid, np.asarray(prompt), n_new,
                                   time.perf_counter()))
        return self._rid

    def _next_wave(self) -> list[_Request]:
        wave, self.queue = self.queue[: self.B], self.queue[self.B:]
        return wave

    def run_wave(self) -> None:
        wave = self._next_wave()
        if not wave:
            return
        Lp = max(len(r.prompt) for r in wave)
        n_new = max(r.n_new for r in wave)
        prompts = np.full((len(wave), Lp), self.pad_id, np.int32)
        for i, r in enumerate(wave):  # right-pad: positions stay 0..len-1
            prompts[i, :len(r.prompt)] = r.prompt
        lens = np.array([len(r.prompt) for r in wave], np.int32)
        ragged = bool((lens != Lp).any())
        res = generate(self.params, self.cfg, prompts, n_new=n_new,
                       max_len=min(self.max_len, Lp + n_new),
                       lengths=lens if ragged else None,
                       on_first_token=lambda: self._clock.mark(r.rid for r in wave))
        for i, r in enumerate(wave):
            self.done[r.rid] = res.tokens[i, : r.n_new]
            self.ttft[r.rid] = self._clock.read(r.rid) - r.t_submit

    def run_until_done(self) -> dict[int, np.ndarray]:
        while self.queue:
            self.run_wave()
        return self.done
