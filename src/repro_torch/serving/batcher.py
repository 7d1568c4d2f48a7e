"""Continuous batcher: paged-KV decode slots refilled as requests finish.

The port of the reference's ``repro/serving/batcher.py``. Against the wave
discipline (pad every request to the wave's maximum,
decode in lock-step) it keeps:

  * batched admission: freed slots are refilled from the queue at once
    while the other slots keep decoding; slots freed in the same step are
    admitted in ONE right-padded prefill (``model.prefill(..., lengths=)``)
    per admission group, groups sized in descending powers of two;
  * length-bucketed prefills: ``warmup()`` runs every (group size, prompt
    bucket) admission once, and ``stats()`` counts the admission shapes
    met after it (``bucket_misses``);
  * ONE decode program over all slots with the tokens and logprobs kept
    on the device: the host sees a request's tokens once, when it
    finishes. Completion needs no device sync: ``n_new`` is known at submit
    time and every decode advances each active slot by exactly one token,
    so the host mirrors progress in Python ints.

The decode program is the reference's single jitted step. On the card it
is one CUDA graph, captured when the batcher is built, over persistent slot
state: ``cur``, ``n_gen``, ``n_target``, ``out_toks``, ``out_lps``, the page
pools, tables and lengths. Admission and retirement write that state in
place, outside the graph, and every decode is one ``graph.replay()``; a
reset zeroes it in place, so the graph never reads freed memory. Sampled
decode (``temperature > 0``) draws from a seeded ``torch.Generator``
registered with the graph. On the CPU the same step runs eagerly.
``stats()["decode_traces"]`` counts graph captures on the card and built
decode programs on the CPU: one either way, by construction. What shows
that serving ran through the graph is ``decode_replays`` (one per decode
since ``warmup()``) beside ``eager_decodes`` (0 on the card). Eager torch
builds nothing per admission shape or retirement, so ``admit_traces``
holds a 1 for each admission shape met and ``retire_traces`` is 1: the
reference's keys, kept for its gates.

``ttft[rid]`` is the time from submit until the request's first token is
ready on the device, read without a sync when the request finishes
(:class:`~repro_torch.serving.engine.FirstTokenClock`), as
``WaveBatcher.ttft`` is.

With ``mesh=`` (a live mesh of model factor k > 1) the batcher serves a
rank's cut of the params, as the reference's ``ContinuousBatcher(mesh=)``
places them (``param_pspecs(cfg, mesh, "allreduce")``: every worker group
serves the whole call): its paged pools hold the rank's kv heads where
they divide k, else every kv head, MLA's whole (``kvcache.paged_cache_pspecs``),
and admission and decode run inside ``launch.mesh.model_parallel``. Its
decode step then runs collectives over the model group, and it runs
eagerly, on the card too: ``stats()["decode"]`` is ``"eager"`` and
``stats()["decode_reason"]`` says why (a gloo collective cannot be
captured in a CUDA graph, and NCCL at k > 1 needs a card per rank). At
model factor 1 a mesh changes nothing: the batcher is meshless, with its
graph on the card.

Sampled tokens are deterministic for a seed but not the numbers
``jax.random`` draws; greedy tokens are the reference's. Requests longer
than the largest bucket and archs the paged cache cannot serve (see
``kvcache.supports_paged``) belong to the
:class:`~repro_torch.serving.engine.WaveBatcher`, kept as the baseline.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import WorkerMesh, model_parallel
from repro_torch.models import attention as attn_lib
from repro_torch.models import model as M
from repro_torch.serving import kvcache as kv
from repro_torch.serving.engine import FirstTokenClock

__all__ = ["default_buckets", "ContinuousBatcher"]

EAGER_WARM_STEPS = 3   # eager decodes on a side stream before the capture


@dataclasses.dataclass
class _Pending:
    rid: int
    prompt: np.ndarray
    n_new: int
    t_submit: float


@dataclasses.dataclass
class _InFlight:
    rid: int
    n_new: int
    n_gen: int          # host mirror of the device counter: no sync needed
    t_submit: float


def default_buckets(page: int, max_len: int) -> list[int]:
    """Doubling prefill buckets, each a whole number of pages."""
    out, b = [], page
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(-(-max_len // page) * page)
    return sorted(set(out))


def _model_mesh(mesh) -> WorkerMesh | None:
    """The live WorkerMesh of ``mesh`` where its model factor exceeds 1,
    else None (no mesh, or one whose replicas are whole)."""
    if mesh is None:
        return None
    from torch.distributed.device_mesh import DeviceMesh

    if not isinstance(WorkerMesh.raw(mesh), DeviceMesh):
        raise TypeError(f"mesh={mesh!r}: ContinuousBatcher serves over a live mesh, a "
                        "WorkerMesh or DeviceMesh from launch.mesh.make_host_mesh")
    wm = WorkerMesh.ensure(mesh)
    return wm if wm.model_factor > 1 else None


class ContinuousBatcher:
    """Continuous batching over a paged KV cache (API mirrors WaveBatcher).

    Runs on the params' device. ``mesh``: a live WorkerMesh or DeviceMesh
    (``launch.mesh.make_host_mesh``); at model factor k > 1 ``params`` are
    this rank's cut (``engine.load_consensus_params(mesh=)``), as
    ``generate`` and ``WaveBatcher`` take them (module note)."""

    @torch.no_grad()
    def __init__(self, params, cfg: ModelConfig, batch_slots: int,
                 max_len: int, pad_id: int = 0, *, page_size: int = 16,
                 max_new: int = 64, temperature: float = 0.0, seed: int = 0,
                 buckets: list[int] | None = None, mesh=None):
        reason = kv.paged_unsupported_reason(cfg)
        if reason is not None:
            raise ValueError(
                f"ContinuousBatcher unsupported: {reason}; use WaveBatcher")
        self.wm = _model_mesh(mesh)
        self.cfg, self.pad_id, self.params = cfg, pad_id, params
        self.S, self.max_len, self.max_new = batch_slots, max_len, max_new
        self.temperature = temperature
        self.buckets = buckets or default_buckets(page_size, max_len)
        if any(b % page_size for b in self.buckets):
            raise ValueError("prefill buckets must be multiples of page_size")
        self.dev = params["embed"].device
        self._gen = torch.Generator(device=self.dev).manual_seed(seed)

        self.pool = kv.PagePool(batch_slots, max_len, page_size)
        # admission group sizes (descending powers of two <= S): a clump of
        # freed slots is split greedily into these, so admission meets
        # len(admit_sizes) x len(buckets) prefill shapes
        self.admit_sizes = []
        a = 1
        while a <= self.S:
            self.admit_sizes.append(a)
            a *= 2
        self.admit_sizes.reverse()

        # persistent slot state: allocated once, reset in place
        S, dev = self.S, self.dev
        with model_parallel(self.wm):
            self.caches = kv.init_paged_caches(cfg, self.pool, dev)
        self.cur = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.n_gen = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.n_target = torch.zeros((S,), dtype=torch.int32, device=dev)
        self.out_toks = torch.zeros((S, max_new), dtype=torch.int32, device=dev)
        self.out_lps = torch.zeros((S, max_new), dtype=torch.float32, device=dev)
        self._reset_state()

        # the decode program built (a graph capture on the card), the
        # admission shapes (A, bucket) met, decodes by route since warmup()
        self._decode_traces = 0
        self._admit_shapes: set[tuple[int, int]] = set()
        self._replays = 0
        self._eager_decodes = 0
        self._bucket_hits = 0
        self._bucket_misses = 0
        self._occupancy: list[float] = []
        self.ttft: dict[int, float] = {}
        self.done: dict[int, np.ndarray] = {}
        self.done_logprobs: dict[int, np.ndarray] = {}
        self.queue: list[_Pending] = []
        self._rid = 0
        self.decode_reason = self._eager_reason()
        self._graph = self._make_decode()
        self._clock = FirstTokenClock(self.dev)

    # -- state ------------------------------------------------------------

    def _reset_state(self) -> None:
        """Zero all slot state in place (the decode graph keeps reading the
        same storage; warmup() uses this to discard its dummy traffic)."""
        self.pool.reset()
        kv.clear_paged_caches(self.cfg, self.caches, self.pool.dump)
        for t in (self.cur, self.n_gen, self.n_target, self.out_toks, self.out_lps):
            t.zero_()
        self.slots: list[_InFlight | None] = [None] * self.S

    def state(self) -> tuple:
        """(caches, cur, n_gen, n_target, out_toks, out_lps): the decode
        step's persistent device state, for :meth:`decode_eager`."""
        return (self.caches, self.cur, self.n_gen, self.n_target, self.out_toks,
                self.out_lps)

    # -- the decode program -----------------------------------------------

    def _sample(self, logits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(tokens int32, their logprobs) from (B, V) float32 logits. Sampling
        is ``multinomial``'s own draw (argmax of p / Exp(1) noise) without
        its host-side check, so it can be captured."""
        lp = torch.log_softmax(logits, dim=-1)
        if self.temperature > 0:
            probs = torch.softmax(logits / self.temperature, dim=-1)
            noise = torch.empty_like(probs).exponential_(generator=self._gen)
            nxt = torch.argmax(probs / noise, dim=-1)
        else:
            nxt = torch.argmax(logits, dim=-1)
        lpn = torch.gather(lp, -1, nxt[:, None])[:, 0]
        return nxt.to(torch.int32), lpn

    def _eager_reason(self) -> str | None:
        """Why the decode step runs eagerly (None: one CUDA graph)."""
        if self.wm is not None:
            return (f"model factor {self.wm.model_factor}: the decode step runs collectives "
                    "over the model group, which gloo cannot capture in a CUDA graph and "
                    "NCCL runs only with a card per rank")
        if self.dev.type != "cuda":
            return f"no CUDA graph on the {self.dev.type}"
        return None

    @torch.no_grad()
    def decode_eager(self, caches, cur, n_gen, n_target, out_toks, out_lps) -> None:
        """One decode step over all slots, eagerly, on the given state (in
        place): the body the graph captures. Active slots (n_gen < n_target)
        record their next token and logprob, advance cur, n_gen and the
        caches' lengths; the others write only the dump page."""
        with model_parallel(self.wm):
            logits, _ = M.decode_step(self.params, self.cfg, caches, cur[:, None])
        nxt, lpn = self._sample(logits[:, -1])
        active = n_gen < n_target
        rows = torch.arange(cur.shape[0], device=cur.device)
        idx = torch.clamp_max(n_gen, out_toks.shape[1] - 1).long()
        out_toks[rows, idx] = torch.where(active, nxt, out_toks[rows, idx])
        out_lps[rows, idx] = torch.where(active, lpn, out_lps[rows, idx])
        cur.copy_(torch.where(active, nxt, cur))
        inc = active.to(torch.int32)
        kv.bump_lengths(self.cfg, caches, inc)
        n_gen.add_(inc)

    def _make_decode(self) -> torch.cuda.CUDAGraph | None:
        """Capture the decode step as a CUDA graph over the (empty) slot
        state; on the CPU the step runs eagerly and there is nothing to
        build but the count. Runs while every slot is inactive, so the warm
        steps change nothing but the dump page."""
        self._decode_traces += 1
        if self.decode_reason is not None:
            return None
        st = self.state()
        side = torch.cuda.Stream(self.dev)
        side.wait_stream(torch.cuda.current_stream(self.dev))
        with torch.cuda.stream(side):       # cuBLAS workspaces, rope tables
            for _ in range(EAGER_WARM_STEPS):
                self.decode_eager(*st)
        torch.cuda.current_stream(self.dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        if self.temperature > 0:
            graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            self.decode_eager(*st)
        return graph

    def _decode(self) -> None:
        if self._graph is not None:
            self._graph.replay()
            self._replays += 1
        else:
            self.decode_eager(*self.state())
            self._eager_decodes += 1

    # -- public API --------------------------------------------------------

    def submit(self, prompt: np.ndarray, n_new: int) -> int:
        prompt = np.asarray(prompt)
        if n_new > self.max_new:
            raise ValueError(f"n_new {n_new} > max_new {self.max_new}")
        if len(prompt) + n_new > self.max_len:
            raise ValueError("prompt + n_new exceeds max_len")
        self._rid += 1
        self.queue.append(_Pending(self._rid, prompt, n_new,
                                   time.perf_counter()))
        return self._rid

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds largest bucket")

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.dev)

    @torch.no_grad()
    def _admit_group(self, slots: list[int], reqs: list[_Pending]) -> None:
        """Admit a group of requests to a group of free slots in ONE
        prefill. Mixed prompt buckets share the group's max bucket (pad
        blocks land on the dump page). The first tokens are marked on the
        device clock, read when each request finishes."""
        A = len(slots)
        Lb = max(self._bucket(len(r.prompt)) for r in reqs)
        key = (A, Lb)
        if key in self._admit_shapes:
            self._bucket_hits += 1
        else:
            self._bucket_misses += 1
            self._admit_shapes.add(key)
        prompts = np.full((A, Lb), self.pad_id, np.int32)
        lengths = np.empty((A,), np.int32)
        rows = np.empty((A, self.pool.nb), np.int32)
        for i, (s, r) in enumerate(zip(slots, reqs)):
            prompts[i, :len(r.prompt)] = r.prompt      # RIGHT-pad
            lengths[i] = len(r.prompt)
            rows[i] = self.pool.admit(s, len(r.prompt) + r.n_new)
        ids = rows[:, :Lb // self.pool.page].astype(np.int64)
        n_new = np.asarray([r.n_new for r in reqs], np.int32)
        lengths_t = self._to_dev(lengths)
        slots_t = self._to_dev(np.asarray(slots, np.int64))
        # ragged batched prefill: pad rows are masked out of attention and
        # logits come from each row's last REAL position; its caches are laid
        # out as the pools (no cut over the sequence)
        with model_parallel(self.wm), attn_lib.whole_sequence_caches():
            logits, dense, _, _ = M.prefill(self.params, self.cfg, self._to_dev(prompts),
                                            max_len=Lb, lengths=lengths_t)
        kv.scatter_prefill(self.cfg, self.caches, dense, slots_t, self._to_dev(ids),
                           self._to_dev(rows), lengths_t)
        del dense
        tok0, lp0 = self._sample(logits[:, -1])
        self.cur[slots_t] = tok0
        self.n_gen[slots_t] = 1
        self.n_target[slots_t] = self._to_dev(n_new)
        self.out_toks[slots_t, 0] = tok0
        self.out_lps[slots_t, 0] = lp0
        self._clock.mark(r.rid for r in reqs)
        for s, r in zip(slots, reqs):
            self.slots[s] = _InFlight(r.rid, r.n_new, 1, r.t_submit)

    def _finish(self, slot: int) -> None:
        # the whole buffers to the host, sliced there: one transfer per
        # finished request and no device-side slice per (slot, n_new)
        f = self.slots[slot]
        self.done[f.rid] = self.out_toks.cpu().numpy()[slot, :f.n_new].copy()
        self.done_logprobs[f.rid] = self.out_lps.cpu().numpy()[slot, :f.n_new].copy()
        self.ttft[f.rid] = self._clock.read(f.rid) - f.t_submit
        self.pool.retire(slot)
        kv.retire_slot(self.cfg, self.caches, slot, dump=self.pool.dump)
        self.slots[slot] = None

    def _refill(self) -> None:
        free = [s for s in range(self.S) if self.slots[s] is None]
        take = min(len(free), len(self.queue))
        if not take:
            return
        reqs = [self.queue.pop(0) for _ in range(take)]
        i = 0
        while i < take:
            A = next(a for a in self.admit_sizes if a <= take - i)
            group_slots = free[i:i + A]
            self._admit_group(group_slots, reqs[i:i + A])
            i += A
            for s in group_slots:
                if self.slots[s].n_gen >= self.slots[s].n_new:
                    self._finish(s)        # n_new == 1: done at admission

    def step(self) -> int:
        """Refill free slots, run one decode over all slots, retire finished
        requests. Returns the number of slots that were active."""
        self._refill()
        active = [s for s in self.slots if s is not None]
        if not active:
            return 0
        self._occupancy.append(len(active) / self.S)
        self._decode()
        for slot, f in enumerate(self.slots):
            if f is not None:
                f.n_gen += 1
                if f.n_gen >= f.n_new:
                    self._finish(slot)
        return len(active)

    def run_until_done(self) -> dict[int, np.ndarray]:
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return self.done

    def warmup(self, n_new: int = 2) -> None:
        """Run every (group size, prefill bucket) admission and a decode on
        dummy traffic, then reset the state in place. Steady-state serving
        afterwards meets only warmed shapes: ``stats()`` shows no bucket
        misses and one decode program. Needs an idle batcher."""
        busy = sum(s is not None for s in self.slots)
        if busy or self.queue:
            raise RuntimeError(
                f"warmup() needs an idle batcher: {busy} requests in flight, "
                f"{len(self.queue)} queued; run_until_done() first")
        for Lb in self.buckets:
            # longest prompt that both lands in this bucket and leaves room
            # for n_new generated tokens
            plen = min(max(1, Lb - 1), self.max_len - n_new)
            if plen <= 0 or self._bucket(plen) != Lb:
                continue
            for A in self.admit_sizes:
                reqs = [_Pending(-1 - i, np.ones((plen,), np.int32),
                                 min(n_new, self.max_new),
                                 time.perf_counter()) for i in range(A)]
                self._admit_group(list(range(A)), reqs)
                self.step()
                for s in range(A):
                    if self.slots[s] is not None:
                        f = self.slots[s]
                        f.n_new = f.n_gen  # force completion
                        self._finish(s)
        self._reset_state()
        self.done.clear()
        self.done_logprobs.clear()
        self.ttft.clear()
        self._occupancy.clear()
        # the counters measure steady state, not the warmup traffic
        self._bucket_hits = 0
        self._bucket_misses = 0
        self._replays = 0
        self._eager_decodes = 0
        self._clock.anchor()

    def stats(self) -> dict[str, Any]:
        return {
            "decode_traces": self._decode_traces,
            "decode": "cuda graph" if self._graph is not None else "eager",
            "decode_reason": self.decode_reason,
            "decode_replays": self._replays,
            "eager_decodes": self._eager_decodes,
            "admit_traces": {f"{a}x{lb}": 1 for a, lb in self._admit_shapes},
            "retire_traces": 1,
            "bucket_hits": self._bucket_hits,
            "bucket_misses": self._bucket_misses,
            "mean_occupancy": float(np.mean(self._occupancy))
            if self._occupancy else 0.0,
        }
