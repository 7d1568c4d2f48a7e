"""Pluggable consensus protocols executed by the event engine.

The port of the reference's ``repro/sim/protocols.py``. All protocols speak
the same engine API (``bind`` / ``start`` / ``handle``) and drive *real*
train steps over a stacked parameter tree of tensors (leading worker dim M,
the same layout as ``repro_torch.core.decentralized``):

* :class:`SyncGossip` — the paper's synchronous local-barrier DSM: worker j
  starts round k+1 only once every in-neighbor's round-k estimate has
  arrived. Commits run a *per-slice* step (gradient at w_j(k−1) → full-M
  column mix over the round-(k−1) snapshot plane → update) that reproduces
  slice j of the full ``make_train_step`` program, so under deterministic
  compute times the trajectory matches ``train()`` at O(M) — not O(M²) —
  gradient cost per round. The trajectory of synchronous gossip is provably
  schedule-independent — only the *clock* feels the stragglers — which is
  exactly the paper's Fig. 5 argument.
* :class:`AsyncPairwise` — AD-PSGD-style (Lian et al., 2018): no barrier;
  each worker loops compute → apply update → average pairwise with one
  random out-neighbor (atomically, when the message lands). Gradients are
  taken at the parameters held when the computation *started* (the
  protocol's characteristic staleness).
* :class:`StaleGossip` — delayed gossip: worker j mixes whatever neighbor
  snapshots have *arrived* by its clock (weights renormalized over the
  available set), then broadcasts its new estimate.
* :class:`HierGossip` — two-level pod gossip (SGP-style overlap): exact
  local-barrier mixing with intra-pod neighbors over cheap ICI links,
  latest-arrived snapshots from cross-pod neighbors whose DCI messages stay
  in flight — the sim protocol of ``core/gossip.hierarchical_mix``.

``executor=None`` runs any protocol in timing-only mode (no values — the
``straggler.simulate`` fast path).

Fleet-scale commit architecture (sync / hier)
---------------------------------------------
Three structures keep per-round cost O(M):

* **Snapshot planes** (:class:`SnapPlanes`): broadcast estimates live as
  rows of a small ring of stacked (M, ...) buffers on the device — plane
  ``k % depth`` holds the round-k snapshots, written in place row by row.
  Because worker j's own row of plane k−1 is untouched between its
  round-(k−1) broadcast and its round-k commit, the *entire plane* is the
  mix source for a completed barrier: zero per-commit stack assembly (rows
  with zero consensus weight may hold other rounds; slice j of the einsum
  mix depends only on the nonzero-weight rows — they contribute ±0.0).
  Directed topologies can spread rounds wider than the ring; still-
  referenced rows about to be overwritten are spilled to a side dict and
  patched back in on the (rare) slow path.
* **Countdown barriers**: per-worker in-degree countdown arrays plus
  preallocated uint64 bitmask rows replace per-round dict-of-sets
  bookkeeping — O(1) per arrival, O(M/64) per commit, nothing grows with
  the round count.
* **Batched commits**: when several workers' barriers complete at the same
  virtual instant (the common case under deterministic compute times) the
  engine hands the whole run of COMPUTE_DONE events to
  :meth:`SyncGossip.handle_batch`, which commits them through ONE vmapped
  per-slice step (row gather → vmapped grad/update → full-M einsum mix
  against the plane, rows gathered → one in-place row write into the
  stacked state) — split into power-of-two buckets, as the reference does.
  Event bookkeeping (sends, barrier re-arms, trace records) still runs per
  event in heap order, so batched and unbatched runs produce identical
  traces.

The executor owns the stacked state (``W``, ``opt``) and the planes and
writes their rows in place (``index_copy_``), where the reference donates
buffers: a commit allocates no new stacked tensor. ``get_slice`` returns a
copy, so a saved slice never sees a later row write.

``commit='full'`` keeps the reference path — the full M-row
``make_train_step`` program per commit — for cross-checking, and is the
route by which ``GossipSpec(backend='fused')`` reaches the ``gossip_mix``
kernel. (``adafactor_like`` factors its second moment across the stacked
worker axis for originally-1D leaves, so its update is not
worker-elementwise — use ``commit='full'`` with it.)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import _tree
from repro_torch.convert import to_device
from repro_torch.core.decentralized import TrainState, make_train_step
from repro_torch.sim.trace import ARRIVAL, COMPUTE_DONE, FAIL, JOIN, TIMEOUT

PyTree = Any


def _popcount(row: np.ndarray) -> int:
    """Number of set bits in a uint64 bitmask row."""
    return int.from_bytes(row.tobytes(), "little").bit_count()


class BatchCache:
    """Random access over a sequential batch iterator, memoized by step.

    Workers at different rounds (async protocols) draw batch(k) out of
    order; the cache replays the iterator's deterministic sequence. Steps
    below the retirement watermark — the minimum outstanding round across
    live workers, advanced by the protocols after every commit — are
    dropped so long fleet-scale runs hold O(round spread) batches instead
    of O(total rounds); re-accessing a retired step raises.

    With ``device``, each batch (numpy arrays or tensors) is moved there
    once, when it is pulled from the iterator."""

    def __init__(self, batches, device: torch.device | None = None):
        self._it = iter(batches)
        self._device = device
        self._cache: dict[int, PyTree] = {}
        self._next = 0   # first step not yet pulled from the iterator
        self._floor = 0  # retirement watermark: steps < floor raise

    @property
    def floor(self) -> int:
        return self._floor

    def __len__(self) -> int:
        return len(self._cache)

    def get(self, k: int) -> PyTree:
        if k < self._floor:
            raise RuntimeError(
                f"batch {k} was retired (retirement watermark is "
                f"{self._floor}, so only steps >= {self._floor} are still "
                "cached): steps below the minimum outstanding round across "
                "live workers are dropped to bound memory. A protocol "
                "asking for a retired step is a round-bookkeeping bug — if "
                "you drive BatchCache directly, call retire_below only with "
                "floors no larger than the minimum round you will still "
                "request.")
        while self._next <= k:
            b = next(self._it)
            self._cache[self._next] = b if self._device is None \
                else to_device(b, self._device)
            self._next += 1
        return self._cache[k]

    def slice(self, k: int, j: int) -> PyTree:
        return _tree.map(lambda x: x[j], self.get(k))

    def retire_below(self, floor: int) -> None:
        """Drop every cached step < floor (monotone; lowering is a no-op)."""
        if floor <= self._floor:
            return
        for i in range(self._floor, min(floor, self._next)):
            self._cache.pop(i, None)
        self._floor = floor


def _coupled_opt_state(optimizer, params0: PyTree) -> bool:
    """Whether ``optimizer.init`` on the stacked (M, ...) params is NOT M
    independent copies of the per-slice state.

    Per-slice commits (``commit='slice'``) assume the stacked optimizer
    state is worker-elementwise — row j of ``init(W)`` equals ``init(W[j])``
    — so that slicing/updating one row reproduces the full program.
    Optimizers like ``adafactor_like`` break this: a per-worker 1-D leaf is
    2-D once stacked, so its second moment is row/col-factorized *across the
    worker axis*. Detected without allocating (tensors on the ``meta``
    device): the stacked init must have the per-slice init's tree structure
    with every leaf gaining exactly the leading (M,) dim."""
    M = _tree.leaves(params0)[0].shape[0]
    meta = lambda shape, dt: torch.empty(shape, dtype=dt, device="meta")
    try:
        stacked = optimizer.init(_tree.map(lambda x: meta(x.shape, x.dtype), params0))
        slice0 = optimizer.init(_tree.map(lambda x: meta(x.shape[1:], x.dtype), params0))
    except Exception:
        return False     # exotic init signature: keep the pre-check lenient

    def sig(tree, lead):
        ls, tdef = _tree.flatten(tree)
        return tdef, [(lead + tuple(l.shape), str(l.dtype)) for l in ls]

    return sig(stacked, ()) != sig(slice0, (M,))


def _device_matrix(A, device: torch.device) -> torch.Tensor:
    """An (M, M) float64 matrix (or column) on ``device``, copied once; each
    leaf casts it to its own dtype there, as the reference casts on use."""
    if isinstance(A, torch.Tensor):
        return A.to(device)
    t = torch.from_numpy(np.ascontiguousarray(A, dtype=np.float64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class _ByDtype:
    """A device matrix cast once per leaf dtype (one cast per commit and
    dtype group, not one host copy per leaf)."""

    def __init__(self, A: torch.Tensor):
        self._A = A
        self._cast: dict[torch.dtype, torch.Tensor] = {}

    def __call__(self, dtype: torch.dtype) -> torch.Tensor:
        a = self._cast.get(dtype)
        if a is None:
            a = self._cast[dtype] = self._A.to(dtype)
        return a


class TrainExecutor:
    """Stacked train state (``W``, ``opt``) + the per-slice / batched value ops.

    ``W`` and ``opt`` are the executor's own tensors (``params0`` is copied)
    and are written in place, row by row."""

    def __init__(self, loss_fn: Callable, optimizer, params0: PyTree,
                 batches, gossip, *, commit: str = "slice"):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.gossip = gossip
        self.M = gossip.topology.M
        leaves = _tree.leaves(params0)
        if not leaves or any(tuple(l.shape[:1]) != (self.M,) for l in leaves):
            raise ValueError(
                "params0 must be stacked with leading worker dim M "
                "(use repro_torch.core.decentralized.replicate_for_workers)")
        self.device = leaves[0].device
        # coupled = the optimizer's state on the stacked (M, ...) params is
        # NOT M independent per-slice states (e.g. adafactor_like row/col-
        # factors a stacked 1-D leaf across workers)
        self.coupled = _coupled_opt_state(optimizer, params0)
        if commit != "full" and self.coupled:
            raise ValueError(
                f"optimizer {getattr(optimizer, 'name', optimizer)!r} couples "
                "its state across the stacked worker axis (its init on the "
                "stacked (M, ...) params is not M independent copies of the "
                "per-slice state — e.g. adafactor_like row/col-factors a "
                "stacked 1-D leaf across workers), so per-slice commits "
                "would silently compute wrong second moments. Use "
                "commit='full' (the full M-row reference program) with this "
                "optimizer, or switch to a worker-elementwise optimizer.")
        self.W: PyTree = _tree.map(lambda x: x.detach().clone(), params0)
        self.opt: PyTree = optimizer.init(self.W)
        # coupled reference mode (commit='full'): optimizer state is worker-
        # LOCAL in a real decentralized run, so each worker carries its own
        # full-stack state; rows of a shared `opt` would be meaningless.
        self._opt_full: dict[int, PyTree] = {}
        self.batches = batches if isinstance(batches, BatchCache) \
            else BatchCache(batches, self.device)
        self._vg1 = torch.func.grad_and_value(loss_fn)
        self._vgJ = torch.func.vmap(self._vg1)
        self._lossJ = torch.func.vmap(loss_fn)
        self._step_fn = None
        self._step_fn_topo = None

    # -- slice ops --------------------------------------------------------

    def index(self, js) -> torch.Tensor:
        """Row indices as an int64 tensor on the state's device."""
        return torch.as_tensor(np.asarray(js, np.int64)).to(self.device)

    def get_slice(self, T: PyTree, j: int) -> PyTree:
        """Row j of every leaf, as a copy."""
        return _tree.map(lambda x: x[j].clone(), T)

    def set_slice_(self, T: PyTree, j: int, v: PyTree) -> PyTree:
        """Write ``v`` into row j of every leaf of T, in place; returns T."""
        with torch.no_grad():
            _tree.map(lambda x, y: x[j].copy_(y), T, v)
        return T

    def patched(self, T: PyTree, rows) -> PyTree:
        """A copy of T with the (i, slice) pairs of ``rows`` written in; T
        itself is untouched (the reference's non-donated row sets)."""
        rows = list(rows)
        if not rows:
            return T
        S = _tree.map(lambda x: x.clone(), T)
        for i, v in rows:
            self.set_slice_(S, i, v)
        return S

    def loss_and_grad(self, w: PyTree, batch: PyTree):
        g, l = self._vg1(w, batch)
        return l, g

    def local_loss(self, w: PyTree, batch: PyTree) -> float:
        """One slice's loss, evaluated as :meth:`commit_batch` evaluates a
        single worker: vmapped over the slice padded to two rows, so both
        commit modes record the same float (a batched product can round
        apart from an unbatched one)."""
        pair = lambda x: torch.stack([x, x])
        with torch.no_grad():
            return float(self._lossJ(_tree.map(pair, w), _tree.map(pair, batch))[0])

    def update_slice(self, g: PyTree, opt_j: PyTree, w: PyTree, step: int):
        with torch.no_grad():
            return self.optimizer.update(g, opt_j, w, step)

    def apply(self, w: PyTree, u: PyTree) -> PyTree:
        with torch.no_grad():
            return _tree.map(lambda a, b: a + b.to(a.dtype), w, u)

    def mix_column(self, S: PyTree, col) -> PyTree:
        """Σ_i col[i]·S[i] over the leading dim, col cast to each leaf's dtype."""
        a = _ByDtype(_device_matrix(col, self.device))
        with torch.no_grad():
            return _tree.map(lambda x: torch.tensordot(a(x.dtype), x, dims=([0], [0])), S)

    def pair_average(self, i: int, j: int) -> None:
        with torch.no_grad():
            for x in _tree.leaves(self.W):
                avg = x[i] / 2 + x[j] / 2
                x[i] = avg
                x[j] = avg

    def mean_params(self, mask: np.ndarray | None = None) -> PyTree:
        w = np.ones(self.M) if mask is None else mask.astype(np.float64)
        return self.mix_column(self.W, w / w.sum())

    # -- snapshot planes --------------------------------------------------

    def make_planes(self, depth: int) -> list[PyTree]:
        """Ring of `depth` stacked snapshot buffers; plane 0 is seeded with a
        copy of W (the shared round-0 broadcast)."""
        first = _tree.map(lambda x: x.clone(), self.W)
        return [first] + [_tree.map(torch.zeros_like, self.W)
                          for _ in range(depth - 1)]

    def write_row(self, plane: PyTree, j: int) -> PyTree:
        """Snapshot W[j] into plane row j (in place)."""
        with torch.no_grad():
            _tree.map(lambda d, s: d[j].copy_(s[j]), plane, self.W)
        return plane

    def write_rows(self, plane: PyTree, js: np.ndarray) -> PyTree:
        idx = self.index(js)
        with torch.no_grad():
            _tree.map(lambda d, s: d.index_copy_(0, idx, s.index_select(0, idx)),
                      plane, self.W)
        return plane

    # -- the batched per-slice commit -------------------------------------

    def commit_batch(self, js: np.ndarray, k: int, Amat,
                     source: PyTree) -> np.ndarray:
        """Commit workers `js`' round k through one vmapped per-slice step
        mixing over `source` with the (M, M) matrix `Amat`; returns their
        local losses.

        The reference's order: vmapped ``grad_and_value`` of the loss over
        the rows `js` (their params, optimizer state and batch rows), then
        ``optimizer.update``, then the FULL M-row einsum over `source` (the
        same contraction as the full program's mix) with rows `js` gathered,
        then the in-place write of the committed rows into W and opt. Callers
        bucket `js` into power-of-two sizes; a single worker is padded to
        ``[j, j]`` and writes one row, as the reference does (its J=1
        program would collapse the mix to a vector dot)."""
        js_arr = np.asarray(js)
        n = len(js_arr)
        gjs = np.array([js_arr[0], js_arr[0]]) if n == 1 else js_arr
        idx = self.index(gjs)
        A = _ByDtype(_device_matrix(Amat, self.device))
        ws = _tree.map(lambda x: x.index_select(0, idx), self.W)
        opts = _tree.map(lambda x: x.index_select(0, idx), self.opt)
        bjs = _tree.map(lambda x: x.index_select(0, idx), self.batches.get(k - 1))
        grads, losses = self._vgJ(ws, bjs)
        with torch.no_grad():
            updates, opts2 = self.optimizer.update(grads, opts, ws, k - 1)
            del grads
            mixed = _tree.map(
                lambda x: torch.einsum("im,i...->m...", A(x.dtype), x).index_select(0, idx),
                source)
            new_ws = _tree.map(lambda m, u: m + u.to(m.dtype), mixed, updates)
            del mixed, updates
            wjs = idx[:n]
            _tree.map(lambda x, v: x.index_copy_(0, wjs, v[:n]), self.W, new_ws)
            _tree.map(lambda x, v: x.index_copy_(0, wjs, v[:n]), self.opt, opts2)
        return losses[:n].detach().cpu().numpy().astype(np.float64)

    # -- the real synchronous train step (commit='full' reference) ---------

    def step_fn(self, topology=None):
        """The ``make_train_step`` program — the computation the
        non-simulated ``train()`` loop runs — on the executor's GossipSpec
        (``backend='fused'`` reaches the ``gossip_mix`` kernel)."""
        spec = self.gossip
        if topology is not None and topology is not spec.topology:
            spec = dataclasses.replace(spec, topology=topology)
        if self._step_fn is None or self._step_fn_topo is not spec.topology:
            self._step_fn = make_train_step(self.loss_fn, self.optimizer,
                                            gossip=spec, mode="gossip")
            self._step_fn_topo = spec.topology
        return self._step_fn


class SnapPlanes:
    """Round-tagged ring of stacked snapshot planes (see module docstring):
    plane ``k % depth`` row j holds worker j's round-k broadcast estimate,
    written in place row by row. ``tag[j, slot]``
    records which round a row currently holds; rows that are still
    referenced when their slot wraps around are spilled to a side dict and
    patched back in at mix time (rare — only directed topologies spread
    rounds past the ring depth)."""

    def __init__(self, ex: TrainExecutor, depth: int):
        self.ex = ex
        self.depth = depth
        self.planes = ex.make_planes(depth)
        self.tag = np.full((ex.M, depth), -1, dtype=np.int64)
        self.tag[:, 0] = 0  # plane 0 seeded with W — everyone's round 0
        # (worker, round) -> consumers that have not yet mixed the snapshot
        self.refs: dict[tuple[int, int], set[int]] = {}
        # (worker, round) -> snapshot evicted from its plane row while
        # still referenced (ring overrun on directed topologies)
        self.spill: dict[tuple[int, int], PyTree] = {}

    def publish(self, j: int, k: int, consumers) -> None:
        """Record W[j] as worker j's round-k estimate (row write + refs).
        Idempotent on the row: a batched pre-write leaves only the refs."""
        s = k % self.depth
        old = int(self.tag[j, s])
        if old != k:
            if old >= 0 and self.refs.get((j, old)):
                self.spill[(j, old)] = self.ex.get_slice(self.planes[s], j)
            self.planes[s] = self.ex.write_row(self.planes[s], j)
            self.tag[j, s] = k
        if consumers:
            self.refs[(j, k)] = set(consumers)

    def publish_rows(self, js: np.ndarray, k: int) -> None:
        """Batched row write for workers `js`' round-k estimates (no refs —
        the per-worker broadcast loop attaches them via :meth:`publish`)."""
        s = k % self.depth
        for j in js:
            old = int(self.tag[j, s])
            if old >= 0 and old != k and self.refs.get((int(j), old)):
                self.spill[(int(j), old)] = self.ex.get_slice(self.planes[s], j)
        self.planes[s] = self.ex.write_rows(self.planes[s], js)
        self.tag[js, s] = k

    def in_plane(self, i: int, r: int) -> bool:
        return self.tag[i, r % self.depth] == r

    def has(self, i: int, r: int) -> bool:
        return self.tag[i, r % self.depth] == r or (i, r) in self.spill

    def row(self, i: int, r: int) -> PyTree:
        if self.in_plane(i, r):
            return self.ex.get_slice(self.planes[r % self.depth], i)
        try:
            return self.spill[(i, r)]
        except KeyError:
            raise RuntimeError(self.overrun_message(i, r)) from None

    def overrun_message(self, i: int, r: int) -> str:
        """Actionable snap-ring overrun diagnostic for a missing row."""
        held = int(self.tag[i, r % self.depth])
        return (
            f"snapshot ring overrun: worker {i}'s round-{r} estimate is "
            f"gone — its plane slot now holds round {held} and the row was "
            f"not spilled (snap_depth={self.depth}). The topology spread "
            f"rounds more than snap_depth-1 apart before every consumer "
            f"mixed the snapshot; raise snap_depth (run_simulated(..., "
            f"snap_depth={self.depth * 2})) to widen the ring.")

    def source(self, r: int, fix_rows=()) -> PyTree:
        """The M-row mix source for round r: the plane itself on the fast
        path; with `fix_rows` ((i, snapshot) pairs: spilled or cross-pod
        stale rows) patched into a copy — the plane is never mutated."""
        return self.ex.patched(self.planes[r % self.depth], fix_rows)

    def release(self, i: int, r: int, consumer: int) -> None:
        refs = self.refs.get((i, r))
        if refs is None:
            return
        refs.discard(consumer)
        if not refs:
            del self.refs[(i, r)]
            self.spill.pop((i, r), None)

    def release_consumer(self, consumer: int) -> None:
        """Drop a dead worker's claims on every outstanding snapshot."""
        for (i, r) in list(self.refs):
            self.release(i, r, consumer)


class Protocol:
    """Engine-facing protocol interface; see module docstring."""

    name = "protocol"
    # engine hint: COMPUTE_DONE runs at equal (time, round) may be handed to
    # handle_batch as one group (SyncGossip turns this on when batching is
    # safe — executor attached, per-slice commits, no recovery manager)
    batch_commits = False

    def __init__(self, executor: TrainExecutor | None = None, *,
                 eval_fn: Callable[[PyTree], float] | None = None,
                 eval_every: int = 0):
        self.executor = executor
        self.eval_fn = eval_fn if executor is not None else None
        self.eval_every = eval_every
        self.engine = None
        self.stop_round: int | None = None
        self.rounds: np.ndarray | None = None
        # optional train/loop RecoveryPolicy manager (fault injection,
        # retry/backoff, checkpoint-backed restore) — wired by run_simulated
        self.recovery = None

    @property
    def supports_churn(self) -> bool:
        """Whether fail/join scenarios are runnable with the protocol's
        CURRENT configuration (a property, not a class constant — the
        barrier protocols derive it from their timeout knob)."""
        return False

    @property
    def supports_switches(self) -> bool:
        """Whether mid-run topology switches are supported (the barrier
        protocols bind their neighbor lists at start and are not)."""
        return False

    def bind(self, engine, stop_round: int | None = None) -> None:
        self.engine = engine
        self.stop_round = stop_round
        self.rounds = np.zeros(engine.M, dtype=int)
        # per-round eval accumulation: round -> [count, time_sum, param_sum]
        self._round_acc: dict[int, list] = {}

    def start(self) -> None:
        raise NotImplementedError

    def handle(self, ev) -> dict | None:
        raise NotImplementedError

    def handle_batch(self, evs) -> list[dict | None]:
        """Process a run of same-instant events (engine batching hook);
        the default is the sequential semantics, one by one."""
        return [self.handle(ev) for ev in evs]

    def _past_stop(self, k: int) -> bool:
        return self.stop_round is not None and k > self.stop_round

    def _maybe_fail_step(self, j: int, k: int) -> dict | None:
        """Fault-injection gate at a COMPUTE_DONE: asks the recovery manager
        whether worker j's round-k step attempt fails. On failure the retry
        is rescheduled after the policy's backoff (or the worker's state is
        restored from the last consensus checkpoint once retries exhaust —
        then the step proceeds) and the failed attempt is traced with the
        ``retried`` flag. Returns None to proceed with the commit."""
        if self.recovery is None or self.executor is None:
            return None
        delay = self.recovery.step_failure_delay(j, k)
        if delay is None:
            return None
        eng = self.engine
        eng.schedule(eng.clock + delay, COMPUTE_DONE, j, round=k)
        return {"failed": True}

    def _after_commit(self, j: int, k: int) -> None:
        if self.recovery is not None and self.executor is not None:
            self.recovery.after_commit(j, k)
        self._retire_batches()

    # whether a dead worker's outstanding round can be ignored by batch
    # retirement: barrier protocols fast-forward rejoiners to the live
    # fleet's round, so only live workers pin old batches; async/stale
    # rejoiners resume at their frozen round and keep their batches pinned
    retire_over_live_only = False

    def _retire_batches(self) -> None:
        """Advance the BatchCache watermark to the minimum outstanding round
        across workers that can still draw old steps — steps below it can
        never be requested again."""
        if self.executor is None:
            return
        alive = self.engine.alive
        if self.retire_over_live_only and alive.any():
            floor = int(self.rounds[alive].min())
        else:
            floor = int(self.rounds.min())
        self.executor.batches.retire_below(floor)

    def _accumulate_round_eval(self, j: int, k: int) -> None:
        """Round-synchronous eval (barrier protocols): once every worker
        still expected to reach round k has committed it, record
        eval_fn(mean of the contributors' params) at their mean commit
        clock. Dead workers don't gate the round, so the eval curve keeps
        flowing under churn; with a full live fleet the trigger coincides
        with the pre-churn "all M committed" condition (bit-identical).
        eval_every: 0 disables, n evaluates every n-th round."""
        if self.eval_fn is None or self.eval_every <= 0 or k % self.eval_every:
            return
        ex, eng = self.executor, self.engine
        acc = self._round_acc.setdefault(k, [0, 0.0, None])
        w_j = ex.get_slice(ex.W, j)
        acc[0] += 1
        acc[1] += eng.clock
        acc[2] = w_j if acc[2] is None else ex.apply(acc[2], w_j)
        pending = eng.alive & (self.rounds < k)
        pending[j] = False          # the caller is committing round k now
        if not pending.any():
            self._flush_round_eval(k)

    def _flush_round_eval(self, k: int) -> None:
        """Record the accumulated round-k eval (mean of contributors)."""
        acc = self._round_acc.pop(k, None)
        if not acc or acc[0] == 0:
            return
        n = acc[0]
        mean = _tree.map(lambda x: x / n, acc[2])
        self.engine.trace.record_eval(acc[1] / n, k,
                                      float(self.eval_fn(mean)))


# ---------------------------------------------------------------------------
# Shared machinery of the local-barrier protocols (sync / hier)
# ---------------------------------------------------------------------------


class _BarrierGossip(Protocol):
    """Countdown-array barrier bookkeeping, the snapshot-plane store, and
    the optional timeout/degrade path that makes a local barrier
    churn-capable.

    Commit modes: ``commit='slice'`` (default) runs the per-slice
    step per commit — O(M) gradient work per round — and, with
    ``commit_batch=True``, lets the engine batch same-instant completions
    through one vmapped step. ``commit='full'`` is the pre-refactor
    reference: the full M-row program (sync) / the W-based stack assembly
    (hier) per commit, kept for cross-checks.

    With ``barrier_timeout=None`` (the default) the barrier is strict —
    behaviour is bit-identical to the fault-oblivious protocol, and churn
    scenarios are rejected by the engine. With a deadline, a worker whose
    round-k barrier has not completed ``barrier_timeout`` after the worker
    became ready commits over the in-neighbor snapshots that *did* arrive,
    mixing with the survivor-repaired weight column
    (:func:`repro_torch.core.topology.survivor_column`, ``degrade_mode``
    ``'reabsorb'`` | ``'renormalize'``). Timeout timers are only armed when
    the scenario can actually stall a barrier (churn or link faults), so a
    fault-free run keeps its pre-fault-tolerance trace signature — seq
    numbers included — even when a deadline is configured."""

    def __init__(self, executor: TrainExecutor | None = None, *,
                 eval_fn: Callable[[PyTree], float] | None = None,
                 eval_every: int = 0,
                 barrier_timeout: float | None = None,
                 degrade_mode: str = "reabsorb",
                 commit: str = "slice",
                 commit_batch: bool = True,
                 snap_depth: int = 4):
        super().__init__(executor, eval_fn=eval_fn, eval_every=eval_every)
        if barrier_timeout is not None and not barrier_timeout > 0.0:
            raise ValueError(
                f"barrier_timeout must be positive, got {barrier_timeout}")
        if degrade_mode not in ("reabsorb", "renormalize"):
            raise ValueError(
                f"degrade_mode must be 'reabsorb' or 'renormalize', "
                f"got {degrade_mode!r}")
        if commit not in ("slice", "full"):
            raise ValueError(
                f"commit must be 'slice' or 'full', got {commit!r}")
        if snap_depth < 2:
            raise ValueError(
                f"snap_depth must be >= 2 (the round-k plane is written "
                f"while round k-1 is still the mix source), got {snap_depth}")
        self.barrier_timeout = barrier_timeout
        self.degrade_mode = degrade_mode
        self.commit_mode = commit
        self.commit_batching = commit_batch
        self.snap_depth = snap_depth

    retire_over_live_only = True  # rejoiners fast-forward past dead rounds

    @property
    def supports_churn(self) -> bool:
        return self.barrier_timeout is not None

    def bind(self, engine, stop_round=None):
        super().bind(engine, stop_round)
        M = engine.M
        self._A = np.asarray(engine.topology.A, dtype=np.float64)
        if self.executor is not None:
            # transferred once, reused by every complete commit
            self._A_dev = _device_matrix(self._A, self.executor.device)
        # barrier state for round rounds[j] (the one gating round rounds[j]+1):
        # missing-arrival countdown + arrived-source bitmask row
        self._cnt = np.zeros(M, dtype=np.int64)
        self._mask = np.zeros((M, (M + 63) // 64), dtype=np.uint64)
        # arrivals for rounds ahead of the barrier (directed-topology spread):
        # (worker, round) -> uint64 bitmask row
        self._future: dict[tuple[int, int], np.ndarray] = {}
        # monotone per-worker round markers replacing the old (j, k) sets —
        # a worker only ever starts/arms/degrades round rounds[j]+1
        self._started_r = np.zeros(M, dtype=np.int64)
        self._degraded_r = np.full(M, -1, dtype=np.int64)
        self._armed_r = np.full(M, -1, dtype=np.int64)
        self._bcast_r = np.full(M, -1, dtype=np.int64)
        self._snaps = SnapPlanes(self.executor, self.snap_depth) \
            if self.executor is not None else None
        scen = engine.scenario
        self._timeouts_active = self.barrier_timeout is not None and \
            (scen.has_churn or scen.has_link_faults)

    # -- countdown / bitmask barrier --------------------------------------

    def _note_arrival(self, j: int, src: int, r: int) -> None:
        """O(1) arrival bookkeeping: decrement the countdown for the current
        barrier round, or park the bit for a future round."""
        base = int(self.rounds[j])
        w, b = src >> 6, np.uint64(1 << (src & 63))
        if r == base:
            if not (self._mask[j, w] & b):
                self._mask[j, w] |= b
                self._cnt[j] -= 1
        elif r > base:
            m = self._future.get((j, r))
            if m is None:
                m = self._future[(j, r)] = np.zeros(self._mask.shape[1],
                                                    dtype=np.uint64)
            m[w] |= b
        # r < base: late arrival for a committed round (timeout/rejoin) — drop

    def _arrived_bit(self, j: int, i: int) -> bool:
        return bool(self._mask[j, i >> 6] & np.uint64(1 << (i & 63)))

    def _advance(self, j: int, k: int) -> None:
        """Commit bookkeeping: worker j finished round k — rotate its
        barrier state to round k (promoting any parked future arrivals)."""
        self.rounds[j] = k
        m = self._future.pop((j, k), None)
        if m is None:
            self._mask[j, :] = 0
            self._cnt[j] = self._in_deg[j]
        else:
            self._mask[j] = m
            self._cnt[j] = self._in_deg[j] - _popcount(m)
        self._degraded_r[j] = -1

    def _barrier_met(self, j: int) -> bool:
        return self._cnt[j] == 0

    # -- timeout / degrade ------------------------------------------------

    def _arm_timeout(self, j: int, k: int) -> None:
        """Arm the round-k barrier deadline for worker j (no-op when
        timeouts are inactive, the round already started, or past stop)."""
        if not self._timeouts_active or self._past_stop(k) or \
                self._started_r[j] >= k or self._armed_r[j] == k:
            return
        eng = self.engine
        eng.schedule(eng.clock + self.barrier_timeout, TIMEOUT, j, round=k)
        self._armed_r[j] = k

    def _handle_timeout(self, j: int, k: int) -> dict | None:
        """Barrier deadline fired: if worker j is still waiting to start
        round k, start the compute in *degraded* mode (commit will mix over
        whatever snapshots arrived). Deadlines that were overtaken by the
        barrier completing are skipped without being traced."""
        if self._armed_r[j] == k:
            self._armed_r[j] = -1
        eng = self.engine
        if self._past_stop(k) or self._started_r[j] >= k or \
                self.rounds[j] != k - 1 or not eng.alive[j]:
            return {"skip": True}
        self._degraded_r[j] = k
        eng.schedule(eng.clock + eng.compute_duration(j, k), COMPUTE_DONE, j,
                     round=k)
        self._started_r[j] = k
        return None

    # -- churn ------------------------------------------------------------

    def _handle_fail(self, f: int) -> None:
        """Worker f died: cancel its barrier bookkeeping and release its
        claims on neighbor snapshots (it will never consume them). Its own
        already-broadcast snapshots stay — surviving consumers still mix
        them. Round-eval accumulators f was the last holdout of are
        flushed so the eval curve keeps flowing."""
        self._started_r[f] = self.rounds[f]
        self._degraded_r[f] = -1
        self._armed_r[f] = -1
        if self._snaps is not None:
            self._snaps.release_consumer(f)
        for k in sorted(self._round_acc):
            pending = self.engine.alive & (self.rounds < k)
            if not pending.any():
                self._flush_round_eval(k)

    def _handle_join(self, j: int) -> None:
        """Worker j rejoined: fast-forward it to the live fleet's furthest
        round (its parameters are restored from the last consensus
        checkpoint by the recovery manager, when one is attached), announce
        its estimate to its out-neighbors, and rejoin the barrier."""
        r = int(self.rounds[j])
        alive = self.engine.alive
        if alive.any():
            r = max(r, int(self.rounds[alive].max()))
        for key in [key for key in self._future
                    if key[0] == j and key[1] < r]:
            del self._future[key]
        if r != int(self.rounds[j]):
            # fast-forward rotates the barrier to round r (promoting parked
            # arrivals); when j is already at the live fleet's round, its
            # current barrier state — arrivals landed while down — stays
            self._advance(j, r)
        if self.recovery is not None and self.executor is not None:
            self.recovery.on_rejoin(j)
        self._broadcast(j, r)          # idempotent via the _bcast_r guard
        self._maybe_start(j, r + 1)
        self._arm_timeout(j, r + 1)


# ---------------------------------------------------------------------------
# Synchronous local-barrier gossip (the paper's DSM)
# ---------------------------------------------------------------------------


class SyncGossip(_BarrierGossip):
    """w_j(k+1) = Σ_i A_ij w_i(k) − η g_j(w_j(k)); round k+1 starts at
    max_{i∈N_j∪{j}} t_i(k) (+ link delay) — the paper's time recursion.

    Each completion runs a *per-slice* step: gradient at w_j(k−1), full-M
    column mix over the round-(k−1) snapshot plane, one-row commit — O(M)
    gradient work per round, reproducing slice j of the full
    ``make_train_step`` program (slice j of the vmapped/einsum step depends
    only on the rows with nonzero consensus weight). Same-instant
    completions are additionally batched through ONE vmapped per-slice step
    by the engine (see :meth:`handle_batch`); ``commit='full'`` opts back
    into the O(M²) full-program reference path.
    Timing-only mode (``executor=None``) skips all value work.

    ``barrier_timeout`` (see :class:`_BarrierGossip`) makes the barrier
    churn-capable: a timed-out round commits over the arrived snapshots
    with the survivor-repaired column of A."""

    name = "sync"

    def bind(self, engine, stop_round=None):
        super().bind(engine, stop_round)
        topo = engine.topology
        self._in_arr = [np.asarray(sorted(map(int, topo.neighbors_in(j))),
                                   dtype=np.int64) for j in range(engine.M)]
        self._out_nb = [list(map(int, topo.neighbors_out(j)))
                        for j in range(engine.M)]
        self._in_deg = np.array([len(a) for a in self._in_arr], dtype=np.int64)
        self._cnt = self._in_deg.copy()  # round-0 barrier: everything missing
        self.batch_commits = (self.executor is not None
                              and self.commit_mode == "slice"
                              and self.commit_batching
                              and self.recovery is None)

    def start(self):
        for j in range(self.engine.M):
            self._broadcast(j, 0)
        for j in range(self.engine.M):
            self._maybe_start(j, 1)  # covers in-degree-0 nodes
        for j in range(self.engine.M):
            self._arm_timeout(j, 1)

    def handle(self, ev):
        if ev.kind == ARRIVAL:
            self._note_arrival(ev.worker, ev.src, ev.round)
            self._maybe_start(ev.worker, ev.round + 1)
            return None
        if ev.kind == COMPUTE_DONE:
            return self._complete(ev.worker, ev.round)
        if ev.kind == TIMEOUT:
            return self._handle_timeout(ev.worker, ev.round)
        if ev.kind == FAIL:
            self._handle_fail(ev.worker)
        elif ev.kind == JOIN:
            self._handle_join(ev.worker)
        return None

    def _broadcast(self, j: int, k: int) -> None:
        eng = self.engine
        if self._past_stop(k + 1):
            return  # nobody will consume round-k estimates past the stop
        if k <= self._bcast_r[j]:
            return  # a rejoin re-announce raced a normal broadcast
        self._bcast_r[j] = k
        if self._snaps is not None:
            self._snaps.publish(j, k, self._out_nb[j])
        for o in self._out_nb[j]:
            eng.send(j, o, round=k)

    def _maybe_start(self, j: int, k: int) -> None:
        if self._past_stop(k) or self.rounds[j] != k - 1 or \
                self._started_r[j] >= k or self._cnt[j] != 0:
            return
        eng = self.engine
        eng.schedule(eng.clock + eng.compute_duration(j, k), COMPUTE_DONE, j,
                     round=k)
        self._started_r[j] = k

    def _complete(self, j: int, k: int) -> dict:
        failed = self._maybe_fail_step(j, k)
        if failed is not None:
            return failed
        loss = self._commit(j, k) if self.executor is not None else None
        self._advance(j, k)
        self._broadcast(j, k)
        self._maybe_start(j, k + 1)
        self._arm_timeout(j, k + 1)
        self._after_commit(j, k)
        return {"loss": loss}

    # -- batched commits ---------------------------------------------------

    def handle_batch(self, evs) -> list[dict | None]:
        """Commit a same-instant run of COMPUTE_DONE events through one
        vmapped per-slice step. Only completed barriers whose snapshots are
        all plane-resident ride the vmapped path; stragglers of the batch
        (degraded commits, ring-spilled snapshots) fall back to the
        sequential handler. All event bookkeeping — sends, barrier re-arms,
        eval accumulation — still runs per event in heap order, so the
        trace is bit-identical to an unbatched run."""
        k = evs[0].round
        store = self._snaps
        slot = (k - 1) % store.depth
        fast = [idx for idx, ev in enumerate(evs)
                if self._cnt[ev.worker] == 0 and
                bool(np.all(store.tag[self._in_arr[ev.worker], slot] == k - 1))]
        if len(fast) < 2:
            return [self.handle(ev) for ev in evs]
        fastset = set(fast)
        js = np.array([evs[idx].worker for idx in fast], dtype=np.int64)
        losses = self._commit_many(js, k)
        infos: list[dict | None] = [None] * len(evs)
        li = 0
        for idx, ev in enumerate(evs):
            if idx not in fastset:
                infos[idx] = self.handle(ev)
                continue
            j = ev.worker
            for i in self._in_arr[j]:
                store.release(int(i), k - 1, j)
            self._accumulate_round_eval(j, k)
            self._advance(j, k)
            self._broadcast(j, k)
            self._maybe_start(j, k + 1)
            self._arm_timeout(j, k + 1)
            self._after_commit(j, k)
            infos[idx] = {"loss": float(losses[li])}
            li += 1
        return infos

    def _commit_many(self, js: np.ndarray, k: int) -> np.ndarray:
        """Value work for a batch of completed round-k barriers: power-of-
        two-bucketed vmapped per-slice steps against the round-(k-1) plane,
        then one batched plane write publishing the new round-k rows (the
        per-worker broadcast loop attaches refs and sends afterwards)."""
        ex, store = self.executor, self._snaps
        source = store.planes[(k - 1) % store.depth]
        losses = np.empty(len(js), dtype=np.float64)
        off = 0
        while off < len(js):
            n = 1 << ((len(js) - off).bit_length() - 1)
            sub = js[off:off + n]
            losses[off:off + n] = ex.commit_batch(sub, k, self._A_dev, source)
            off += n
        if not self._past_stop(k + 1):
            off = 0
            while off < len(js):
                n = 1 << ((len(js) - off).bit_length() - 1)
                store.publish_rows(js[off:off + n], k)
                off += n
        return losses

    # -- single commits ----------------------------------------------------

    def _commit(self, j: int, k: int) -> float:
        """Run the round-k value step for worker j and commit its slice.

        Per-slice (default): the J=1 case of the batched step
        (:meth:`TrainExecutor.commit_batch`) — gradient at w_j(k-1) →
        update → full-M einsum mix over the round-(k-1) snapshot plane
        (spilled rows patched in), the full program's order of operations.
        Degraded (a timeout fired with snapshots missing): the same step
        with the survivor-repaired column over the snapshots that did
        arrive — shared by both commit modes. commit='full' runs the full
        M-row ``make_train_step`` program on completed barriers."""
        from repro_torch.core.topology import survivor_column

        ex, eng = self.executor, self.engine
        store = self._snaps
        in_nb = self._in_arr[j]
        complete = self._cnt[j] == 0 and \
            all(store.has(int(i), k - 1) for i in in_nb)
        if self.commit_mode == "full" and complete:
            return self._commit_full(j, k)
        if complete:
            fix = [(int(i), store.spill[(int(i), k - 1)]) for i in in_nb
                   if not store.in_plane(int(i), k - 1)]
            Amat = self._A_dev
        else:
            keep = np.ones(eng.M, dtype=bool)
            fix = []
            for i in map(int, in_nb):
                if self._arrived_bit(j, i) and store.has(i, k - 1):
                    if not store.in_plane(i, k - 1):
                        fix.append((i, store.spill[(i, k - 1)]))
                else:
                    keep[i] = False
            # only column j of the mix output is committed, so repairing
            # j's column of the full matrix is all the degradation needs
            Amat = self._A.copy()
            Amat[:, j] = survivor_column(self._A[:, j].copy(), j, keep,
                                         self.degrade_mode)
        S = store.source(k - 1, fix)
        losses = ex.commit_batch(np.array([j]), k, Amat, S)
        for i in in_nb:
            store.release(int(i), k - 1, j)
        self._accumulate_round_eval(j, k)
        return float(losses[0])

    def _assemble_from_W(self, j: int, k: int, fix_missing: bool) -> PyTree:
        """commit='full' degraded source: the pre-refactor W-based stack
        (current W with the *arrived* round-(k-1) snapshots patched in)."""
        ex, store = self.executor, self._snaps
        return ex.patched(ex.W, [
            (i, store.row(i, k - 1)) for i in map(int, self._in_arr[j])
            if not fix_missing or (self._arrived_bit(j, i) and store.has(i, k - 1))])

    def _commit_full(self, j: int, k: int) -> float:
        """Reference commit: assemble the round-(k-1) estimate stack as seen
        by worker j (its own current slice + the in-neighbor snapshots) and
        run the exact full M-row ``make_train_step`` program, committing one
        row — O(M²) row-gradients per round. Rows with zero consensus
        weight may be mid-round; they contribute ±0.0."""
        ex, store = self.executor, self._snaps
        S = self._assemble_from_W(j, k, fix_missing=False)
        if ex.coupled:
            # worker j owns a FULL optimizer state of its own: committing
            # "row j" of cross-worker-factorized state (adafactor row/col
            # moments) would splice together different workers' statistics.
            opt_prev = ex._opt_full.get(j, ex.opt)
            state = TrainState(k - 1, S, opt_prev)
            new_state, _ = ex.step_fn()(state, ex.batches.get(k - 1))
            ex._opt_full[j] = new_state.opt_state
            ex.W = ex.set_slice_(ex.W, j, _tree.map(lambda x: x[j], new_state.params))
        else:
            state = TrainState(k - 1, S, ex.opt)
            new_state, _ = ex.step_fn()(state, ex.batches.get(k - 1))
            ex.W = ex.set_slice_(ex.W, j, _tree.map(lambda x: x[j], new_state.params))
            ex.opt = ex.set_slice_(ex.opt, j, _tree.map(lambda x: x[j], new_state.opt_state))
        del state, new_state
        loss = ex.local_loss(ex.get_slice(S, j), ex.batches.slice(k - 1, j))
        for i in self._in_arr[j]:
            store.release(int(i), k - 1, j)
        self._accumulate_round_eval(j, k)
        return loss


# ---------------------------------------------------------------------------
# AD-PSGD-style asynchronous pairwise averaging
# ---------------------------------------------------------------------------


class AsyncPairwise(Protocol):
    """No barrier: compute → apply local update → atomically average with one
    random out-neighbor when the message lands; compute overlaps the
    in-flight averaging (gradients are stale by one communication)."""

    name = "async"

    @property
    def supports_churn(self) -> bool:
        return True

    @property
    def supports_switches(self) -> bool:
        return True

    def bind(self, engine, stop_round=None):
        super().bind(engine, stop_round)
        self._pending: dict[int, PyTree | None] = {}
        self._done_count = 0

    def start(self):
        for j in range(self.engine.M):
            if self.engine.alive[j]:
                self._begin(j)

    def handle(self, ev):
        if ev.kind == COMPUTE_DONE:
            return self._complete(ev.worker, ev.round)
        if ev.kind == ARRIVAL:
            i, j = ev.src, ev.worker
            if self.executor is not None and self.engine.alive[i] and \
                    self.engine.alive[j]:
                self.executor.pair_average(i, j)
            return None
        if ev.kind == JOIN:
            if self.recovery is not None and self.executor is not None:
                self.recovery.on_rejoin(ev.worker)
            self._begin(ev.worker)
        elif ev.kind == FAIL:
            self._pending.pop(ev.worker, None)
        return None

    def _begin(self, j: int) -> None:
        k = int(self.rounds[j]) + 1
        if self._past_stop(k):
            return
        if self.executor is not None:
            self._pending[j] = self.executor.get_slice(self.executor.W, j)
        eng = self.engine
        eng.schedule(eng.clock + eng.compute_duration(j, k), COMPUTE_DONE, j,
                     round=k)

    def _complete(self, j: int, k: int) -> dict:
        failed = self._maybe_fail_step(j, k)
        if failed is not None:
            return failed  # _pending[j] survives for the retried attempt
        eng, ex = self.engine, self.executor
        loss = None
        if ex is not None:
            w_start = self._pending.pop(j)
            l, g = ex.loss_and_grad(w_start, ex.batches.slice(k - 1, j))
            u, opt_j = ex.update_slice(g, ex.get_slice(ex.opt, j), w_start, k - 1)
            ex.W = ex.set_slice_(ex.W, j, ex.apply(ex.get_slice(ex.W, j), u))
            ex.opt = ex.set_slice_(ex.opt, j, opt_j)
            loss = float(l)
        self.rounds[j] = k
        nbrs = [o for o in map(int, eng.topology.neighbors_out(j)) if eng.alive[o]]
        if nbrs:
            partner = eng.choose(j, np.asarray(nbrs))
            eng.send(j, partner, round=k)
        self._begin(j)
        self._periodic_eval()
        self._after_commit(j, k)
        return {"loss": loss}

    def _periodic_eval(self) -> None:
        self._done_count += 1
        if self.eval_fn is None or self.eval_every <= 0 or \
                self._done_count % self.eval_every:
            return
        eng, ex = self.engine, self.executor
        mean = ex.mean_params(np.asarray(eng.alive))
        eng.trace.record_eval(eng.clock, self._done_count,
                              float(self.eval_fn(mean)))


# ---------------------------------------------------------------------------
# Stale / delayed gossip
# ---------------------------------------------------------------------------


class StaleGossip(Protocol):
    """Worker j mixes the *latest arrived* snapshot of each in-neighbor
    (weights renormalized over whatever is available), applies its update,
    broadcasts, and immediately starts the next round — no barrier."""

    name = "stale"

    @property
    def supports_churn(self) -> bool:
        return True

    @property
    def supports_switches(self) -> bool:
        return True

    def bind(self, engine, stop_round=None):
        super().bind(engine, stop_round)
        self._pending: dict[int, PyTree | None] = {}
        self._buf: dict[tuple[int, int], tuple[int, PyTree]] = {}
        self._done_count = 0

    def start(self):
        eng, ex = self.engine, self.executor
        if ex is not None:
            # everyone knows the (shared) round-0 initialization
            for j in range(eng.M):
                for i in map(int, eng.topology.neighbors_in(j)):
                    self._buf[(j, i)] = (0, ex.get_slice(ex.W, i))
        for j in range(eng.M):
            if eng.alive[j]:
                self._begin(j)

    def handle(self, ev):
        if ev.kind == COMPUTE_DONE:
            return self._complete(ev.worker, ev.round)
        if ev.kind == ARRIVAL:
            key = (ev.worker, ev.src)
            if self.engine.alive[ev.worker] and ev.payload is not None:
                cur = self._buf.get(key)
                if cur is None or ev.round > cur[0]:
                    self._buf[key] = (ev.round, ev.payload)
            return None
        if ev.kind == JOIN:
            if self.recovery is not None and self.executor is not None:
                self.recovery.on_rejoin(ev.worker)
            self._begin(ev.worker)
        elif ev.kind == FAIL:
            self._pending.pop(ev.worker, None)
        return None

    def _begin(self, j: int) -> None:
        k = int(self.rounds[j]) + 1
        if self._past_stop(k):
            return
        if self.executor is not None:
            self._pending[j] = self.executor.get_slice(self.executor.W, j)
        eng = self.engine
        eng.schedule(eng.clock + eng.compute_duration(j, k), COMPUTE_DONE, j,
                     round=k)

    def _complete(self, j: int, k: int) -> dict:
        failed = self._maybe_fail_step(j, k)
        if failed is not None:
            return failed  # _pending[j] survives for the retried attempt
        eng, ex = self.engine, self.executor
        loss = None
        snapshot = None
        if ex is not None:
            w_start = self._pending.pop(j)
            l, g = ex.loss_and_grad(w_start, ex.batches.slice(k - 1, j))
            u, opt_j = ex.update_slice(g, ex.get_slice(ex.opt, j), w_start, k - 1)
            # mix over {j} ∪ {arrived *live* in-neighbors}, renormalized —
            # a dead neighbor's last snapshot is dropped, its weight
            # redistributed by the renormalization
            col = np.array(eng.topology.A[:, j])
            fix = []
            for i in map(int, eng.topology.neighbors_in(j)):
                got = self._buf.get((j, i))
                if got is None or not eng.alive[i]:
                    col[i] = 0.0
                else:
                    fix.append((i, got[1]))
            mixed = ex.mix_column(ex.patched(ex.W, fix), col / col.sum())
            snapshot = ex.apply(mixed, u)
            ex.W = ex.set_slice_(ex.W, j, snapshot)
            ex.opt = ex.set_slice_(ex.opt, j, opt_j)
            loss = float(l)
        self.rounds[j] = k
        for o in map(int, eng.topology.neighbors_out(j)):
            if eng.alive[o]:
                eng.send(j, o, round=k, payload=snapshot)
        self._begin(j)
        self._periodic_eval()
        self._after_commit(j, k)
        return {"loss": loss}

    def _periodic_eval(self) -> None:
        self._done_count += 1
        if self.eval_fn is None or self.eval_every <= 0 or \
                self._done_count % self.eval_every:
            return
        eng, ex = self.engine, self.executor
        mean = ex.mean_params(np.asarray(eng.alive))
        eng.trace.record_eval(eng.clock, self._done_count,
                              float(self.eval_fn(mean)))


# ---------------------------------------------------------------------------
# Hierarchical gossip: intra-pod barrier, cross-pod snapshots in flight
# ---------------------------------------------------------------------------


class HierGossip(_BarrierGossip):
    """SGP-style two-level gossip (the sim rendering of
    ``core/gossip.hierarchical_mix`` on a pod/DCI mesh, after Assran et al.):
    worker j's round-k barrier covers only its *intra-pod* in-neighbors
    (cheap ICI links — exact round-(k-1) estimates), while *cross-pod*
    in-neighbors contribute their latest **arrived** snapshot, so the
    expensive DCI messages stay in flight while the pod keeps mixing. The
    consensus weights are the exact column of A (cross-pod buffers are
    seeded with the shared round-0 initialization, so every entry is always
    available); staleness of the DCI terms is the only approximation —
    with zero DCI penalty the trajectory collapses to the paper's DSM.

    Commits are per-slice: with ``commit='slice'`` (default) the mix source
    is the round-(k-1) snapshot plane with only the (few) cross-pod stale
    rows patched in; ``commit='full'`` keeps the pre-refactor reference
    assembly (current W with every neighbor row patched in — O(deg·M)
    copies per commit).

    Needs pod metadata: a mesh-aware engine (MeshSpec group_of) or a
    :func:`~repro_torch.core.topology.kronecker`/``hier`` topology.

    ``barrier_timeout`` (see :class:`_BarrierGossip`) makes the *intra-pod*
    barrier churn-capable; a timed-out or neighbor-dead round mixes with
    the survivor-repaired column (dead cross-pod in-neighbors' stale
    buffers are dropped and their weight reabsorbed too).

    ``dci_dtype`` ('bfloat16' | 'int8') turns on the compressed DCI lane:
    cross-pod snapshots are quantized through the bus wire format
    (``repro_torch.core.bus.quantize_wire``) with CHOCO-style error feedback — a
    per-sender fp32 residual accumulates what quantization dropped and is
    added back before the next quantize, so the consensus mean is preserved
    in expectation. The *sent* payload is the dequantized image (exactly
    what a receiver reconstructs from the wire), so trace values match the
    compressed wire bit for bit while intra-pod mixing stays exact. With
    ``dci_dtype=None`` every new branch is skipped — traces and
    trajectories are bit-identical to the pre-compression protocol."""

    name = "hier"

    def __init__(self, executor: TrainExecutor | None = None, *,
                 dci_dtype: str | None = None, **kw):
        super().__init__(executor, **kw)
        if dci_dtype is not None:
            from repro_torch.core import bus

            # eagerly validate the wire name (raises on unknown dtypes)
            bus.wire_dtype_for(torch.float32, dci_dtype)
        self.dci_dtype = dci_dtype
        # per-sender error-feedback residual trees (fp32, snapshot-shaped)
        self._ef: dict[int, PyTree] = {}

    def bind(self, engine, stop_round=None):
        super().bind(engine, stop_round)
        groups = engine.mesh.group_of if engine.mesh is not None \
            else engine.topology.group_of
        if groups is None:
            raise ValueError(
                "hier protocol needs pod metadata — run on a mesh-aware "
                "engine or a kronecker/hier topology with group_of")
        g = np.asarray(groups)
        topo = engine.topology
        self._g = g
        self._in_intra, self._in_inter = [], []
        self._out_intra, self._out_inter = [], []
        for j in range(engine.M):
            ins = list(map(int, topo.neighbors_in(j)))
            outs = list(map(int, topo.neighbors_out(j)))
            self._in_intra.append(np.asarray(
                sorted(i for i in ins if g[i] == g[j]), dtype=np.int64))
            self._in_inter.append([i for i in ins if g[i] != g[j]])
            self._out_intra.append([o for o in outs if g[o] == g[j]])
            self._out_inter.append([o for o in outs if g[o] != g[j]])
        self._in_deg = np.array([len(a) for a in self._in_intra],
                                dtype=np.int64)
        self._cnt = self._in_deg.copy()
        # (dst, src) -> (round, snapshot): latest-arrived cross-pod estimate
        # (bounded: one live entry per cross-pod edge, refreshed in place)
        self._stale: dict[tuple[int, int], tuple[int, PyTree]] = {}

    def start(self):
        eng, ex = self.engine, self.executor
        if ex is not None:
            # the shared round-0 initialization seeds every cross-pod buffer
            for j in range(eng.M):
                for i in self._in_inter[j]:
                    self._stale[(j, i)] = (0, ex.get_slice(ex.W, i))
        if self.dci_dtype is not None and eng.mesh is not None and \
                eng.mesh.payload_bytes and eng.mesh.dci_payload_bytes:
            eng.trace.record_gauge(
                0.0, "hier.dci_bytes_ratio",
                eng.mesh.payload_bytes / eng.mesh.dci_payload_bytes)
        for j in range(eng.M):
            self._broadcast(j, 0)
        for j in range(eng.M):
            self._maybe_start(j, 1)
        for j in range(eng.M):
            self._arm_timeout(j, 1)

    def handle(self, ev):
        if ev.kind == ARRIVAL:
            j, i = ev.worker, ev.src
            if self._g[i] == self._g[j]:       # ICI: barrier bookkeeping
                self._note_arrival(j, i, ev.round)
                self._maybe_start(j, ev.round + 1)
            elif ev.payload is not None:       # DCI: refresh the stale buffer
                cur = self._stale.get((j, i))
                if cur is None or ev.round > cur[0]:
                    self._stale[(j, i)] = (ev.round, ev.payload)
            return None
        if ev.kind == COMPUTE_DONE:
            return self._complete(ev.worker, ev.round)
        if ev.kind == TIMEOUT:
            return self._handle_timeout(ev.worker, ev.round)
        if ev.kind == FAIL:
            self._handle_fail(ev.worker)
        elif ev.kind == JOIN:
            self._handle_join(ev.worker)
        return None

    def _broadcast(self, j: int, k: int) -> None:
        eng, ex = self.engine, self.executor
        if self._past_stop(k + 1):
            return
        if k <= self._bcast_r[j]:
            return  # a rejoin re-announce raced a normal broadcast
        self._bcast_r[j] = k
        snap = None
        if ex is not None:
            self._snaps.publish(j, k, self._out_intra[j])
            if self._out_inter[j]:
                snap = ex.get_slice(ex.W, j)
                if self.dci_dtype is not None:
                    snap = self._compress_snap(j, snap)
        for o in self._out_intra[j]:
            eng.send(j, o, round=k)
        for o in self._out_inter[j]:
            eng.send(j, o, round=k, payload=snap)

    def _compress_snap(self, j: int, snap: PyTree) -> PyTree:
        """Quantize worker j's cross-pod snapshot through the bus wire
        format with error feedback: xe = x + residual is quantized, the
        *dequantized* image is what every receiver mixes, and the new
        residual xe − deq carries the dropped mass into the next round.
        Non-compressible leaves (ints, already-narrow floats) pass through
        exactly with a zero residual."""
        from repro_torch.core import bus

        leaves, tdef = _tree.flatten(snap)
        res = self._ef.get(j)
        rs = [torch.zeros(x.shape, dtype=torch.float32, device=x.device) for x in leaves] \
            if res is None else _tree.flatten_up_to(tdef, res)
        outs, news, sq = [], [], 0.0
        for x, r in zip(leaves, rs):
            wt = bus.wire_dtype_for(x.dtype, self.dci_dtype)
            if wt is None:
                outs.append(x)
                news.append(r)
                continue
            xe = x.float() + r
            payload, scale = bus.quantize_wire(xe, self.dci_dtype)
            deq = bus.dequantize_wire(payload, scale, x.dtype)
            new_r = xe - deq.float()
            outs.append(deq)
            news.append(new_r)
            sq += float(torch.sum(new_r * new_r))
        self._ef[j] = _tree.unflatten(tdef, news)
        eng = self.engine
        eng.trace.record_gauge(eng.clock, "hier.dci_ef_residual_norm",
                               float(np.sqrt(sq)))
        return _tree.unflatten(tdef, outs)

    def _maybe_start(self, j: int, k: int) -> None:
        if self._past_stop(k) or self.rounds[j] != k - 1 or \
                self._started_r[j] >= k or self._cnt[j] != 0:
            return
        eng = self.engine
        eng.schedule(eng.clock + eng.compute_duration(j, k), COMPUTE_DONE, j,
                     round=k)
        self._started_r[j] = k

    def _complete(self, j: int, k: int) -> dict:
        failed = self._maybe_fail_step(j, k)
        if failed is not None:
            return failed
        eng, ex = self.engine, self.executor
        loss = None
        if ex is not None:
            from repro_torch.core.topology import survivor_column

            store = self._snaps
            # j's own row is untouched since round k started: w_j(k-1)
            w_start = ex.get_slice(ex.W, j)
            l, grad = ex.loss_and_grad(w_start, ex.batches.slice(k - 1, j))
            u, opt_j = ex.update_slice(grad, ex.get_slice(ex.opt, j),
                                       w_start, k - 1)
            keep = np.ones(eng.M, dtype=bool)
            fix = []   # rows the plane does not already hold for round k-1
            for i in map(int, self._in_intra[j]):
                if self._arrived_bit(j, i) and store.has(i, k - 1):
                    if not store.in_plane(i, k - 1):
                        fix.append((i, store.spill[(i, k - 1)]))
                else:
                    keep[i] = False      # degraded: snapshot never arrived
            for i in self._in_inter[j]:
                got = self._stale.get((j, i))
                if got is None or not eng.alive[i]:
                    keep[i] = False      # dead pod: drop its stale estimate
                else:
                    fix.append((i, got[1]))
            col = self._A[:, j]
            if not keep.all():
                col = survivor_column(col.copy(), j, keep, self.degrade_mode)
            if self.commit_mode == "slice":
                S = store.source(k - 1, fix)
            else:
                # reference assembly: current W with every usable neighbor
                # row patched in (the pre-refactor path)
                S = ex.patched(ex.W, fix + [
                    (i, store.row(i, k - 1)) for i in map(int, self._in_intra[j])
                    if keep[i] and store.in_plane(i, k - 1)])
            mixed = ex.mix_column(S, col)   # exact weights, stale DCI values
            ex.W = ex.set_slice_(ex.W, j, ex.apply(mixed, u))
            ex.opt = ex.set_slice_(ex.opt, j, opt_j)
            for i in self._in_intra[j]:
                store.release(int(i), k - 1, j)
            loss = float(l)
        self._advance(j, k)
        self._broadcast(j, k)
        self._maybe_start(j, k + 1)
        self._arm_timeout(j, k + 1)
        if ex is not None:
            self._accumulate_round_eval(j, k)
        self._after_commit(j, k)
        return {"loss": loss}


PROTOCOLS: dict[str, type[Protocol]] = {
    "sync": SyncGossip,
    "async": AsyncPairwise,
    "stale": StaleGossip,
    "hier": HierGossip,
}
