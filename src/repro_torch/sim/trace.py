"""Per-event traces and derived curves for the event-driven simulator.

A numpy-only copy of the reference's ``repro/sim/trace.py``: a trace saved
by either package loads in the other.

The engine records one :class:`TraceRecord` per processed event; this module
turns the flat record list into the artifacts the paper's Fig. 5 needs:

* ``completion_matrix`` — (M, K+1) per-worker round-completion times (the
  quantity the legacy ``straggler.simulate`` recursion produced);
* ``round_loss_curve``  — (times, losses): per-round mean train-batch loss
  against mean completion *virtual* time;
* ``eval_curve``        — (times, losses) of the global-loss evaluations the
  protocol recorded (loss of the worker-mean parameters).

Traces are JSON-serializable (``save``) so runs are diffable artifacts under
``results/``, and hashable (``signature``) for determinism tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np

# Event kinds (shared vocabulary between engine, protocols, and traces).
COMPUTE_DONE = "compute_done"
ARRIVAL = "arrival"
FAIL = "fail"
JOIN = "join"
SWITCH = "switch"
TIMEOUT = "timeout"        # barrier deadline fired (churn-capable sync/hier)
LINK_DOWN = "link_down"    # a link-class fault window opens (src = pod|-1)
LINK_UP = "link_up"        # the fault window closes


@dataclasses.dataclass(frozen=True)
class TraceRecord:
    seq: int            # global deterministic event sequence number
    t: float            # virtual time the event fired
    kind: str           # one of the kinds above
    worker: int         # affected / destination worker
    src: int = -1       # source worker (ARRIVAL only)
    round: int = 0      # iteration index the event concerns
    loss: float | None = None  # train-batch loss (COMPUTE_DONE w/ executor)
    link_class: str | None = None  # 'ici' | 'dci' (mesh-aware ARRIVAL only)
    nbytes: int = 0     # message payload bytes charged on that link
    wire_time: float = 0.0  # delay the link model charged for this message
    retried: bool = False  # ARRIVAL held by a dead link and re-delivered
                           # after recovery, or a COMPUTE_DONE attempt that
                           # the fault-injection hook failed (retried later)

    def as_tuple(self) -> tuple:
        """Schedule identity — deliberately EXCLUDES the link-class
        annotations, so a mesh-aware run with both classes at equal cost has
        the same :meth:`Trace.signature` as the meshless run it bit-matches."""
        return (self.seq, self.t, self.kind, self.worker, self.src,
                self.round, self.loss)

    def as_row(self) -> tuple:
        return self.as_tuple() + (self.link_class, self.nbytes,
                                  self.wire_time, int(self.retried))


@dataclasses.dataclass(frozen=True)
class EvalRecord:
    t: float            # virtual time of the evaluation
    round: int          # round index (sync) or completed-step count (async)
    value: float        # eval_fn(mean params over alive workers)


@dataclasses.dataclass(frozen=True)
class GaugeRecord:
    """A health-gauge sample on the virtual timeline (e.g. the spectral gap
    of the active mixing matrix after a churn repair). Gauges are telemetry
    ONLY: they are excluded from :meth:`Trace.signature`, so enabling them
    never perturbs determinism tests."""

    t: float            # virtual time the gauge was sampled
    name: str           # e.g. 'health.spectral_gap'
    value: float


class Trace:
    """Append-only event log plus protocol-recorded evaluation points."""

    def __init__(self, M: int):
        self.M = M
        self.records: list[TraceRecord] = []
        self.evals: list[EvalRecord] = []
        self.gauges: list[GaugeRecord] = []
        self.meta: dict[str, Any] = {}

    # -- recording --------------------------------------------------------

    def record(self, rec: TraceRecord) -> None:
        self.records.append(rec)

    def record_eval(self, t: float, rnd: int, value: float) -> None:
        self.evals.append(EvalRecord(t, rnd, value))

    def record_gauge(self, t: float, name: str, value: float) -> None:
        self.gauges.append(GaugeRecord(t, name, float(value)))

    def __len__(self) -> int:
        return len(self.records)

    # -- derived curves ---------------------------------------------------

    def dones(self) -> list[TraceRecord]:
        return [r for r in self.records if r.kind == COMPUTE_DONE]

    def completion_matrix(self, K: int | None = None) -> np.ndarray:
        """(M, K+1) completion time of round k per worker; t[:, 0] = 0.
        Missing (worker, round) cells — possible under churn or per-worker
        round counts — are NaN."""
        dones = self.dones()
        if K is None:
            K = max((r.round for r in dones), default=0)
        t = np.full((self.M, K + 1), np.nan)
        t[:, 0] = 0.0
        for r in dones:
            if 1 <= r.round <= K:
                t[r.worker, r.round] = r.t
        return t

    def rounds_completed(self) -> np.ndarray:
        """Per-worker highest completed round."""
        out = np.zeros(self.M, dtype=int)
        for r in self.dones():
            out[r.worker] = max(out[r.worker], r.round)
        return out

    def round_loss_curve(self) -> tuple[np.ndarray, np.ndarray]:
        """(times, losses): mean train-batch loss of round k vs mean
        completion time of round k, over workers that completed round k."""
        by_round: dict[int, list[tuple[float, float]]] = {}
        for r in self.dones():
            if r.loss is not None:
                by_round.setdefault(r.round, []).append((r.t, r.loss))
        ks = sorted(by_round)
        times = np.array([np.mean([t for t, _ in by_round[k]]) for k in ks])
        losses = np.array([np.mean([l for _, l in by_round[k]]) for k in ks])
        return times, losses

    def eval_curve(self) -> tuple[np.ndarray, np.ndarray]:
        ts = np.array([e.t for e in self.evals])
        vs = np.array([e.value for e in self.evals])
        return ts, vs

    def link_accounting(self) -> dict[str, dict[str, float]]:
        """Per-link-class totals over all delivered messages (mesh-aware
        runs): message count, total payload bytes shipped, total wire time
        the scenario's :class:`~repro_torch.sim.scenarios.LinkCost` charged, plus
        the fault-tolerance view — retried messages/bytes (deliveries held
        by a dead link until it recovered) and ``downtime`` (the *union* of
        that class's LINK_DOWN→LINK_UP windows per fault scope, open windows
        closed at the last trace time). Meshless runs (no class annotations)
        return an empty dict.

        Overlapping or adjacent fault windows on the same link — e.g. a
        pod-scoped dead window and a degraded window covering the same pod
        and class — are interval-unioned with a per-(class, scope) open-
        window depth counter, so the overlap is counted once. (The old FIFO
        start/stop pairing summed raw window lengths and double-counted
        every overlap.)"""
        out: dict[str, dict[str, float]] = {}

        def acc(cls: str) -> dict[str, float]:
            return out.setdefault(cls, {
                "messages": 0, "bytes": 0.0, "time": 0.0,
                "retried_messages": 0, "retried_bytes": 0.0,
                "downtime": 0.0})

        depth: dict[tuple[str, int], int] = {}
        since: dict[tuple[str, int], float] = {}
        t_last = self.records[-1].t if self.records else 0.0
        for r in self.records:
            if r.kind == LINK_DOWN and r.link_class is not None:
                key = (r.link_class, r.src)
                if depth.get(key, 0) == 0:
                    since[key] = r.t
                depth[key] = depth.get(key, 0) + 1
            elif r.kind == LINK_UP and r.link_class is not None:
                key = (r.link_class, r.src)
                d = depth.get(key, 0)
                if d == 1:
                    acc(r.link_class)["downtime"] += r.t - since.pop(key)
                if d > 0:
                    depth[key] = d - 1
            elif r.kind == ARRIVAL and r.link_class is not None:
                a = acc(r.link_class)
                a["messages"] += 1
                a["bytes"] += r.nbytes
                a["time"] += r.wire_time
                if r.retried:
                    a["retried_messages"] += 1
                    a["retried_bytes"] += r.nbytes
        for (cls, _), t0 in since.items():
            acc(cls)["downtime"] += t_last - t0
        return out

    # -- persistence / identity ------------------------------------------

    def signature(self) -> tuple:
        """Exact (float-preserving) fingerprint for determinism tests."""
        return tuple(r.as_tuple() for r in self.records)

    def to_json(self) -> dict:
        out = {
            "M": self.M,
            "meta": self.meta,
            "events": [r.as_row() for r in self.records],
            "evals": [[e.t, e.round, e.value] for e in self.evals],
        }
        acct = self.link_accounting()
        if acct:
            out["link_accounting"] = acct
        if self.gauges:    # key present only when health gauges were on
            out["gauges"] = [[g.t, g.name, g.value] for g in self.gauges]
        return out

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, default=float)
        return path

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            d = json.load(f)
        tr = cls(d["M"])
        tr.meta = d.get("meta", {})
        for row in d["events"]:
            # rows are 7-wide (pre-mesh), 10-wide (link-class cols), or
            # 11-wide (retried flag) — older traces stay loadable
            seq, t, kind, worker, src, rnd, loss = row[:7]
            cls_, nbytes, wire, retried = \
                (list(row[7:]) + [None, 0, 0.0, 0])[:4]
            tr.record(TraceRecord(seq, t, kind, worker, src, rnd, loss,
                                  link_class=cls_, nbytes=nbytes,
                                  wire_time=wire, retried=bool(retried)))
        for t, rnd, v in d.get("evals", []):
            tr.record_eval(t, rnd, v)
        for t, name, v in d.get("gauges", []):
            tr.record_gauge(t, name, v)
        return tr


def time_to_target(times: np.ndarray, losses: np.ndarray,
                   target: float) -> float:
    """First virtual time at which the loss curve dips below `target`
    (inf if never) — the paper's Fig. 5(c) reading."""
    hit = np.nonzero(np.asarray(losses) <= target)[0]
    return float(times[hit[0]]) if len(hit) else float("inf")
