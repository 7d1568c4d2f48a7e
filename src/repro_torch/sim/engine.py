"""Deterministic discrete-event scheduler for decentralized training.

A numpy-only copy of the reference's ``repro/sim/engine.py``; its health
gauges come from :mod:`repro_torch.telemetry.health`.

The engine owns *time*: a priority queue of events ordered by
``(virtual_time, insertion_seq)``, per-worker seeded RNG streams, node
liveness, and the current topology. A :class:`~repro_torch.sim.protocols.Protocol`
owns *values*: it reacts to events by scheduling computations, sending
messages, and (when an executor is attached) running real train steps.

Determinism guarantees
----------------------
* Ties in virtual time break by insertion order (a monotone sequence
  counter), which is itself a pure function of the event history.
* Every stochastic draw happens on a per-worker ``np.random.Generator``
  spawned from the scenario seed via ``SeedSequence.spawn``; worker j's
  durations / partner choices / outgoing-link delays are drawn from stream j
  in j's local event order, so they cannot be perturbed by how other
  workers' events interleave.
* ``FAIL``/``JOIN`` bump a per-worker *epoch*; in-flight events scheduled
  under an older epoch are silently dropped at pop time, making churn
  cancellation deterministic.

Together: same (scenario, protocol, seed) ⇒ identical event trace, identical
final parameters (``tests/test_sim_engine.py`` asserts both).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Any

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.sim import scenarios as scen_lib
from repro_torch.sim import trace as trace_lib
from repro_torch.sim.trace import (ARRIVAL, COMPUTE_DONE, FAIL, JOIN, LINK_DOWN,
                             LINK_UP, SWITCH, TIMEOUT)


@dataclasses.dataclass(frozen=True)
class Event:
    time: float
    seq: int
    kind: str
    worker: int          # affected / destination worker (-1 for SWITCH)
    src: int = -1        # source worker (ARRIVAL)
    round: int = 0       # iteration index the event concerns
    epoch: int = 0       # liveness epoch of `worker` at schedule time
    payload: Any = None  # protocol data (e.g. a params snapshot); not traced
    link_class: str | None = None  # 'ici'|'dci' (mesh-aware ARRIVAL)
    nbytes: int = 0      # payload bytes the link model charged
    wire_time: float = 0.0  # delay the link model charged
    retried: bool = False  # ARRIVAL delayed past a link-fault window


class Engine:
    """Event queue + virtual clocks; see module docstring.

    ``mesh`` (a :class:`~repro_torch.sim.scenarios.MeshSpec`, or a topology
    with pod metadata, which is mirrored into one) makes
    the engine *mesh-aware*: every gossip edge is classified intra-group
    (ICI) vs cross-group (DCI) — the partition ``core/topology.edge_classes``
    defines — and, when the scenario carries per-class
    :class:`~repro_torch.sim.scenarios.LinkCost` models, message delays charge that
    class's latency + payload/bandwidth using the mesh's per-device payload
    bytes (``BusLayout.padded_bytes``). Arrivals are annotated with
    (class, bytes, wire time) in the trace either way.
    """

    def __init__(self, topology: Topology, scenario: scen_lib.Scenario | None = None,
                 mesh: "scen_lib.MeshSpec | None" = None,
                 health: Any = None):
        self.topology = topology
        self.scenario = scenario or scen_lib.Scenario()
        self.M = topology.M
        self.mesh = scen_lib.MeshSpec.ensure(mesh, topology)
        if self.mesh is not None and self.mesh.M != self.M:
            raise ValueError(f"mesh covers {self.mesh.M} workers, "
                             f"topology has {self.M}")
        if self.scenario.link_classes is not None and self.mesh is None:
            raise ValueError(
                "scenario has per-class link costs but the engine got no "
                "mesh — pass a MeshSpec to classify edges")
        if self.scenario.link_classes is not None and \
                not self.mesh.payload_bytes and \
                any(np.isfinite(lc.bytes_per_time)
                    for lc in self.scenario.link_classes.values()):
            raise ValueError(
                "scenario charges payload/bandwidth but mesh.payload_bytes "
                "is 0 — build the MeshSpec with payload_bytes (e.g. "
                "MeshSpec(payload_bytes=...)) or go through "
                "run_simulated, which fills it from the bus layout plan")
        if self.scenario.has_link_faults and self.mesh is None:
            raise ValueError(
                "scenario has link faults but the engine got no mesh — "
                "pass a MeshSpec so edges have a link class")
        self.scenario.validate_for(
            self.M, None if self.mesh is None else self.mesh.n_groups)
        self._group = None if self.mesh is None else \
            np.asarray(self.mesh.group_of)
        self._active_faults: list[scen_lib.LinkFault] = []
        # gossip-health gauges (telemetry only — never perturbs the event
        # schedule): None/False = off, True = defaults, or a HealthConfig
        if health:
            from repro_torch.telemetry.health import HealthConfig
            self.health = health if isinstance(health, HealthConfig) \
                else HealthConfig()
        else:
            self.health = None
        self._health_mode = "reabsorb"
        self._health_hier = False
        ss = np.random.SeedSequence(self.scenario.seed)
        children = ss.spawn(self.M + 1)
        self.rngs = [np.random.default_rng(s) for s in children[: self.M]]
        self.rng_global = np.random.default_rng(children[self.M])
        self.clock = 0.0
        self.alive = np.ones(self.M, dtype=bool)
        self.epoch = np.zeros(self.M, dtype=int)
        self.trace = trace_lib.Trace(self.M)
        self._heap: list[tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._preload_environment_events()

    # -- scheduling -------------------------------------------------------

    def schedule(self, time: float, kind: str, worker: int, *, src: int = -1,
                 round: int = 0, payload: Any = None,
                 link_class: str | None = None, nbytes: int = 0,
                 wire_time: float = 0.0, retried: bool = False) -> Event:
        if time < self.clock:
            raise ValueError(f"cannot schedule into the past ({time} < {self.clock})")
        epoch = int(self.epoch[worker]) if worker >= 0 else 0
        ev = Event(time, next(self._seq), kind, worker, src=src, round=round,
                   epoch=epoch, payload=payload, link_class=link_class,
                   nbytes=nbytes, wire_time=wire_time, retried=retried)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def send(self, src: int, dst: int, *, round: int = 0,
             payload: Any = None) -> Event:
        """Ship one gossip message src→dst: draw the link delay (per-class
        on a mesh-aware engine) and schedule the ARRIVAL, annotated with the
        link class + payload bytes the cost model charged.

        Active link faults apply on top of the drawn delay: a DOWN window
        holds the message until the link recovers (delivery at
        ``recovery + delay``, marked ``retried``); degraded windows multiply
        the delay by their factor. The delay draw itself always happens at
        send time on the sender's stream, so fault windows shift deliveries
        without perturbing any worker's RNG sequence."""
        d = self.link_delay(src, dst)
        cls = self.link_class(src, dst)
        retried = False
        if self._active_faults:
            down_until = None
            for f in self._active_faults:
                if f.link_class != cls:
                    continue
                if f.pod is not None and self._group[src] != f.pod \
                        and self._group[dst] != f.pod:
                    continue
                if f.factor is None:
                    down_until = f.end if down_until is None \
                        else max(down_until, f.end)
                else:
                    d *= f.factor
            if down_until is not None and down_until > self.clock:
                retried = True
                t = down_until + d
            else:
                t = self.clock + d
        else:
            t = self.clock + d
        return self.schedule(
            t, ARRIVAL, dst, src=src, round=round,
            payload=payload, link_class=cls,
            nbytes=self.mesh.payload_for(cls) if self.mesh is not None else 0,
            wire_time=t - self.clock, retried=retried)

    def _preload_environment_events(self) -> None:
        for t, w, kind in self.scenario.churn:
            self.schedule(t, FAIL if kind == "fail" else JOIN, w)
        for t, topo in self.scenario.switches:
            if topo.M != self.M:
                raise ValueError("topology switch must preserve worker count")
            self.schedule(t, SWITCH, -1, payload=topo)
        for f in self.scenario.link_faults:
            # worker -1 (no epoch guard); src carries the pod scope (-1 = all)
            pod = -1 if f.pod is None else f.pod
            if f.start <= 0.0:
                # active from the first send (protocol.start() broadcasts
                # before the event loop pops anything at t=0)
                self._active_faults.append(f)
                self.schedule(0.0, LINK_DOWN, -1, src=pod, payload=None,
                              link_class=f.link_class)
            else:
                self.schedule(f.start, LINK_DOWN, -1, src=pod, payload=f,
                              link_class=f.link_class)
            self.schedule(f.end, LINK_UP, -1, src=pod, payload=f,
                          link_class=f.link_class)

    # -- stochastic draws (per-worker streams) ----------------------------

    def compute_duration(self, worker: int, round: int) -> float:
        d = float(self.scenario.compute(self.rngs[worker], worker, round))
        if not d > 0.0:
            raise ValueError(f"compute duration must be positive, got {d}")
        return d

    def link_class(self, src: int, dst: int) -> str | None:
        """'ici' (same group) | 'dci' (cross-group); None on meshless runs.

        Classification depends only on the worker→group assignment, so it is
        stable across topology SWITCHes (which edges exist changes; which
        *pairs* are cross-pod does not)."""
        if self._group is None:
            return None
        return scen_lib.DCI if self._group[src] != self._group[dst] \
            else scen_lib.ICI

    def link_delay(self, src: int, dst: int) -> float:
        classes = self.scenario.link_classes
        if classes is not None:
            cls = self.link_class(src, dst)
            # per-class payload: DCI edges charge the compressed wire bytes
            # when the mesh prices a compressed lane (dci_payload_bytes)
            d = float(classes[cls].delay(self.rngs[src],
                                         self.mesh.payload_for(cls)))
        else:
            d = float(self.scenario.link_delay(self.rngs[src], src, dst))
        if d < 0.0:
            raise ValueError(f"link delay must be >= 0, got {d}")
        return d

    def choose(self, worker: int, options: np.ndarray) -> int:
        """Uniform choice on the worker's own stream (e.g. gossip partner)."""
        return int(self.rngs[worker].choice(options))

    # -- health gauges ----------------------------------------------------

    def _blocked_edge(self, i: int, j: int) -> bool:
        """Is the i→j edge inside an open dead-link fault window right now?
        (Degraded — slow-but-alive — windows do not block the edge.)"""
        cls = self.link_class(i, j)
        for f in self._active_faults:
            if f.factor is not None or f.link_class != cls:
                continue
            if f.pod is not None and self._group[i] != f.pod \
                    and self._group[j] != f.pod:
                continue
            return True
        return False

    def _emit_health(self) -> None:
        """Sample the health gauges of the ACTIVE mixing matrix — the
        topology as currently switched, survivor-repaired for dead workers,
        and column-repaired for edges inside dead-link windows — onto the
        trace's virtual timeline. Called at t=0 and after every
        matrix-changing event when ``health`` is enabled."""
        from repro_torch.telemetry.health import active_matrix, health_gauges

        blocked = self._blocked_edge if any(
            f.factor is None for f in self._active_faults) else None
        A = active_matrix(self.topology, self.alive, blocked=blocked,
                          mode=self._health_mode, hier=self._health_hier)
        for name, v in health_gauges(A, self.health.gamma).items():
            self.trace.record_gauge(self.clock, f"health.{name}", v)

    # -- main loop --------------------------------------------------------

    def run(self, protocol, *, until_round: int | None = None,
            max_events: int | None = None,
            max_time: float | None = None) -> trace_lib.Trace:
        """Drain the event queue through `protocol`.

        until_round: protocols stop *scheduling* new computations past this
          round (the queue then drains naturally).
        max_events / max_time: hard stops for open-ended scenarios.
        """
        if self.scenario.has_churn and \
                not getattr(protocol, "supports_churn", False):
            raise NotImplementedError(
                f"protocol {getattr(protocol, 'name', type(protocol).__name__)} "
                "does not support churn in its current configuration — "
                "construct it with a barrier deadline "
                "(SyncGossip/HierGossip(barrier_timeout=...) or "
                "run_simulated(..., barrier_timeout=...)) to enable the "
                "timeout/degrade path, or use the async/stale protocols "
                "(churn-capable natively)")
        if self.scenario.has_switches and \
                not getattr(protocol, "supports_switches", False):
            raise NotImplementedError(
                f"protocol {getattr(protocol, 'name', type(protocol).__name__)} "
                "binds its neighbor lists at start and does not support "
                "topology-switch scenarios — use the async/stale protocols")
        protocol.bind(self, stop_round=until_round)
        if self.health is not None:
            # repair semantics follow the protocol actually running
            self._health_mode = getattr(protocol, "degrade_mode", None) \
                or self.health.mode
            self._health_hier = getattr(protocol, "name", "") == "hier"
            self._emit_health()     # t=0 baseline (pre-activated faults show)
        protocol.start()
        processed = 0
        while self._heap:
            if max_events is not None and processed >= max_events:
                break
            _, _, ev = heapq.heappop(self._heap)
            if max_time is not None and ev.time > max_time:
                break
            if ev.kind in (COMPUTE_DONE, ARRIVAL, TIMEOUT) and \
                    ev.epoch != self.epoch[ev.worker]:
                continue  # cancelled by a FAIL/JOIN since it was scheduled
            self.clock = ev.time
            if ev.kind == FAIL:
                self.alive[ev.worker] = False
                self.epoch[ev.worker] += 1
            elif ev.kind == JOIN:
                self.alive[ev.worker] = True
                self.epoch[ev.worker] += 1
            elif ev.kind == SWITCH:
                self.topology = ev.payload
            elif ev.kind == LINK_DOWN:
                if ev.payload is not None:  # t<=0 faults pre-activated
                    self._active_faults.append(ev.payload)
            elif ev.kind == LINK_UP:
                self._active_faults.remove(ev.payload)
            if self.health is not None and ev.kind in (
                    FAIL, JOIN, SWITCH, LINK_DOWN, LINK_UP):
                self._emit_health()
            if ev.kind == COMPUTE_DONE and \
                    getattr(protocol, "batch_commits", False):
                # hand the protocol the whole run of same-instant same-round
                # completions at once (it commits them through one vmapped
                # step); epoch-stale members are dropped exactly as the
                # sequential loop would, and per-event bookkeeping inside
                # handle_batch preserves heap order, so traces bit-match
                batch = [ev]
                while self._heap and (
                        max_events is None or
                        processed + len(batch) < max_events):
                    nxt = self._heap[0][2]
                    if nxt.time != ev.time or nxt.kind != COMPUTE_DONE or \
                            nxt.round != ev.round:
                        break
                    heapq.heappop(self._heap)
                    if nxt.epoch != self.epoch[nxt.worker]:
                        continue  # cancelled by churn — same as the solo path
                    batch.append(nxt)
                if len(batch) > 1:
                    infos = protocol.handle_batch(batch)
                    for bev, binfo in zip(batch, infos):
                        binfo = binfo or {}
                        if binfo.get("skip"):
                            continue
                        self.trace.record(trace_lib.TraceRecord(
                            seq=bev.seq, t=bev.time, kind=bev.kind,
                            worker=bev.worker, src=bev.src, round=bev.round,
                            loss=binfo.get("loss"),
                            link_class=bev.link_class, nbytes=bev.nbytes,
                            wire_time=bev.wire_time,
                            retried=bev.retried or bool(binfo.get("failed"))))
                        processed += 1
                    continue
            info = protocol.handle(ev) or {}
            if info.get("skip"):
                # a no-op event (e.g. a TIMEOUT whose barrier had already
                # completed) — not recorded, so fault-free traces keep their
                # pre-fault-tolerance signatures bit-identical
                continue
            self.trace.record(trace_lib.TraceRecord(
                seq=ev.seq, t=ev.time, kind=ev.kind, worker=ev.worker,
                src=ev.src, round=ev.round, loss=info.get("loss"),
                link_class=ev.link_class, nbytes=ev.nbytes,
                wire_time=ev.wire_time,
                retried=ev.retried or bool(info.get("failed"))))
            processed += 1
        self.trace.meta.update({
            "scenario": self.scenario.describe(),
            "topology": self.topology.name,
            "protocol": getattr(protocol, "name", type(protocol).__name__),
            "events": processed,
            "final_time": self.clock,
        })
        if self.mesh is not None:
            self.trace.meta["mesh"] = self.mesh.describe()
        return self.trace
