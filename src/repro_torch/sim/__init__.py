"""Event-driven wall-clock simulator: real training under virtual clocks.

The port of the reference's ``repro/sim``. The paper's Fig. 5 claim —
sparse topologies win in *wall-clock* time — is a statement about
schedules, not values. A deterministic discrete-event
:class:`~repro_torch.sim.engine.Engine` advances per-worker virtual clocks
while pluggable :mod:`~repro_torch.sim.protocols` (synchronous
local-barrier gossip, AD-PSGD-style asynchronous pairwise averaging,
stale/delayed gossip, and hierarchical pod gossip) execute *real* train
steps on the port's tensors, so loss-vs-virtual-time curves come from
actual optimization, under composable :mod:`~repro_torch.sim.scenarios`
(straggler distributions, link delays, node churn, topology switches). A
mesh-aware engine (pass a :class:`~repro_torch.sim.scenarios.MeshSpec`, or
``mesh='topology'`` to :func:`~repro_torch.train.loop.run_simulated`)
classifies every gossip edge intra-group (ICI) vs cross-group (DCI) and
charges per-class latency/bandwidth against the per-worker payload the
gossip bus ships (``BusLayout.padded_bytes``), and runs link-level fault
windows (:class:`~repro_torch.sim.scenarios.LinkFault`). The barrier
protocols become churn-capable with a ``barrier_timeout``
(survivor-renormalized degraded commits); scenario constructors
``preemption_wave`` / ``regional_outage`` / ``elastic`` package the
robustness worlds. ``run_simulated(mesh=WorkerMesh)`` takes a worker mesh
(abstract or live) as well: its pod axis gives the worker groups and the
bus layout plan over the params the per-message payload bytes.

Entry points: ``repro_torch.train.loop.run_simulated`` (one call) or
the Engine/Protocol API directly. ``repro_torch.core.straggler.simulate`` is
a timing-only wrapper over this engine.
"""
from repro_torch.sim import engine, protocols, scenarios, trace
from repro_torch.sim.engine import Engine, Event
from repro_torch.sim.protocols import (
    PROTOCOLS,
    AsyncPairwise,
    BatchCache,
    HierGossip,
    StaleGossip,
    SyncGossip,
    TrainExecutor,
)
from repro_torch.sim.scenarios import (
    DISTRIBUTIONS,
    LinkCost,
    LinkFault,
    MeshSpec,
    Scenario,
    elastic,
    preemption_wave,
    regional_outage,
)
from repro_torch.sim.trace import Trace, TraceRecord, time_to_target

__all__ = [
    "engine", "protocols", "scenarios", "trace",
    "Engine", "Event", "Trace", "TraceRecord", "time_to_target",
    "Scenario", "DISTRIBUTIONS", "PROTOCOLS", "LinkCost", "LinkFault",
    "MeshSpec", "preemption_wave", "regional_outage", "elastic",
    "SyncGossip", "AsyncPairwise", "StaleGossip", "HierGossip",
    "TrainExecutor", "BatchCache",
]
