"""Composable scenario specs for the event-driven simulator.

A numpy-only copy of the reference's ``repro/sim/scenarios.py``; the
mirror of a device mesh (``WorkerMesh``) comes with the distributed slice
(ROADMAP queue 1, "Distributed"), so :meth:`MeshSpec.ensure` refuses one.

A :class:`Scenario` bundles everything *about the environment* (as opposed to
the algorithm) that shapes a simulated run:

* ``compute``      — per-worker computation-time model (straggler
                     distribution, heterogeneous speeds, or a pre-tabulated
                     time matrix);
* ``link_delay``   — per-message communication delay model (flat — every
                     link costs the same distribution);
* ``link_classes`` — mesh-aware alternative: one :class:`LinkCost`
                     (latency + bandwidth) per link class (``'ici'`` intra-
                     group, ``'dci'`` cross-group); requires the engine to be
                     given a :class:`MeshSpec`, which also supplies the
                     per-message payload bytes the bandwidth term charges;
* ``churn``        — node fail / join schedule;
* ``switches``     — topology switches at given virtual times;
* ``seed``         — master seed; the engine spawns one independent stream
                     per worker (``np.random.SeedSequence.spawn``) so event
                     interleaving never perturbs any worker's draw sequence.

The computation-time *distributions* (the paper's §4 / Fig. 10 shapes) live
here; ``repro_torch.core.straggler`` re-exports them for backward compatibility.

Callable conventions
--------------------
``TimeSampler(rng, shape) -> ndarray``          (unchanged legacy signature)
``ComputeModel(rng, worker, round) -> float``   (per-event duration draw)
``DelayModel(rng, src, dst) -> float``          (per-message delay draw)
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.topology import Topology

TimeSampler = Callable[[np.random.Generator, tuple[int, ...]], np.ndarray]
ComputeModel = Callable[[np.random.Generator, int, int], float]
DelayModel = Callable[[np.random.Generator, int, int], float]


# ---------------------------------------------------------------------------
# Computation-time distributions (paper §4, Fig. 10) — lifted from
# repro_torch.core.straggler, which re-exports them.
# ---------------------------------------------------------------------------


def deterministic(mean: float = 1.0) -> TimeSampler:
    return lambda rng, shape: np.full(shape, mean)


def uniform(low: float = 0.8, high: float = 1.2) -> TimeSampler:
    return lambda rng, shape: rng.uniform(low, high, shape)


def exponential(mean: float = 1.0) -> TimeSampler:
    return lambda rng, shape: rng.exponential(mean, shape)


def pareto(alpha: float = 2.5, xm: float = 0.6) -> TimeSampler:
    """Pareto with shape alpha, scale xm (heavy tail for alpha ≤ ~2.5)."""
    return lambda rng, shape: xm * (1.0 + rng.pareto(alpha, shape))


def spark_like(base: float = 1.0, jitter: float = 0.05,
               p_slow: float = 0.05, slow_factor: float = 4.0) -> TimeSampler:
    """Empirical shape of the paper's Spark-cluster CDF (Fig. 10a): tight body
    around the typical time + occasional multi-x slowdowns (GC, contention)."""

    def sample(rng: np.random.Generator, shape):
        t = base * rng.lognormal(0.0, jitter, shape)
        slow = rng.random(shape) < p_slow
        return np.where(slow, t * rng.uniform(2.0, slow_factor, shape), t)

    return sample


def asciq_like(base: float = 1.0) -> TimeSampler:
    """ASCI-Q-style (Fig. 10b): OS noise — frequent small interruptions plus
    rare long preemptions (heavier tail than spark_like)."""

    def sample(rng: np.random.Generator, shape):
        t = base * (1.0 + 0.02 * rng.standard_gamma(1.0, shape))
        slow = rng.random(shape) < 0.01
        return np.where(slow, t + base * rng.exponential(8.0, shape), t)

    return sample


DISTRIBUTIONS: dict[str, Callable[..., TimeSampler]] = {
    "deterministic": deterministic,
    "uniform": uniform,
    "exponential": exponential,
    "pareto": pareto,
    "spark": spark_like,
    "asciq": asciq_like,
}


# ---------------------------------------------------------------------------
# Compute models (per-event duration draws)
# ---------------------------------------------------------------------------


def sampled(sampler: TimeSampler, speed: np.ndarray | None = None) -> ComputeModel:
    """Draw each duration lazily from `sampler` on the worker's own stream.

    speed: optional per-worker multiplicative factors (persistent
      heterogeneity: speed[j] > 1 means worker j is systematically slower).
    """

    def duration(rng: np.random.Generator, worker: int, k: int) -> float:
        t = float(np.asarray(sampler(rng, ())))
        return t * float(speed[worker]) if speed is not None else t

    duration.describe = {"kind": "sampled",
                         "heterogeneous": speed is not None}
    return duration


def tabulated(T: np.ndarray) -> ComputeModel:
    """Durations from a pre-drawn (M, K) matrix: T[j, k-1] is worker j's
    round-k computation time. Reproduces the legacy straggler recursion's
    draw order exactly (one upfront ``sampler(rng, (M, K))``)."""
    T = np.asarray(T, dtype=np.float64)

    def duration(rng: np.random.Generator, worker: int, k: int) -> float:
        return float(T[worker, k - 1])

    duration.describe = {"kind": "tabulated", "shape": list(T.shape)}
    return duration


# ---------------------------------------------------------------------------
# Link-delay models
# ---------------------------------------------------------------------------


def no_delay() -> DelayModel:
    d = lambda rng, src, dst: 0.0
    d.describe = {"kind": "no_delay"}
    return d


def constant_delay(delay: float) -> DelayModel:
    d = lambda rng, src, dst: float(delay)
    d.describe = {"kind": "constant", "delay": delay}
    return d


def uniform_delay(low: float, high: float) -> DelayModel:
    d = lambda rng, src, dst: float(rng.uniform(low, high))
    d.describe = {"kind": "uniform", "low": low, "high": high}
    return d


def lognormal_delay(median: float, sigma: float = 0.5) -> DelayModel:
    """WAN-ish delays: median `median`, log-std `sigma` (occasional spikes)."""
    d = lambda rng, src, dst: float(median * rng.lognormal(0.0, sigma))
    d.describe = {"kind": "lognormal", "median": median, "sigma": sigma}
    return d


def per_link_delay(D: np.ndarray) -> DelayModel:
    """Deterministic per-link delays from a (M, M) matrix (e.g. rack/pod
    hierarchies: cheap intra-group links, expensive cross-group)."""
    D = np.asarray(D, dtype=np.float64)
    d = lambda rng, src, dst: float(D[src, dst])
    d.describe = {"kind": "per_link", "shape": list(D.shape)}
    return d


# ---------------------------------------------------------------------------
# Mesh mirror + per-link-class cost model (tentpole: two link classes)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LinkCost:
    """Cost of one message on one link class: latency + size/bandwidth.

    ``delay = latency + nbytes / bytes_per_time``, optionally multiplied by a
    ``jitter`` draw (a :data:`TimeSampler`, drawn on the *sender's* stream so
    determinism survives event interleaving). With ``jitter=None`` the cost
    is a pure function of the payload — the deterministic-times path the
    bit-match acceptance test pins down.
    """

    latency: float = 0.0
    bytes_per_time: float = float("inf")   # bandwidth (payload units / vtime)
    jitter: TimeSampler | None = None

    def delay(self, rng: np.random.Generator, nbytes: int) -> float:
        d = self.latency
        if nbytes and np.isfinite(self.bytes_per_time):
            d += nbytes / self.bytes_per_time
        if self.jitter is not None:
            d *= float(np.asarray(self.jitter(rng, ())))
        return d

    def describe(self) -> dict:
        return {"latency": self.latency,
                "bytes_per_time": self.bytes_per_time,
                "jitter": self.jitter is not None}


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Sim-only mirror of a device mesh of workers (the reference's
    ``WorkerMesh``).

    Carries exactly what the engine's link model needs: which pod/group each
    worker lives in (``group_of`` — intra-group edges are ICI class,
    cross-group DCI) and the per-device bytes one bulk gossip collective
    ships (``payload_bytes`` — `BusLayout.padded_bytes` of the layout-v2
    plan), so
    virtual time charges the real wire payloads.

    ``dci_payload_bytes`` prices the compressed cross-pod lane: when > 0,
    DCI-class messages are charged that many bytes instead of
    ``payload_bytes`` (``BusLayout.padded_bytes(wire_dtype)`` — the int8/bf16
    wire image of the same buffer). 0 keeps both classes at the exact
    payload, unchanged.
    """

    group_of: tuple[int, ...]
    payload_bytes: int = 0
    dci_payload_bytes: int = 0
    name: str = "mesh"

    def __post_init__(self):
        object.__setattr__(self, "group_of",
                           tuple(int(g) for g in self.group_of))

    @property
    def M(self) -> int:
        return len(self.group_of)

    @property
    def n_groups(self) -> int:
        return len(set(self.group_of))

    def payload_for(self, link_class: str) -> int:
        """Per-message bytes charged on ``link_class`` edges: the compressed
        DCI payload when one is set, the exact bus payload otherwise."""
        if link_class == DCI and self.dci_payload_bytes:
            return self.dci_payload_bytes
        return self.payload_bytes

    @classmethod
    def pods(cls, M: int, n_pods: int, *, payload_bytes: int = 0,
             dci_payload_bytes: int = 0) -> "MeshSpec":
        """M workers in n_pods equal contiguous pods (the multi-pod layout)."""
        if M % n_pods:
            raise ValueError(f"{M} workers do not split into {n_pods} pods")
        group = np.repeat(np.arange(n_pods), M // n_pods)
        return cls(group_of=tuple(group), payload_bytes=payload_bytes,
                   dci_payload_bytes=dci_payload_bytes,
                   name=f"pods-{n_pods}x{M // n_pods}")

    @classmethod
    def from_topology(cls, topo: Topology, *, payload_bytes: int = 0,
                      dci_payload_bytes: int = 0) -> "MeshSpec":
        """Adopt a hierarchical topology's own pod assignment (kronecker)."""
        if topo.group_of is None:
            raise ValueError(f"{topo.name} carries no group metadata")
        return cls(group_of=topo.group_of, payload_bytes=payload_bytes,
                   dci_payload_bytes=dci_payload_bytes,
                   name=f"mesh({topo.name})")

    @classmethod
    def ensure(cls, mesh, topology: Topology | None = None) -> "MeshSpec | None":
        """Normalize: a MeshSpec passes through, None stays None, and a
        topology that carries pod metadata (``group_of``) is adopted. Any
        other mesh (a device mesh of workers) raises: the port has no device
        mesh yet (ROADMAP queue 1, "Distributed")."""
        if mesh is None or isinstance(mesh, cls):
            return mesh
        if topology is not None and getattr(mesh, "group_of", None) is not None:
            return cls.from_topology(mesh)
        raise NotImplementedError(
            f"cannot build a MeshSpec from {type(mesh).__name__}: a device mesh of "
            "workers comes with the distributed slice (ROADMAP queue 1, "
            "\"Distributed\"); pass a MeshSpec, mesh='topology' or None")

    def describe(self) -> dict:
        out = {"name": self.name, "workers": self.M,
               "groups": self.n_groups, "payload_bytes": self.payload_bytes}
        if self.dci_payload_bytes:
            out["dci_payload_bytes"] = self.dci_payload_bytes
        return out


ICI = "ici"
DCI = "dci"


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """One link-fault window: a whole edge class (optionally scoped to the
    edges touching one pod) dies or degrades for ``duration`` virtual time.

    ``factor=None`` means the links are DOWN: messages sent into the window
    are held and delivered at ``recovery_time + delay`` (the engine marks
    them ``retried`` in the trace). A finite ``factor`` multiplies the link
    model's delay instead (degraded links). ``pod`` restricts the fault to
    edges with at least one endpoint in that mesh group (``None`` = the
    whole class) — the regional-outage shape."""

    start: float
    duration: float
    link_class: str = DCI
    factor: float | None = None
    pod: int | None = None

    def __post_init__(self):
        if self.start < 0:
            raise ValueError("link fault start must be >= 0")
        if not self.duration > 0:
            raise ValueError("link fault duration must be > 0")
        if self.link_class not in (ICI, DCI):
            raise ValueError(f"link_class must be {ICI!r}|{DCI!r}, "
                             f"got {self.link_class!r}")
        if self.factor is not None and not self.factor > 0:
            raise ValueError("degrade factor must be > 0 (None = link dead)")

    @property
    def end(self) -> float:
        return self.start + self.duration

    def describe(self) -> dict:
        return {"start": self.start, "duration": self.duration,
                "link_class": self.link_class, "factor": self.factor,
                "pod": self.pod}


def two_class_links(*, ici_latency: float = 0.0, dci_latency: float = 0.0,
                    ici_bw: float = float("inf"), dci_bw: float = float("inf"),
                    jitter: TimeSampler | None = None) -> dict[str, LinkCost]:
    """{'ici': …, 'dci': …} LinkCost pair (jitter shared, sender-stream)."""
    return {ICI: LinkCost(ici_latency, ici_bw, jitter),
            DCI: LinkCost(dci_latency, dci_bw, jitter)}


# ---------------------------------------------------------------------------
# Scenario spec
# ---------------------------------------------------------------------------


ChurnEvent = tuple[float, int, str]          # (time, worker, 'fail' | 'join')
TopologySwitch = tuple[float, Topology]      # (time, new_topology)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Environment spec for one simulated run (see module docstring)."""

    name: str = "ideal"
    compute: ComputeModel = dataclasses.field(
        default_factory=lambda: sampled(deterministic(1.0)))
    link_delay: DelayModel = dataclasses.field(default_factory=no_delay)
    link_classes: dict[str, LinkCost] | None = None
    churn: tuple[ChurnEvent, ...] = ()
    switches: tuple[TopologySwitch, ...] = ()
    link_faults: tuple[LinkFault, ...] = ()
    seed: int = 0

    def __post_init__(self):
        for t, w, kind in self.churn:
            if kind not in ("fail", "join"):
                raise ValueError(f"churn kind must be fail|join, got {kind!r}")
            if t < 0:
                raise ValueError("churn times must be >= 0")
            # worker ids are validated as far as a Scenario can (it does not
            # know M — validate_for(M) / the engine close that gap early)
            if not isinstance(w, (int, np.integer)) or isinstance(w, bool) \
                    or w < 0:
                raise ValueError(
                    f"churn worker id must be a non-negative int, got {w!r}")
        if self.link_classes is not None:
            missing = {ICI, DCI} - set(self.link_classes)
            if missing:
                raise ValueError(f"link_classes missing {sorted(missing)}")
        for f in self.link_faults:
            if not isinstance(f, LinkFault):
                raise ValueError(f"link_faults entries must be LinkFault, "
                                 f"got {type(f).__name__}")

    def validate_for(self, M: int, n_groups: int | None = None) -> None:
        """Range checks that need the fleet size: churn worker ids < M and
        fault pod ids < n_groups. The engine calls this at construction so a
        bad id fails loudly up front rather than deep inside the run."""
        for t, w, kind in self.churn:
            if w >= M:
                raise ValueError(
                    f"churn event ({t}, {w}, {kind!r}) names worker {w} "
                    f"but the topology has only {M} workers")
        for f in self.link_faults:
            if f.pod is not None and n_groups is not None \
                    and f.pod >= n_groups:
                raise ValueError(
                    f"link fault pod {f.pod} out of range — mesh has "
                    f"{n_groups} groups")

    @property
    def has_churn(self) -> bool:
        return bool(self.churn)

    @property
    def has_switches(self) -> bool:
        return bool(self.switches)

    @property
    def has_link_faults(self) -> bool:
        return bool(self.link_faults)

    def describe(self) -> dict:
        """JSON-able summary (the scenario 'schema' written into traces)."""
        out = {
            "name": self.name,
            "seed": self.seed,
            "compute": getattr(self.compute, "describe", {"kind": "custom"}),
            "link_delay": getattr(self.link_delay, "describe",
                                  {"kind": "custom"}),
            "churn": [[t, w, k] for t, w, k in self.churn],
            "switches": [[t, topo.name] for t, topo in self.switches],
        }
        if self.link_faults:
            out["link_faults"] = [f.describe() for f in self.link_faults]
        if self.link_classes is not None:
            out["link_classes"] = {c: lc.describe()
                                   for c, lc in sorted(self.link_classes.items())}
        return out


# ---------------------------------------------------------------------------
# Named scenarios (the building blocks the examples / benches compose)
# ---------------------------------------------------------------------------


def ideal(seed: int = 0) -> Scenario:
    """Deterministic unit compute times, zero delay — lockstep sanity world."""
    return Scenario(name="ideal", seed=seed)


def heavy_tail(dist: str = "spark", seed: int = 0, *,
               delay: float = 0.0, **dist_kw) -> Scenario:
    """The paper's Fig. 5 world: heavy-tail compute times, negligible
    communication. dist ∈ DISTRIBUTIONS (default the Spark-trace shape)."""
    return Scenario(
        name=f"heavy_tail-{dist}",
        compute=sampled(DISTRIBUTIONS[dist](**dist_kw)),
        link_delay=constant_delay(delay) if delay else no_delay(),
        seed=seed)


def wan(dist: str = "uniform", median_delay: float = 0.3,
        seed: int = 0) -> Scenario:
    """Geo-distributed links: modest compute noise, lognormal link delays."""
    return Scenario(
        name="wan",
        compute=sampled(DISTRIBUTIONS[dist]()),
        link_delay=lognormal_delay(median_delay),
        seed=seed)


def flaky_workers(M: int, *, fail_times: dict[int, float],
                  rejoin_after: float = 0.0, dist: str = "spark",
                  seed: int = 0) -> Scenario:
    """Node churn: worker j fails at fail_times[j]; rejoins rejoin_after
    later (0 = never rejoins)."""
    churn: list[ChurnEvent] = []
    for w, t in sorted(fail_times.items()):
        if not 0 <= w < M:
            raise ValueError(f"fail_times names worker {w}, fleet has {M}")
        churn.append((t, w, "fail"))
        if rejoin_after > 0:
            churn.append((t + rejoin_after, w, "join"))
    churn.sort(key=lambda e: e[0])
    return Scenario(
        name="flaky_workers",
        compute=sampled(DISTRIBUTIONS[dist]()),
        churn=tuple(churn),
        seed=seed)


def topology_schedule(switches: list[TopologySwitch], *, dist: str = "spark",
                      seed: int = 0) -> Scenario:
    """Switch the communication graph mid-run (e.g. densify as consensus
    error grows); supported by the async / stale protocols."""
    return Scenario(
        name="topology_schedule",
        compute=sampled(DISTRIBUTIONS[dist]()),
        switches=tuple(sorted(switches, key=lambda s: s[0])),
        seed=seed)


def datacenter(dist: str = "spark", *, ici_latency: float = 0.02,
               dci_latency: float = 2.0, ici_bw: float = float("inf"),
               dci_bw: float = float("inf"), seed: int = 0,
               **dist_kw) -> Scenario:
    """The two-link-class world the mesh-aware engine charges: cheap
    intra-pod ICI hops vs expensive cross-pod DCI hops (Nedić et al.'s
    comm/comp tradeoff with two classes). Needs a MeshSpec on the engine —
    this is the hier-vs-ring scenario of `examples/hier_wallclock.py`."""
    return Scenario(
        name=f"datacenter-{dist}",
        compute=sampled(DISTRIBUTIONS[dist](**dist_kw)),
        link_classes=two_class_links(ici_latency=ici_latency,
                                     dci_latency=dci_latency,
                                     ici_bw=ici_bw, dci_bw=dci_bw),
        seed=seed)


# ---------------------------------------------------------------------------
# The fleet-scale robustness book (ROADMAP: preemption waves, regional
# outages, elastic join) — churn + link-fault scenarios the fault-tolerant
# protocols (sync/hier with a barrier timeout, async/stale natively) survive.
# ---------------------------------------------------------------------------


def preemption_wave(M: int, *, start: float = 5.0, interval: float = 1.0,
                    count: int | None = None, down_for: float = 8.0,
                    dist: str = "spark", seed: int = 0) -> Scenario:
    """Spot-instance preemption wave: ``count`` workers (default M//4,
    evenly spread over the fleet) are killed one after another ``interval``
    apart from ``start``; each rejoins ``down_for`` later (0 = never)."""
    count = max(1, M // 4) if count is None else count
    if not 0 < count <= M:
        raise ValueError(f"wave of {count} preemptions on a fleet of {M}")
    stride = max(1, M // count)
    churn: list[ChurnEvent] = []
    for i in range(count):
        w = (i * stride) % M
        t = start + i * interval
        churn.append((t, w, "fail"))
        if down_for > 0:
            churn.append((t + down_for, w, "join"))
    churn.sort(key=lambda e: e[0])
    return Scenario(name=f"preemption_wave-{count}",
                    compute=sampled(DISTRIBUTIONS[dist]()),
                    churn=tuple(churn), seed=seed)


def regional_outage(*, pod: int, start: float, duration: float,
                    factor: float | None = None, dist: str = "spark",
                    ici_latency: float = 0.02, dci_latency: float = 2.0,
                    ici_bw: float = float("inf"), dci_bw: float = float("inf"),
                    seed: int = 0, **dist_kw) -> Scenario:
    """The :func:`datacenter` world with one pod's DCI links failed: every
    cross-pod message touching ``pod`` is held until ``start + duration``
    (``factor=None``) or slowed by ``factor`` (degraded region). Workers in
    the pod stay alive and keep mixing on their ICI links — exactly the
    regime hierarchical gossip is built to ride through."""
    base = datacenter(dist, ici_latency=ici_latency, dci_latency=dci_latency,
                      ici_bw=ici_bw, dci_bw=dci_bw, seed=seed, **dist_kw)
    fault = LinkFault(start=start, duration=duration, link_class=DCI,
                      factor=factor, pod=pod)
    kind = "degraded" if factor is not None else "outage"
    return dataclasses.replace(base, name=f"regional_{kind}-pod{pod}",
                               link_faults=(fault,))


def elastic(M: int, *, initial: int, start: float = 3.0,
            interval: float = 2.0, dist: str = "spark",
            seed: int = 0) -> Scenario:
    """Elastic scale-up past M₀: workers ``initial..M-1`` are absent from
    t=0 (failed before doing any work) and join staggered ``interval``
    apart from ``start`` — the fleet grows from ``initial`` to ``M``."""
    if not 0 < initial <= M:
        raise ValueError(f"initial fleet {initial} must be in 1..{M}")
    churn: list[ChurnEvent] = [(0.0, w, "fail") for w in range(initial, M)]
    churn += [(start + (w - initial) * interval, w, "join")
              for w in range(initial, M)]
    return Scenario(name=f"elastic-{initial}to{M}",
                    compute=sampled(DISTRIBUTIONS[dist]()),
                    churn=tuple(churn), seed=seed)
