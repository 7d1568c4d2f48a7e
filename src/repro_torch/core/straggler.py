"""Straggler / wall-clock timing model (paper §4, Fig. 5, App. G).

The paper's second claim: sparse topologies converge faster in *wall-clock*
time even with zero communication delay, because a transient straggler only
stalls its out-neighbors.  Model (synchronous local barrier):

    t_j(k+1) = max_{i ∈ N_j ∪ {j}} t_i(k) + T_j(k+1)

with T_j(k) the random computation time.  For the clique this degenerates to
the global barrier and throughput collapses to the slowest node each round.

A numpy-only copy of the reference's ``repro/core/straggler.py``: a thin
layer over the event-driven simulator (``repro_torch.sim``). The
computation-time distributions live in ``repro_torch.sim.scenarios``
(re-exported here), and :func:`simulate` runs the engine's
synchronous-gossip protocol in timing-only mode — the numbers of the
standalone barrier recursion, from one event model. For
simulations that execute *real* train steps (loss vs. virtual wall-clock,
async/stale protocols, churn), use ``repro_torch.train.loop.run_simulated``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from repro_torch.core.topology import Topology
from repro_torch.sim.scenarios import (  # noqa: F401  (re-exports, legacy API)
    DISTRIBUTIONS,
    TimeSampler,
    asciq_like,
    deterministic,
    exponential,
    pareto,
    spark_like,
    uniform,
)

__all__ = [
    "TimeSampler", "DISTRIBUTIONS", "deterministic", "uniform", "exponential",
    "pareto", "spark_like", "asciq_like", "SimResult", "simulate",
    "loss_vs_time", "throughput_by_degree",
]


@dataclasses.dataclass(frozen=True)
class SimResult:
    completion: np.ndarray  # (M, K+1) completion time of iteration k per node
    comm_delay: float

    @property
    def K(self) -> int:
        return self.completion.shape[1] - 1

    @property
    def avg_completion(self) -> np.ndarray:
        """Mean completion time per iteration (len K+1)."""
        return self.completion.mean(axis=0)

    @property
    def throughput(self) -> float:
        """Iterations per unit time at the end of the run (paper Fig. 5a)."""
        return self.K / float(self.completion[:, -1].mean())


def simulate(
    topology: Topology,
    K: int,
    sampler: TimeSampler,
    *,
    comm_delay: float = 0.0,
    seed: int = 0,
) -> SimResult:
    """Run the local-barrier time recursion for K iterations on the event
    engine (timing-only synchronous gossip — no parameter values).

    Computation times are pre-drawn exactly as the legacy recursion drew
    them (one ``sampler(rng, (M, K))`` on ``default_rng(seed)``), so results
    are bit-identical to the historical implementation.

    comm_delay: per-hop communication delay added to each neighbor wait (the
      paper's main experiments use 0 — "even when communication costs are
      negligible").
    """
    from repro_torch.sim import Engine, Scenario, SyncGossip, scenarios

    M = topology.M
    rng = np.random.default_rng(seed)
    T = np.asarray(sampler(rng, (M, K)), dtype=np.float64)
    scenario = Scenario(
        name="legacy-straggler",
        compute=scenarios.tabulated(T),
        link_delay=scenarios.constant_delay(comm_delay),
        seed=seed,
    )
    eng = Engine(topology, scenario)
    eng.run(SyncGossip(executor=None), until_round=K)
    completion = eng.trace.completion_matrix(K)
    assert not np.isnan(completion).any(), "sync run left incomplete rounds"
    return SimResult(completion=completion, comm_delay=comm_delay)


def loss_vs_time(
    loss_per_iteration: np.ndarray, sim: SimResult
) -> tuple[np.ndarray, np.ndarray]:
    """Combine a loss-vs-iteration curve with simulated wall-clock times
    (paper Fig. 5c): returns (times, losses) with times = mean completion."""
    K = min(len(loss_per_iteration), sim.K + 1)
    return sim.avg_completion[:K], np.asarray(loss_per_iteration)[:K]


def throughput_by_degree(
    make_topology: Callable[[int], Topology],
    degrees: list[int],
    K: int,
    sampler: TimeSampler,
    *,
    seed: int = 0,
    comm_delay: float = 0.0,
) -> dict[int, float]:
    """Paper Fig. 5(a): iterations/time as a function of connectivity d."""
    return {
        d: simulate(make_topology(d), K, sampler, seed=seed, comm_delay=comm_delay).throughput
        for d in degrees
    }
