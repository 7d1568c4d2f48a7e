"""Sparse topologies win in wall-clock (paper Fig. 5) with zero
communication delay, from straggler mitigation alone.

Real training on the event-driven simulator (:mod:`repro_torch.sim`): each
degree trains the same problem under per-worker virtual clocks drawn from
the Spark-like heavy-tail distribution, so the loss and the time axis come
from one simulated run.

    python -m repro_torch.examples.straggler_wallclock [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

from repro_torch import problems, resolve_device, telemetry
from repro_torch.core import topology as T
from repro_torch.examples import RESULTS
from repro_torch.sim import scenarios, time_to_target

M_WORKERS = 16
DEGREES = [2, 4, 8, 15]


def topo(d, M=M_WORKERS):
    return T.clique(M) if d >= M - 1 else (
        T.undirected_ring(M) if d == 2 else T.ring_lattice(M, d))


def simulate_degree(problem, d, *, steps, device, M=M_WORKERS):
    return problems.run_sim(problem, topo(d, M), rounds=steps, lr=0.5, protocol="sync",
                            scenario=scenarios.heavy_tail("spark", seed=7), device=device)


def run(quick: bool = False, *, device="cuda", problem=None) -> dict:
    """Per degree: the SimRun, its eval curve and its wall seconds; and the
    common target."""
    dev = resolve_device(device)
    steps = 40 if quick else 150
    problem = problem or problems.problem_classifier()
    runs, wall = {}, {}
    for d in DEGREES:
        t0 = time.perf_counter()
        runs[d] = simulate_degree(problem, d, steps=steps, device=dev)
        wall[d] = time.perf_counter() - t0
    curves = {d: r.eval_curve() for d, r in runs.items()}
    target = max(c[1].min() for c in curves.values()) + 0.05
    return {"steps": steps, "runs": runs, "curves": curves, "target": target, "wall_s": wall}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.straggler_wallclock")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    print("real training under virtual clocks — Spark-like compute times,")
    print("zero communication delay (sync local-barrier gossip):\n")
    out = run(args.quick, device=args.device)
    steps, runs, curves, target = out["steps"], out["runs"], out["curves"], out["target"]
    print(f"{'degree':>7} {'it/s':>8} {'final loss':>11} {'t(loss<%.2f)':>14}" % target)
    record = {"summary": {"M": M_WORKERS, "steps": steps, "target": float(target)}}
    for d in DEGREES:
        t, f = curves[d]
        it_per_s = float(steps / runs[d].trace.completion_matrix(steps)[:, -1].mean())
        ttt = time_to_target(t, f, target)
        print(f"{d:7d} {it_per_s:8.3f} {float(f[-1]):11.4f} {ttt:14.1f}")
        record[f"degree {d}"] = {"degree": d, "it_per_s": it_per_s, "final_loss": float(f[-1]),
                                 "time_to_target": ttt, "rounds": steps,
                                 "wall_s": out["wall_s"][d]}
    print("\nsparser degree -> higher throughput -> earlier target hit,")
    print("exactly the paper's Fig. 5 conclusion — now with real losses.")
    telemetry.stamp(record, config=record["summary"], writer="straggler_wallclock")
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "straggler_wallclock.json"), "w") as fp:
        json.dump(record, fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
