"""Fleet scale: 512 workers with real values through a preemption-wave ×
elastic composite, the run the O(M) commit architecture exists for.

M = 512 workers in 8 pods of 64 on the two-link-class datacenter world
(DCI ≫ ICI), with real train steps per worker per round. Two topologies
ride the same composite scenario:

  * ``ring-fleet`` (sync): the flat 512-ring. Its barriers are 3 workers
    wide and only 8 of its 512 edges cross a pod boundary, so the DCI
    latency amortizes around the chain.
  * ``hier-fleet`` (hier): exact 64-worker intra-pod barriers on ICI,
    cross-pod snapshots riding stale buffers over DCI.

The composite scenario stacks per-pod rooflines (each pod's workers carry
a compute-speed constant, 1.0× to 1.6× the base step time, through
``scenarios.sampled(..., speed=)``), an elastic scale-up (the fleet starts
at 448 workers and the last pod's 64 join while training runs,
``scenarios.elastic``) and a preemption wave (16 spot workers across the
fleet die one by one and rejoin later, ``scenarios.preemption_wave``), with
``barrier_timeout`` carrying the survivors through.

A 64-wide exact barrier almost surely holds a heavy-tail straggler every
round and always holds the slowest pod's roofline, while the ring's
width-3 barriers dodge the tail: topology matters at fleet scale in
wall-clock, not in per-round progress.

The claim: the flat ring reaches the common loss target in less virtual
time than hier on the same faulty fleet; ``main`` returns 1 when it does
not hold. Writes ``results/torch/fleet_wallclock.json`` (curves, time to
target, churn schedule size, bytes by link class, host rounds per second).
``--quick`` keeps M = 512 with a shorter round budget.

    python -m repro_torch.examples.fleet_wallclock [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np

from repro_torch import problems, resolve_device, telemetry
from repro_torch.core import topology as T
from repro_torch.examples import RESULTS
from repro_torch.sim import MeshSpec, scenarios, time_to_target

PODS, POD_SIZE = 8, 64
M = PODS * POD_SIZE
ICI_LATENCY = 0.02
DCI_LATENCY = 6.0
# hardware-generation roofline per pod: step time multiplier (>1 = slower)
POD_SPEED = [1.0, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5, 1.6]
JOBS = ("ring-fleet", "hier-fleet")


def composite_scenario(seed: int = 7) -> scenarios.Scenario:
    """datacenter links + per-pod rooflines + elastic join × preemption."""
    base = scenarios.datacenter("spark", dci_latency=DCI_LATENCY,
                                ici_latency=ICI_LATENCY, seed=seed)
    speed = np.repeat(np.asarray(POD_SPEED, dtype=np.float64), POD_SIZE)
    compute = scenarios.sampled(scenarios.DISTRIBUTIONS["spark"](), speed=speed)
    # the last pod (slowest generation) arrives while training runs...
    el = scenarios.elastic(M, initial=M - POD_SIZE, start=3.0, interval=0.4)
    # ...and a spot-preemption wave sweeps the fleet once it is whole
    pw = scenarios.preemption_wave(M, start=15.0, interval=1.0, count=16, down_for=20.0)
    churn = tuple(sorted(el.churn + pw.churn, key=lambda e: (e[0], e[1])))
    return dataclasses.replace(base, name="fleet-composite", compute=compute, churn=churn)


def run(quick: bool = False, *, device="cuda", problem=None) -> dict:
    dev = resolve_device(device)
    lr = 0.05
    sync_rounds = 12 if quick else 45
    hier_rounds = 12 if quick else 45
    timeout = 2.0 * DCI_LATENCY

    problem = problem or problems.problem_linear(S=8 * M, n=16, seed=0)
    mesh = MeshSpec.pods(M, PODS)
    scen = composite_scenario()

    jobs = (
        ("ring-fleet", T.undirected_ring(M), "sync", sync_rounds),
        ("hier-fleet", T.hier(PODS, POD_SIZE), "hier", hier_rounds),
    )
    out = {}
    for name, topo, proto, rounds in jobs:
        t0 = time.perf_counter()
        r = problems.run_sim(problem, topo, rounds=rounds, lr=lr, B=4, protocol=proto,
                             scenario=scen, mesh=mesh, eval_every=1,
                             barrier_timeout=timeout, device=dev)
        wall = time.perf_counter() - t0
        t, f = r.eval_curve()
        out[name] = {
            "protocol": proto, "rounds": rounds, "scenario": scen.name,
            "vtime": t.tolist(), "loss": f.tolist(),
            "final_vtime": float(r.virtual_time),
            "min_rounds_completed": int(r.rounds.min()),
            "wall_s": wall, "rounds_per_sec": rounds / wall,
            "events_per_sec": len(r.trace) / wall,
            "link_accounting": r.trace.link_accounting(),
        }

    target = max(float(np.asarray(out[n]["loss"])[-1]) for n in out)
    summary = {
        "M": M, "pods": PODS, "pod_speed": POD_SPEED,
        "dci_latency": DCI_LATENCY, "ici_latency": ICI_LATENCY,
        "barrier_timeout": timeout, "lr": lr, "loss_target": target,
        "churn_events": len(scen.churn),
    }
    for name in out:
        t = np.asarray(out[name]["vtime"])
        f = np.asarray(out[name]["loss"])
        summary[f"{name}_final_loss"] = float(f[-1])
        summary[f"{name}_time_to_target"] = time_to_target(t, f, target)
        summary[f"{name}_rounds_per_sec"] = out[name]["rounds_per_sec"]
    summary["ring_beats_hier"] = bool(
        summary["ring-fleet_time_to_target"] < summary["hier-fleet_time_to_target"])
    out["summary"] = summary
    telemetry.stamp(out, config=summary, writer="fleet_wallclock")
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "fleet_wallclock.json"), "w") as fp:
        json.dump(out, fp, indent=1)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.fleet_wallclock")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.quick, device=args.device)
    s = out["summary"]
    print(f"M={s['M']} real-value workers in {s['pods']} pods "
          f"(rooflines {min(s['pod_speed'])}x..{max(s['pod_speed'])}x), "
          f"{s['churn_events']} churn events (elastic scale-up + preemption wave), "
          f"DCI {s['dci_latency']} / ICI {s['ici_latency']}\n")
    print(f"{'':>12} {'final loss':>11} {'t(target)':>11} {'rounds/s':>9} {'events/s':>10}")
    for name in JOBS:
        j = out[name]
        print(f"{name:>12} {s[f'{name}_final_loss']:11.4f} "
              f"{s[f'{name}_time_to_target']:11.1f} "
              f"{j['rounds_per_sec']:9.1f} {j['events_per_sec']:10.0f}")
    verdict = "BEATS" if s["ring_beats_hier"] else "does NOT beat"
    print(f"\nflat 512-ring {verdict} hierarchical gossip through the composite: width-3 "
          "barriers")
    print("dodge the heavy tail a 64-wide exact pod barrier almost surely draws every round,")
    print("and 8 pod-boundary DCI hops amortize over 512 chain links — the effective-neighbors")
    print("tradeoff separates from the ring only at fleet scale, and only in wall-clock.")
    return 0 if s["ring_beats_hier"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
