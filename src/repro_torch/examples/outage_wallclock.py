"""Riding a regional outage: fault-tolerant hier against a fault-free flat
ring. Three runs on M = 32 workers in 2 pods under the two-link-class
datacenter world (DCI ≫ ICI):

  * ``ring-nofault`` (sync): the paper's wall-clock winner on a healthy
    fleet, the bar to beat.
  * ``ring-outage`` (sync + ``barrier_timeout``): the same ring when pod 1's
    DCI links go dark mid-run; every barrier that needs a cross-pod
    snapshot stalls to the timeout and commits over the survivors.
  * ``hier-outage`` (hier + ``barrier_timeout``): hierarchical gossip under
    the same outage. Barriers are intra-pod only and cross-pod snapshots
    ride stale buffers, so the outage costs staleness, not stalls.

The claim: hier through the outage reaches the common loss target in less
virtual time than the flat ring needs with no fault at all; ``main``
returns 1 when it does not hold. Writes
``results/torch/outage_crossing.json`` (curves, time to target, downtime and
retried bytes by link class from ``Trace.link_accounting``).

``--trace`` also exports a telemetry bundle per job under
``results/torch/runs/outage/<job>/``: ``trace.json``, a Perfetto timeline
``perfetto.json`` and ``telemetry.json``, with gossip-health gauges sampled
across the outage. Summarize one with ``python -m repro_torch.telemetry.report
results/torch/runs/outage/<job>``.

    python -m repro_torch.examples.outage_wallclock [--quick] [--trace] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch import problems, resolve_device, telemetry
from repro_torch.core import topology as T
from repro_torch.examples import RESULTS
from repro_torch.sim import MeshSpec, scenarios, time_to_target

ICI_LATENCY = 0.02
JOBS = ("ring-nofault", "ring-outage", "hier-outage")


def run(quick: bool = False, trace: bool = False, *, device="cuda", problem=None) -> dict:
    dev = resolve_device(device)
    pods, pod_size = (2, 8) if quick else (2, 16)
    M = pods * pod_size
    dci = 12.0 if quick else 25.0
    lr = 0.8
    sync_rounds = 30 if quick else 60
    hier_rounds = 200 if quick else 650
    # the outage opens after the early transient and stays down for a
    # stretch worth several DCI round trips
    outage_start = 8.0 * dci
    outage_duration = (10.0 if quick else 16.0) * dci
    timeout = 3.0 * dci

    problem = problem or problems.problem_classifier()
    mesh = MeshSpec.pods(M, pods)
    healthy = scenarios.datacenter("spark", dci_latency=dci, ici_latency=ICI_LATENCY, seed=7)
    outage = scenarios.regional_outage(pod=1, start=outage_start, duration=outage_duration,
                                       dist="spark", dci_latency=dci,
                                       ici_latency=ICI_LATENCY, seed=7)
    jobs = (
        ("ring-nofault", T.undirected_ring(M), "sync", sync_rounds, 1, healthy, {}),
        ("ring-outage", T.undirected_ring(M), "sync", sync_rounds, 1,
         outage, {"barrier_timeout": timeout}),
        ("hier-outage", T.hier(pods, pod_size), "hier", hier_rounds, 4,
         outage, {"barrier_timeout": timeout}),
    )
    out = {}
    for name, topo, proto, rounds, eval_every, scen, kw in jobs:
        if trace:
            kw = dict(kw, health=True, run_dir=os.path.join(RESULTS, "runs", "outage", name))
        t0 = time.perf_counter()
        r = problems.run_sim(problem, topo, rounds=rounds, lr=lr, protocol=proto,
                             scenario=scen, mesh=mesh, eval_every=eval_every, device=dev, **kw)
        t, f = r.eval_curve()
        out[name] = {
            "protocol": proto, "rounds": rounds, "scenario": scen.name,
            "vtime": t.tolist(), "loss": f.tolist(),
            "final_vtime": float(r.virtual_time),
            "link_accounting": r.trace.link_accounting(),
            "wall_s": time.perf_counter() - t0,
        }

    # common target: the worst final loss among the three runs, so every
    # curve reaches it inside its own horizon
    target = max(float(np.asarray(out[n]["loss"])[-1]) for n in out)
    summary = {
        "M": M, "pods": pods, "dci_latency": dci, "ici_latency": ICI_LATENCY,
        "outage": {"pod": 1, "start": outage_start, "duration": outage_duration},
        "barrier_timeout": timeout, "lr": lr, "loss_target": target,
    }
    for name in out:
        t = np.asarray(out[name]["vtime"])
        f = np.asarray(out[name]["loss"])
        summary[f"{name}_final_loss"] = float(f[-1])
        summary[f"{name}_time_to_target"] = time_to_target(t, f, target)
    summary["hier_outage_beats_healthy_ring"] = bool(
        summary["hier-outage_time_to_target"] < summary["ring-nofault_time_to_target"])
    dci_acct = out["hier-outage"]["link_accounting"]["dci"]
    summary["hier_dci_downtime"] = dci_acct["downtime"]
    summary["hier_dci_retried_bytes"] = dci_acct["retried_bytes"]
    out["summary"] = summary
    telemetry.stamp(out, config=summary, writer="outage_wallclock")
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "outage_crossing.json"), "w") as fp:
        json.dump(out, fp, indent=1)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.outage_wallclock")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = run(args.quick, args.trace, device=args.device)["summary"]
    o = s["outage"]
    print(f"M={s['M']} workers in {s['pods']} pods; pod {o['pod']}'s DCI "
          f"links dark over t=[{o['start']:.0f}, {o['start'] + o['duration']:.0f}] "
          f"(DCI latency {s['dci_latency']}, ICI {s['ici_latency']})\n")
    print(f"{'':>14} {'final loss':>11} {'t(loss<%.3f)':>15}" % s["loss_target"])
    for name in JOBS:
        print(f"{name:>14} {s[f'{name}_final_loss']:11.4f} "
              f"{s[f'{name}_time_to_target']:15.1f}")
    print(f"\nDCI downtime charged to the hier run: "
          f"{s['hier_dci_downtime']:.0f} vtime, "
          f"{s['hier_dci_retried_bytes']} bytes held + retried")
    verdict = "BEATS" if s["hier_outage_beats_healthy_ring"] else "does NOT beat"
    print(f"hier THROUGH the outage {verdict} the flat ring on a fleet with no fault at all:")
    print("barriers stay intra-pod, the outage costs staleness — not stalls — while the flat")
    print("ring pays the timeout on every barrier its dead pod-boundary edges starve.")
    if args.trace:
        print("\ntelemetry bundles (perfetto.json loads at ui.perfetto.dev):")
        for name in JOBS:
            print(f"  {os.path.join(RESULTS, 'runs', 'outage', name)}/")
    return 0 if s["hier_outage_beats_healthy_ring"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
