"""Paper Fig. 5 end to end with real losses: ring against clique in
virtual wall-clock under a heavy-tail straggler distribution.

Both axes come from one event-driven simulation (:mod:`repro_torch.sim`):
every worker runs real train steps under its own virtual clock, so one run
shows both claims:

  (a) loss against iteration: the clique (better mixing, λ2 = 0) wins or ties;
  (b) loss against virtual time: the ring wins. A straggler only stalls its
      two neighbours, while the clique's global barrier slows every round
      to its slowest worker.

Writes ``results/torch/fig5_realloss.json`` with both curve pairs.

    python -m repro_torch.examples.fig5_realloss [--quick] [--device cpu]
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
from repro_torch.sim import scenarios, time_to_target


def simulate(problem, topo, *, steps, device, lr=0.5, scen_seed=7):
    # heavier tail than the default Spark shape: rare 8x slowdowns
    scen = scenarios.heavy_tail("spark", seed=scen_seed, p_slow=0.1, slow_factor=8.0)
    return problems.run_sim(problem, topo, rounds=steps, lr=lr, protocol="sync",
                            scenario=scen, device=device)


def run(quick: bool = False, *, device="cuda", problem=None) -> dict:
    dev = resolve_device(device)
    M = 8 if quick else 16
    steps = 60 if quick else 200
    problem = problem or problems.problem_classifier()
    out = {}
    for name, topo in (("ring", T.undirected_ring(M)), ("clique", T.clique(M))):
        t0 = time.perf_counter()
        r = simulate(problem, topo, steps=steps, device=dev)
        t, f = r.eval_curve()
        out[name] = {"vtime": t.tolist(), "loss": f.tolist(),
                     "iterations": list(range(1, len(f) + 1)),
                     "rounds": steps, "wall_s": time.perf_counter() - t0}
    target = max(min(out[n]["loss"]) for n in out) + 0.05
    summary = {"M": M, "steps": steps, "target": target}
    for name in out:
        t = np.asarray(out[name]["vtime"])
        f = np.asarray(out[name]["loss"])
        summary[f"{name}_final_loss"] = float(f[-1])
        summary[f"{name}_final_vtime"] = float(t[-1])
        summary[f"{name}_time_to_target"] = time_to_target(t, f, target)
    out["summary"] = summary
    telemetry.stamp(out, config=summary, writer="fig5_realloss")
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "fig5_realloss.json"), "w") as fp:
        json.dump(out, fp, indent=1)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.fig5_realloss")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    s = run(args.quick, device=args.device)["summary"]
    print(f"M={s['M']} workers, {s['steps']} rounds, heavy-tail stragglers\n")
    print(f"{'':>8} {'final loss':>11} {'total vtime':>12} "
          f"{'t(loss<%.2f)':>14}" % s["target"])
    for name in ("ring", "clique"):
        print(f"{name:>8} {s[f'{name}_final_loss']:11.4f} "
              f"{s[f'{name}_final_vtime']:12.1f} "
              f"{s[f'{name}_time_to_target']:14.1f}")
    print("\nloss-vs-iteration: clique wins or ties (faster consensus);")
    print("loss-vs-virtual-time: ring wins (no global barrier) — the curves")
    print("cross, which is the paper's Fig. 5 with real training dynamics.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
