"""Convergence against bytes on the compressed DCI lane: does a lossy
cross-pod wire buy virtual time, or only a smaller byte column?

Three hier runs on M workers in 2 pods under the bandwidth-limited
two-link-class world (finite DCI bandwidth, so payload bytes are wire
time): exact float32 DCI, bf16 DCI and int8 with error feedback. All three
mix the same intra-pod (ICI) stage; only the cross-pod stage rides the
quantized bus (``dci_dtype=`` of ``run_simulated``), the residual
re-injecting each round's quantization error.

The claim: the int8 run reaches the common loss target (the worst final
loss among the runs) in no more virtual time than the exact run, while
shipping ≥ 3.5× fewer DCI bytes; ``main`` returns 1 when it does not hold.
``results/torch/dci_compress.json`` holds, per run, the virtual time, the
global loss and the cumulative DCI bytes at that time, and the time and
bytes to target.

    python -m repro_torch.examples.dci_compress_wallclock [--quick] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from repro_torch import problems, resolve_device, telemetry
from repro_torch.core import topology as T
from repro_torch.core.bus import plan_layout
from repro_torch.examples import RESULTS
from repro_torch.sim import scenarios, time_to_target

DCI_LATENCY = 0.5
ICI_LATENCY = 0.02
WIRES = (("fp32-exact", None), ("bf16", "bfloat16"), ("int8", "int8"))


def _cumulative_dci_bytes(trace, at_times: np.ndarray) -> list[float]:
    """Total DCI bytes delivered by each virtual time in ``at_times``."""
    arr = sorted((r.t, r.nbytes) for r in trace.records
                 if r.kind == "arrival" and r.link_class == "dci")
    ts = np.array([t for t, _ in arr])
    cum = np.cumsum([b for _, b in arr]) if arr else np.array([])
    return [float(cum[np.searchsorted(ts, t, side="right") - 1])
            if len(ts) and t >= ts[0] else 0.0 for t in at_times]


def run(quick: bool = False, *, device="cuda", problem=None) -> dict:
    dev = resolve_device(device)
    pods, pod_size = (2, 8) if quick else (2, 16)
    topo = T.hier(pods, pod_size)
    rounds = 60 if quick else 160
    problem = problem or problems.problem_classifier(S=512 if quick else 2048)

    layout = plan_layout(problem[2], lead_ndim=0)
    payloads = {"fp32-exact": layout.padded_bytes(),
                "bf16": layout.padded_bytes("bfloat16"),
                "int8": layout.padded_bytes("int8")}
    dci_bw = payloads["fp32-exact"] / (6.0 * DCI_LATENCY)

    out = {}
    for name, wire in WIRES:
        scen = scenarios.datacenter("spark", dci_latency=DCI_LATENCY,
                                    ici_latency=ICI_LATENCY, dci_bw=dci_bw, seed=7)
        t0 = time.perf_counter()
        r = problems.run_sim(problem, topo, rounds=rounds, lr=0.3, protocol="hier",
                             scenario=scen, mesh="topology", eval_every=2, dci_dtype=wire,
                             device=dev)
        t, f = r.eval_curve()
        out[name] = {
            "dci_dtype": wire, "dci_payload_bytes": payloads[name],
            "vtime": t.tolist(), "loss": f.tolist(),
            "cum_dci_bytes": _cumulative_dci_bytes(r.trace, np.asarray(t)),
            "final_vtime": float(r.virtual_time),
            "link_accounting": r.trace.link_accounting(),
            "ef_residual_norms": [g.value for g in r.trace.gauges
                                  if g.name == "hier.dci_ef_residual_norm"],
            "rounds": rounds, "wall_s": time.perf_counter() - t0,
        }

    target = max(float(np.asarray(out[n]["loss"])[-1]) for n in out)
    summary = {"M": topo.M, "pods": pods, "dci_latency": DCI_LATENCY,
               "ici_latency": ICI_LATENCY, "dci_bandwidth": dci_bw,
               "rounds": rounds, "loss_target": target,
               "dci_byte_reduction_int8": payloads["fp32-exact"] / payloads["int8"]}
    for name in out:
        t = np.asarray(out[name]["vtime"])
        f = np.asarray(out[name]["loss"])
        summary[f"{name}_final_loss"] = float(f[-1])
        summary[f"{name}_time_to_target"] = time_to_target(t, f, target)
        cum = np.asarray(out[name]["cum_dci_bytes"])
        hit = np.nonzero(f <= target)[0]
        summary[f"{name}_dci_bytes_to_target"] = float(cum[hit[0]]) if len(hit) else float("inf")
    summary["int8_beats_exact_vtime"] = bool(
        summary["int8_time_to_target"] <= summary["fp32-exact_time_to_target"])
    out["summary"] = summary
    telemetry.stamp(out, config=summary, writer="dci_compress_wallclock")
    os.makedirs(RESULTS, exist_ok=True)
    with open(os.path.join(RESULTS, "dci_compress.json"), "w") as fp:
        json.dump(out, fp, indent=1)
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples.dci_compress_wallclock")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(args.quick, device=args.device)
    s = out["summary"]
    print(f"M={s['M']} workers in {s['pods']} pods; DCI latency "
          f"{s['dci_latency']}, bandwidth {s['dci_bandwidth']:.0f} B/vtime "
          f"(exact payload costs ~{6 * s['dci_latency']:.1f} vtime/hop)\n")
    print(f"{'':>11} {'DCI payload':>12} {'final loss':>11} "
          f"{'t(target)':>10} {'DCI bytes(target)':>18}")
    for name, _ in WIRES:
        print(f"{name:>11} {out[name]['dci_payload_bytes']:>11}B "
              f"{s[f'{name}_final_loss']:11.4f} "
              f"{s[f'{name}_time_to_target']:10.1f} "
              f"{s[f'{name}_dci_bytes_to_target']:18.3g}")
    print(f"\nint8 ships {s['dci_byte_reduction_int8']:.2f}x fewer DCI "
          f"bytes per message; error feedback keeps the residual bounded "
          f"(last norm {out['int8']['ef_residual_norms'][-1]:.3g}).")
    verdict = "BEATS" if s["int8_beats_exact_vtime"] else "does NOT beat"
    print(f"int8 DCI {verdict} the exact wire to the common loss target on virtual time.")
    return 0 if s["int8_beats_exact_vtime"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
