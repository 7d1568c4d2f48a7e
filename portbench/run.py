"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell (``portbench/workloads/<cell>.json``), makes its weights and
inputs on the card from ``--seed``, warms up, measures for ``--seconds``
and checks what the timed path produced against the plain reference. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with the trace also
``breakdown``, and last ``check``: each number compared with its limit.
The same numbers end standard error. Exits 2 without a result where there
is no CUDA card, or fewer cards than the cell asks for, and 3 where a
module of JAX or of the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BUILD / "inductor")
os.environ["CUDA_CACHE_PATH"] = str(BUILD / "cuda_cache")
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("OMP_NUM_THREADS", "4")
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    device = torch.device("cuda", 0)
    bench = harness.benchmark()
    wanted = harness.metrics_of(args.workload, bench, bool(args.trace))
    run = harness.driver(cell["driver"]).run(cell, args.seed, args.seconds, bool(args.trace),
                                             device, setup_from=T_START)
    gc.collect()
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    metrics = harness.read_metrics(run, wanted)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
           "memory_peak_bytes": int(run["peak_bytes"])}
    breakdown = None
    if args.trace:
        dev["busy_s"] = run["trace"]["busy"]["busy_s"]
        dev["window_s"] = run["trace"]["busy"]["window_s"]
        breakdown = {"device_ops": run["trace"]["device_ops"],
                     "idle_gaps": run["trace"]["idle_gaps"]}
    print("readings: " + json.dumps(run["numbers"]) + " worst " + json.dumps(run["worst"]),
          file=sys.stderr)
    if args.trace:
        t = run["trace"]
        print("trace: " + json.dumps({k: v for k, v in t.items()
                                      if k not in ("device_ops", "idle_gaps")}), file=sys.stderr)
    correct = all(v["value"] <= v["limit"] for v in run["check"].values()) and not run["failed"]
    for line in harness.check_lines(run["check"]):
        print(line, file=sys.stderr)
    print(harness.result_line(correct=correct, attempted=run["attempted"], failed=run["failed"],
                              metrics=metrics, device=dev, check=run["check"],
                              breakdown=breakdown))
    return 0


if __name__ == "__main__":
    sys.exit(main())
