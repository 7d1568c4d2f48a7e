"""The readings that a cell's limits are set from, on the chip at the
cell's own size: the program's numbers over many seeds, the control's (the
plain reference computed in float8 e4m3, the precision below the
configuration's bf16, put in the program's place) and each planted fault's.
The benchmark's own runs never run this.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,fault:unchanged --seconds 5 [--out file.jsonl]

``program`` reads every seed; ``control`` and each ``fault:<name>``
(``portbench.faults``) read the first three. One JSON line per reading.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _free(device):
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def train_reading(cell, seed, mode, seconds, device):
    from portbench.drivers import train
    from portbench.faults import Fault

    ref = train.reference_readings(cell, seed, device)
    _free(device)
    if mode == "control":
        prog = train.reference_readings(cell, seed, device, prec="fp8")
    else:
        fault = Fault(mode.split(":", 1)[1]) if mode.startswith("fault:") else None
        with fault.patch() if fault else contextlib.nullcontext():
            run = train.program(cell, seed, device, seconds=seconds, trace=False, fault=fault)
        prog = run["readings"]
        del run
    _free(device)
    numbers, worst = train.gaps(prog, ref)
    return {"numbers": numbers, "worst": worst, "losses": [prog["losses"], ref["losses"]]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    if cell["driver"] != "train":
        raise ValueError(f"no readings for driver {cell['driver']!r}")
    out = open(args.out, "a") if args.out else None
    for mode in args.modes.split(","):
        for seed in seeds if mode == "program" else seeds[:3]:
            t = time.perf_counter()
            r = train_reading(cell, seed, mode, args.seconds, device)
            line = json.dumps({"cell": args.workload, "mode": mode, "seed": seed,
                               "seconds": time.perf_counter() - t, **r})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            _free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
