"""The readings that a cell's limits are set from, as ``portbench/control.py``
takes them, for a cell of any training driver: the numbers are the cell's
driver's own ``gaps`` (``drivers/train_ranges.py`` for granite4h), the
program and the reference are ``drivers/train.py``'s. Besides control.py's
modes, ``plant:<name>`` reads the program with a bug planted in the port's
Mamba-2 mixer (``PLANTS``), to show which limit catches it. The benchmark's
own runs never run this.

    python3 portbench/control_any.py --workload <cell> --seeds 1,2,3 \
        --modes program,control,fault:half_batch,plant:no_carry --seconds 2 \
        [--out file.jsonl]

``program`` reads every seed; ``control``, each ``fault:<name>``
(``portbench.faults``) and each ``plant:<name>`` read the first three. One
JSON line per reading, with the per-tensor norms it was computed from.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


@contextlib.contextmanager
def _no_carry():
    """Every chunk of the SSD scanned from a zero state: the cross-chunk term
    (the state carried into a chunk, and its decay through it) dropped."""
    from repro_torch.models import ssm

    saved = ssm._ssd

    def each_chunk_alone(x, dt, A, B, C, chunk):
        b, l = x.shape[:2]
        k = l // chunk

        def cut(t):
            return t.reshape(b * k, chunk, *t.shape[2:])
        y, s = saved(cut(x), cut(dt), A, cut(B), cut(C), chunk)
        return y.reshape(x.shape), s.reshape(b, k, *s.shape[1:])[:, -1]

    ssm._ssd = each_chunk_alone
    try:
        yield
    finally:
        ssm._ssd = saved


@contextlib.contextmanager
def _taps_reversed():
    """The causal conv's taps applied in reverse order."""
    from repro_torch.models import ssm

    saved = ssm._mamba2

    def reversed_taps(params, cfg, x, cache):
        return saved(dict(params, conv_w=params["conv_w"].flip(0)), cfg, x, cache)

    ssm._mamba2 = reversed_taps
    try:
        yield
    finally:
        ssm._mamba2 = saved


PLANTS = {"no_carry": _no_carry, "taps_reversed": _taps_reversed}


def reading(cell, seed, mode, seconds, device):
    """One reading: the numbers that the cell's driver compares, the tensor
    each worst one is at, the losses and the per-tensor norms; the
    program's step time and peak where the program ran."""
    from portbench import harness
    from portbench.control import _free
    from portbench.drivers import train
    from portbench.faults import Fault

    ref = train.reference_readings(cell, seed, device)
    _free(device)
    extra = {}
    if mode == "control":
        prog = train.reference_readings(cell, seed, device, prec="fp8")
    else:
        kind, _, name = mode.partition(":")
        fault = Fault(name) if kind == "fault" else None
        if kind == "plant":
            ctx = PLANTS[name]()
        elif fault:
            ctx = fault.patch()
        elif mode == "program":
            ctx = contextlib.nullcontext()
        else:
            raise ValueError(f"unknown mode {mode!r}")
        with ctx:
            run = train.program(cell, seed, device, seconds=seconds, trace=False, fault=fault)
        prog = run["readings"]
        extra = {"step_s": run["step_s"], "peak_gb": run["peak_bytes"] / 1e9}
        del run
    _free(device)
    numbers, worst = harness.driver(cell["driver"]).gaps(prog, ref)
    return {"numbers": numbers, "worst": worst, **extra,
            "losses": [prog["losses"], ref["losses"]],
            "prog": {"grad": prog["grad"], "change": prog["change"]},
            "ref": {"grad": ref["grad"], "change": ref["change"]}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program,control")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    cell = harness.cell(args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for mode in args.modes.split(","):
        for seed in seeds if mode == "program" else seeds[:3]:
            t = time.perf_counter()
            r = reading(cell, seed, mode, args.seconds, device)
            line = {"cell": args.workload, "mode": mode, "seed": seed,
                    "seconds": time.perf_counter() - t, **r}
            print(json.dumps({k: line[k] for k in line if k not in ("prog", "ref")}), flush=True)
            if out:
                out.write(json.dumps(line) + "\n")
                out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
