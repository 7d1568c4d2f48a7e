"""The port's own spans in a ``torch.profiler`` trace, and a probe that reads
them for one training cell.

With a ``repro_torch.telemetry`` sink installed, the port opens a
``torch.profiler.record_function`` range at each of its spans (``train.step``,
``train.grad``, ``train.forward``, ``model.remat.recompute``, ``train.optim``,
``train.stats``, ``bus.mix``, ``bus.pack``, ``bus.fused_mix``, ``bus.kernel``,
``bus.unpack``) and counts the bus's bytes. :func:`attribute` gives each span
the device time of the kernels whose launch falls innermost in it, by the
host time of the runtime call that the profiler correlates with each
kernel, on whichever thread made it: the backward, which autograd's device
thread launches while the main thread waits inside ``train.grad``, lands in
``train.grad``'s own time, and a layer's recomputation in
``model.remat.recompute``. :func:`device_ops` drops every user annotation
from the device operations by kind, so a range is never counted as an
operation of its own.

The benchmark's runs do not read these yet (``PERF.md`` §7 names the edits
to ``drivers/train.py`` and ``trace.py`` that would). The probe runs a cell
as its driver does and prints one JSON line: the tracing's cost (timed
windows with the sink installed and without, in turns), the driver's own
ranges from a traced window without the sink, and the spans' device time
and the bus's counters from one with it::

    python3 portbench/spans.py --workload granite.train.ring-m4 --seed 7
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

# the runtime and driver calls that launch device work (cudaLaunchKernel,
# cuLaunchKernel, cudaMemcpyAsync, ...)
_LAUNCH_PREFIX = "cu"


def _on_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def device_ops(events) -> list:
    """The device's operations: every device event but user annotations."""
    return [e for e in events if _on_device(e) and not e.is_user_annotation]


def attribute(events, names) -> dict:
    """``{"spans": {name: [ranges, device seconds]}, "outside_s": s}``: for
    each span name, how many host ranges of it the trace holds and the
    device seconds of the operations whose launch falls innermost in one of
    them (the latest-starting range that holds the launch, on any thread);
    ``outside_s`` sums the operations launched in none, or whose launch the
    trace does not hold."""
    names = set(names)
    # by start, an outer range before an inner one that starts with it
    ranges = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                     if not _on_device(e) and e.name in names), key=lambda r: (r[0], -r[1]))
    starts = [r[0] for r in ranges]
    by_corr: dict[int, float] = {}
    for e in device_ops(events):
        by_corr[e.id] = by_corr.get(e.id, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    launch = {e.id: e.time_range.start for e in events
              if not _on_device(e) and e.id in by_corr and e.name.startswith(_LAUNCH_PREFIX)}
    out = {n: [0, 0.0] for n in names}
    for _, _, n in ranges:
        out[n][0] += 1
    outside = 0.0
    for corr, s in by_corr.items():
        t, owner = launch.get(corr), None
        if t is not None:
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and owner is None:
                if ranges[i][1] >= t:
                    owner = ranges[i][2]
                i -= 1
        if owner is None:
            outside += s
        else:
            out[owner][1] += s
    return {"spans": out, "outside_s": outside}


SPANS = ("train.step", "train.grad", "train.forward", "model.remat.recompute", "train.optim",
         "train.stats", "bus.mix", "bus.pack", "bus.fused_mix", "bus.kernel", "bus.unpack")
BYTES = ("bus.bytes_packed", "bus.bytes_gathered", "bus.bytes_kernel", "bus.bytes_unpacked")


def layers(spans: dict, counters: dict, steps: int, cfg: dict, workers: int) -> dict:
    """The splits a traced window gives, per step: the gradient's forward,
    backward (``train.grad``'s own time) and recompute, the bus's copies
    (``bus.mix`` less ``bus.kernel``), the kernel's share of the bus's byte
    bound, and the bytes the bus moves over that bound."""
    from portbench import yardstick as Y

    ms = {n: 1e3 * s / steps for n, (_, s) in spans.items()}
    bound = Y.mix_bytes(cfg, workers)
    calls = spans["bus.mix"][0]
    kernel_s = spans["bus.kernel"][1]
    bus = ("bus.mix", "bus.pack", "bus.fused_mix", "bus.unpack")
    return {
        "fwd_ms": ms["train.forward"], "bwd_ms": ms["train.grad"],
        "recompute_ms": ms["model.remat.recompute"],
        "bus_copy_ms": sum(ms[n] for n in bus),
        "gossip_roofline": (100.0 * bound / Y.HBM_BYTES_PER_S / (kernel_s / calls)
                            if calls and kernel_s else None),
        "bus_bytes_x": (sum(counters.get(n, 0) for n in BYTES) / calls / bound
                        if calls else None),
    }


def probe(cell: dict, seed: int, device, *, cost_s: float, cost_windows: int) -> dict:
    """Set-up as the training driver's, then the tracing's cost and the two
    traced windows (module docstring)."""
    from portbench import harness, port, trace as tr, weights
    from portbench.drivers import train as drv
    from repro_torch import telemetry
    from repro_torch.core import bus, decentralized as Dc
    from repro_torch.models import model as Mo

    c, mix = cell["cfg"], cell["mix"]
    cfg = port.model_config(c, cell["config"])
    M, B, L = mix["workers"], mix["batch_per_worker"], mix["seq_len"]
    opt = port.optimizer(mix["optimizer"])
    opt = dataclasses.replace(opt, update=tr.wrap(opt.update, "optim"))
    step = Dc.make_train_step(lambda p, b: Mo.loss_fn(p, cfg, b), opt,
                              gossip=port.gossip(mix["gossip"], M), mode=mix["mode"])
    p0 = port.program_params(cfg, weights.make(c, harness.sub_seed(seed, "weights"), device))
    state = Dc.init_state(Dc.replicate_for_workers(p0, M), opt)
    del p0
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "tokens"))
    batch = lambda: {"tokens": drv.feed(gen, M, B, L, c["vocab_size"], device)}
    sync = lambda: torch.cuda.synchronize(device) if device.type == "cuda" else None

    def steps(n):
        nonlocal state
        for _ in range(n):
            state, _m = step(state, batch())

    steps(drv.CHECK_STEPS)
    sync()
    t = time.perf_counter()
    steps(drv.TIMING_STEPS)
    sync()
    step_s = (time.perf_counter() - t) / drv.TIMING_STEPS

    n_cost = max(2, round(cost_s / step_s))
    cost = {"steps": n_cost, "off": [], "on": []}
    for k in range(cost_windows):     # off, on, on, off, off, on, ...
        on = k % 4 in (1, 2)
        with telemetry.run() if on else contextlib.nullcontext():
            sync()
            t = time.perf_counter()
            steps(n_cost)
            sync()
            cost["on" if on else "off"].append(n_cost * M * B * L / (time.perf_counter() - t))

    n = max(2, min(8, round(1.5 / step_s)))
    wrappers = [f"portbench.{r}" for r in ("optim", "mix", "stats")]

    def window(sink: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                         else [])
        with telemetry.run() if sink else contextlib.nullcontext() as tel:
            with profile(activities=acts) as prof:
                sync()
                steps(n)
                sync()
        return prof.events(), tel

    saved = bus.mix_bus, Dc.step_metrics
    bus.mix_bus, Dc.step_metrics = tr.wrap(bus.mix_bus, "mix"), tr.wrap(Dc.step_metrics, "stats")
    try:
        plain, _ = window(sink=False)
        events, tel = window(sink=True)
    finally:
        bus.mix_bus, Dc.step_metrics = saved
    dev = device_ops(events)
    by_span = attribute(events, SPANS)
    spans = by_span["spans"]
    busy = sum(b - a for a, b in tr._union((e.time_range.start, e.time_range.end)
                                           for e in dev)) / 1e6
    device_s = sum((e.time_range.end - e.time_range.start) / 1e6 for e in dev)
    in_step = sum(s for _, s in spans.values())
    reduced = tr.reduce(plain)
    return {
        "step_s": step_s, "cost": cost,
        "driver_window": {
            "steps": n, "device_s": reduced["device_s"], "ranges": reduced["ranges"],
            "wrappers_by_launch": attribute(plain, wrappers)["spans"],
            "stats_by_kernel": _correlated_less_launched(plain, "portbench.stats", n),
            "mix_by_kernel": _correlated_less_launched(plain, "portbench.mix", n)},
        "sink_window": {
            "steps": n, "device_s": device_s, "busy_s": busy,
            "reduce": {k: v for k, v in tr.reduce(events).items()
                       if k in ("device_s", "ranges")},
            "wrappers_by_launch": attribute(events, wrappers)["spans"],
            "spans": spans, "outside_s": by_span["outside_s"],
            "spans_share_of_device": in_step / device_s if device_s else None,
            "counters": {k: tel.counters.get(k, 0) for k in BYTES + ("bus.mix_calls",)},
            "layers": layers(spans, tel.counters, n, c, M),
        },
    }


def _correlated_less_launched(events, name: str, steps: int, top: int = 6) -> list:
    """Where the profiler's correlation (the kernels of a range's host
    subtree) and the launches inside the range disagree: ms per step by
    kernel name, the largest differences first."""
    diff: dict[str, float] = {}
    for e in events:
        if _on_device(e) or e.name != name:
            continue
        stack = [e]
        while stack:
            h = stack.pop()
            for k in h.kernels:
                diff[k.name] = diff.get(k.name, 0.0) + k.duration / 1e3
            stack.extend(h.cpu_children)
        lo, hi = e.time_range.start, e.time_range.end
        launched = {x.id for x in events if not _on_device(x) and lo <= x.time_range.start <= hi
                    and x.name.startswith(_LAUNCH_PREFIX)}
        for k in device_ops(events):
            if k.id in launched:
                ms = (k.time_range.end - k.time_range.start) / 1e3
                diff[k.name] = diff.get(k.name, 0.0) - ms
    worst = sorted(diff.items(), key=lambda kv: -abs(kv[1]))[:top]
    return [[k[:80], v / steps] for k, v in worst if abs(v) > 1e-3]


def main(argv=None) -> int:
    import argparse

    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--cost-seconds", type=float, default=8.0)
    p.add_argument("--cost-windows", type=int, default=4)
    args = p.parse_args(argv)
    from portbench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = harness.cell(args.workload)
    out = probe(cell, args.seed, device, cost_s=args.cost_seconds,
                cost_windows=args.cost_windows)
    out.update(workload=args.workload, seed=args.seed,
               device=torch.cuda.get_device_name(device),
               cost_median={k: statistics.median(out["cost"][k]) for k in ("off", "on")
                            if out["cost"][k]})
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
