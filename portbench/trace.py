"""Reading ``torch.profiler`` traces of short windows: the device's busy
time, the device time each of the benchmark's named ranges launched, the
operations that took most time and the longest idle gaps.

Recording the host's operations slows the host, and a card that waits for
the host shows that wait as idle. So the card's busy time comes from a
window of its own in which only the card's activity is recorded
(``device_only``; the idle metric sets it against the untraced step), and
the ranges, operations and gaps from one that records both (``profiled``).

Ranges are ``torch.profiler.record_function`` scopes that the drivers open
around calls into the program; a kernel belongs to the range whose host
call launched it (the profiler's correlation of launch and kernel), so work
that autograd's device thread launches belongs to no range.
"""
from __future__ import annotations

import contextlib
import time

import torch


@contextlib.contextmanager
def profiled(out: dict, device: torch.device):
    """Profile the body; on exit ``out`` holds the reduced trace."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(device) if device.type == "cuda" else None
        out["window_s"] = time.perf_counter() - t0
    out.update(reduce(prof.events()))


@contextlib.contextmanager
def device_only(out: dict, device: torch.device):
    """Profile the card's activity alone over the body; on exit ``out``
    holds ``busy_s`` (the union of the card's operations), ``window_s``
    and ``n_device_events``. Off the card nothing is recorded."""
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        t0 = time.perf_counter()
        yield
        out.update(busy_s=0.0, window_s=time.perf_counter() - t0, n_device_events=0)
        return
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        torch.cuda.synchronize(device)
        out["window_s"] = time.perf_counter() - t0
    dev = [e for e in prof.events() if _is_device(e) and not e.name.startswith("portbench.")]
    out["busy_s"] = sum(b - a for a, b in _union((e.time_range.start, e.time_range.end)
                                                 for e in dev)) / 1e6
    out["n_device_events"] = len(dev)


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events) -> dict:
    # a named range also shows on the device as an annotation spanning its
    # kernels: it is no operation of its own
    dev = [e for e in events if _is_device(e) and not e.name.startswith("portbench.")]
    host = [e for e in events if not _is_device(e)]
    spans = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(b - a for a, b in spans)
    ranges: dict[str, list] = {}
    for e in host:
        if e.name.startswith("portbench."):
            r = ranges.setdefault(e.name, [0, 0.0])
            r[0] += 1
            r[1] += e.device_time_total / 1e6
    by_op: dict[str, float] = {}
    for e in dev:
        by_op[e.name] = by_op.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(spans, spans[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    idle = [[_host_at(host, (g0 + g1) / 2), (g1 - g0) / 1e6] for g0, g1 in gaps]
    return {"busy_s": busy_us / 1e6, "device_s": sum(by_op.values()), "ranges": ranges,
            "device_ops": [[k, v] for k, v in top_ops], "idle_gaps": idle,
            "n_device_events": len(dev)}


def _host_at(host, t: float) -> str:
    """The innermost host operation running at time ``t``."""
    best = None
    for e in host:
        if e.time_range.start <= t <= e.time_range.end:
            if best is None or (e.time_range.end - e.time_range.start
                                < best.time_range.end - best.time_range.start):
                best = e
    return best.name if best is not None else "python between operations"


@contextlib.contextmanager
def named(name: str):
    with torch.profiler.record_function("portbench." + name):
        yield


def wrap(fn, name: str):
    """``fn`` inside the range ``portbench.<name>``."""
    def wrapped(*a, **k):
        with named(name):
            return fn(*a, **k)
    wrapped.__wrapped__ = fn
    return wrapped
