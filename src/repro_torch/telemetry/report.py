"""Run-summary report over a telemetry run directory.

A plain-Python copy of the reference's ``repro/telemetry/report.py``.

``python -m repro_torch.telemetry.report <run-dir>`` reads the artifacts a traced
run emits (``trace.json`` — the simulator event log, ``telemetry.json`` —
the host-side sink dump, ``perfetto.json`` — the Chrome-trace timeline) and
renders one uniform summary: time-to-target, per-link-class byte/time
totals and downtime, churn/recovery counts, and the health-gauge trajectory
(spectral gap / effective neighbors at every active-matrix change).

The machine-readable summary is written back as ``<run-dir>/report.json``
(provenance-stamped). ``--check`` additionally validates ``perfetto.json``
against the Chrome-trace schema and exits non-zero on any problem — the CI
gate for traced smoke runs.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any

__all__ = ["summarize", "render", "main"]


def _fmt(v: float) -> str:
    if v != v or v in (float("inf"), float("-inf")):
        return str(v)
    if v and (abs(v) >= 1e5 or abs(v) < 1e-3):
        return f"{v:.3e}"
    return f"{v:,.4g}"


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:,.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:,.1f} TiB"


def summarize(run_dir: str, target: float | None = None) -> dict:
    """Build the machine-readable summary dict for a run directory."""
    from repro_torch.sim.trace import (COMPUTE_DONE, FAIL, JOIN, TIMEOUT, Trace,
                                       time_to_target)
    from repro_torch.telemetry.provenance import provenance

    trace_path = os.path.join(run_dir, "trace.json")
    if not os.path.exists(trace_path):
        raise FileNotFoundError(f"no trace.json under {run_dir!r} — was the "
                                "run launched with run_dir=/--trace?")
    trace = Trace.load(trace_path)
    records = trace.records
    t_end = records[-1].t if records else 0.0

    kinds: dict[str, int] = {}
    degraded = 0
    timed_out_pairs = set()
    for r in records:
        kinds[r.kind] = kinds.get(r.kind, 0) + 1
        if r.kind == TIMEOUT:
            timed_out_pairs.add((r.worker, r.round))
    for r in records:
        if (r.kind == COMPUTE_DONE and not r.retried
                and (r.worker, r.round) in timed_out_pairs):
            degraded += 1

    # loss curves: prefer protocol evals (global loss), fall back to the
    # per-round mean train-batch loss.
    times, losses = trace.eval_curve()
    curve_kind = "eval"
    if len(times) == 0:
        times, losses = trace.round_loss_curve()
        curve_kind = "train" if len(times) else None

    if target is None:
        target = trace.meta.get("target")
    ttt = None
    if target is not None and curve_kind is not None:
        ttt = time_to_target(times, losses, float(target))
        if math.isinf(ttt):
            ttt = None

    gauges: dict[str, dict[str, Any]] = {}
    for g in getattr(trace, "gauges", []):
        s = gauges.setdefault(g.name, {"first": g.value, "min": g.value,
                                       "max": g.value, "last": g.value,
                                       "n": 0, "trajectory": []})
        s["min"] = min(s["min"], g.value)
        s["max"] = max(s["max"], g.value)
        s["last"] = g.value
        s["n"] += 1
        s["trajectory"].append([g.t, g.value])

    telemetry = None
    tel_path = os.path.join(run_dir, "telemetry.json")
    if os.path.exists(tel_path):
        with open(tel_path) as f:
            telemetry = json.load(f)

    summary: dict[str, Any] = {
        "provenance": provenance(writer="repro_torch.telemetry.report"),
        "run_dir": run_dir,
        "workers": trace.M,
        "rounds": int(max((r.round for r in records
                           if r.kind == COMPUTE_DONE), default=0)),
        "t_end": t_end,
        "events": kinds,
        "degraded_commits": degraded,
        "fail_events": kinds.get(FAIL, 0),
        "rejoin_events": kinds.get(JOIN, 0),
        "links": trace.link_accounting(),
        "gauges": gauges,
        "meta": dict(trace.meta),
    }
    if curve_kind is not None:
        summary["loss_curve"] = curve_kind
        summary["final_loss"] = float(losses[-1])
    if target is not None:
        summary["target"] = float(target)
        summary["time_to_target"] = ttt
    if telemetry is not None:
        summary["counters"] = telemetry.get("counters", {})
    return summary


def render(summary: dict) -> str:
    """Human-readable rendering of a ``summarize`` dict."""
    lines: list[str] = []
    prov = summary.get("provenance", {})
    lines.append(f"run      {summary['run_dir']}")
    lines.append(f"commit   {prov.get('git_sha', 'unknown')[:12]}"
                 f"   schema v{prov.get('schema_version', '?')}")
    lines.append(f"fleet    M={summary['workers']}"
                 f"  rounds={summary['rounds']}"
                 f"  horizon={_fmt(summary['t_end'])} vt")
    if "final_loss" in summary:
        lines.append(f"loss     final={_fmt(summary['final_loss'])}"
                     f"  ({summary['loss_curve']} curve)")
    if "target" in summary:
        ttt = summary.get("time_to_target")
        lines.append(f"target   {_fmt(summary['target'])} reached at "
                     + (f"{_fmt(ttt)} vt" if ttt is not None else "never"))

    links = summary.get("links") or {}
    if links:
        lines.append("")
        lines.append(f"  {'link':<5} {'messages':>9} {'bytes':>12} "
                     f"{'wire time':>10} {'retried':>8} {'downtime':>9}")
        for cls in sorted(links):
            a = links[cls]
            lines.append(f"  {cls:<5} {int(a['messages']):>9,} "
                         f"{_fmt_bytes(a['bytes']):>12} "
                         f"{_fmt(a['time']):>10} "
                         f"{int(a['retried_messages']):>8,} "
                         f"{_fmt(a['downtime']):>9}")

    churn = (summary["fail_events"], summary["rejoin_events"],
             summary["events"].get("timeout", 0), summary["degraded_commits"])
    if any(churn):
        lines.append("")
        lines.append(f"faults   fails={churn[0]}  rejoins={churn[1]}"
                     f"  barrier-timeouts={churn[2]}"
                     f"  degraded-commits={churn[3]}")
    counters = summary.get("counters") or {}
    if counters:
        lines.append("counters " + "  ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(counters.items())))

    gauges = summary.get("gauges") or {}
    if gauges:
        lines.append("")
        lines.append(f"  {'health gauge':<27} {'start':>9} {'min':>9} "
                     f"{'max':>9} {'end':>9} {'updates':>8}")
        for name in sorted(gauges):
            s = gauges[name]
            lines.append(f"  {name:<27} {_fmt(s['first']):>9} "
                         f"{_fmt(s['min']):>9} {_fmt(s['max']):>9} "
                         f"{_fmt(s['last']):>9} {s['n']:>8}")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.telemetry.report",
        description="Summarize a telemetry run directory.")
    p.add_argument("run_dir", help="directory holding trace.json "
                                   "(+ optional telemetry.json/perfetto.json)")
    p.add_argument("--target", type=float, default=None,
                   help="loss target for time-to-target (default: trace meta)")
    p.add_argument("--check", action="store_true",
                   help="validate perfetto.json against the Chrome-trace "
                        "schema; exit non-zero on any problem")
    p.add_argument("--json", action="store_true", dest="as_json",
                   help="print the machine-readable summary instead of text")
    args = p.parse_args(argv)

    summary = summarize(args.run_dir, target=args.target)
    out_path = os.path.join(args.run_dir, "report.json")
    with open(out_path, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    summary["report_path"] = out_path

    if args.as_json:
        print(json.dumps(summary, indent=1, default=float))
    else:
        print(render(summary))
        print(f"\nreport   {out_path}")

    if args.check:
        from repro_torch.telemetry.perfetto import validate_chrome_trace

        pf_path = os.path.join(args.run_dir, "perfetto.json")
        if not os.path.exists(pf_path):
            print(f"CHECK FAIL: no perfetto.json under {args.run_dir!r}",
                  file=sys.stderr)
            return 1
        with open(pf_path) as f:
            doc = json.load(f)
        problems = validate_chrome_trace(doc)
        if problems:
            for msg in problems:
                print(f"CHECK FAIL: {msg}", file=sys.stderr)
            return 1
        n = len(doc["traceEvents"])
        print(f"check    perfetto.json OK ({n} events)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
