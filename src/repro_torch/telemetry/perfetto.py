"""Chrome-trace / Perfetto export of simulator traces (and telemetry sinks).

A plain-Python copy of the reference's ``repro/telemetry/perfetto.py``.

``trace_to_perfetto`` renders a :class:`repro_torch.sim.trace.Trace` losslessly
into the Chrome trace-event JSON format (the ``ui.perfetto.dev`` /
``chrome://tracing`` input): every trace record becomes a timeline event,

* one lane (thread) per worker under the ``workers`` process — per-round
  duration slices (with the train-batch loss in args), ``barrier-stall``
  windows ending at each TIMEOUT, ``down`` windows between FAIL and JOIN,
  instants for timeouts / degraded commits / step-failures / rejoins;
* per-link-class lanes under the ``links`` process — each ARRIVAL is a
  duration slice spanning its wire time (bytes / retried flag in args), and
  ``LinkFault`` DOWN windows render as ``fault`` slices on a per-class fault
  lane;
* counter tracks under the ``health`` process for the gossip-health gauges
  (``Trace.gauges`` — spectral gap / effective neighbors steps at every
  churn repair or fault window) and the recorded eval-loss curve.

Virtual time maps to microseconds 1:1 (1 vtime unit = 1 s of timeline), so
durations read naturally in the Perfetto UI.

``validate_chrome_trace`` is the schema check CI gates the emitted artifact
on; ``save_perfetto`` writes the JSON file.
"""
from __future__ import annotations

import json
import os
from typing import Any

__all__ = ["trace_to_perfetto", "save_perfetto", "validate_chrome_trace",
           "TIME_SCALE"]

# virtual-time unit → chrome trace microseconds
TIME_SCALE = 1e6

_PID_WORKERS = 1
_PID_LINKS = 2
_PID_HEALTH = 3

_LINK_TID = {"ici": 1, "dci": 2, None: 0}
_FAULT_TID = {"ici": 11, "dci": 12}


def _meta(pid: int, name: str, tid: int | None = None,
          thread_name: str | None = None) -> list[dict]:
    out = [{"ph": "M", "name": "process_name", "pid": pid,
            "args": {"name": name}}]
    if tid is not None:
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": thread_name}})
    return out


def trace_to_perfetto(trace, *, group_of=None) -> dict:
    """Render a sim Trace to a Chrome-trace JSON document (see module doc).

    Args:
      trace: a ``repro_torch.sim.trace.Trace`` (or anything with ``records`` /
        ``evals`` / ``gauges`` / ``meta`` / ``M`` in that shape).
      group_of: optional per-worker pod ids for lane naming; defaults to the
        pod assignment in ``trace.meta['mesh']`` when present.
    """
    from repro_torch.sim.trace import (ARRIVAL, COMPUTE_DONE, FAIL, JOIN,
                                       LINK_DOWN, LINK_UP, SWITCH, TIMEOUT)

    records = trace.records
    t_last = records[-1].t if records else 0.0
    if group_of is None:
        group_of = (trace.meta.get("mesh") or {}).get("group_of")

    events: list[dict] = []
    events += _meta(_PID_WORKERS, "workers")
    events += _meta(_PID_LINKS, "links")
    events += _meta(_PID_HEALTH, "health")
    seen_link_tids: set[int] = set()
    for j in range(trace.M):
        pod = f" (pod {group_of[j]})" if group_of is not None else ""
        events += _meta(_PID_WORKERS, "workers", tid=j,
                        thread_name=f"worker {j}{pod}")[1:]

    def x(pid, tid, name, t0, t1, **args) -> dict:
        ev = {"ph": "X", "pid": pid, "tid": tid, "name": name,
              "ts": t0 * TIME_SCALE, "dur": max(t1 - t0, 0.0) * TIME_SCALE}
        if args:
            ev["args"] = args
        return ev

    def inst(pid, tid, name, t, **args) -> dict:
        ev = {"ph": "i", "s": "t", "pid": pid, "tid": tid, "name": name,
              "ts": t * TIME_SCALE}
        if args:
            ev["args"] = args
        return ev

    # (worker, round) pairs whose barrier deadline fired — their commit is a
    # degraded (survivor-column) commit, rendered as an instant on top of
    # the round slice.
    timed_out = {(r.worker, r.round) for r in records if r.kind == TIMEOUT}

    cursor = [0.0] * trace.M          # left edge of the next round slice
    down_since: dict[int, float] = {}  # worker -> FAIL time
    fault_open: dict[tuple[str, int], float] = {}  # (class, pod) -> t

    for r in records:
        if r.kind == COMPUTE_DONE:
            if r.retried:
                events.append(inst(_PID_WORKERS, r.worker, "step-failure",
                                   r.t, round=r.round))
                continue
            args: dict[str, Any] = {"round": r.round}
            if r.loss is not None:
                args["loss"] = r.loss
            if (r.worker, r.round) in timed_out:
                args["degraded"] = True
                events.append(inst(_PID_WORKERS, r.worker, "degraded-commit",
                                   r.t, round=r.round))
            events.append(x(_PID_WORKERS, r.worker, f"round {r.round}",
                            cursor[r.worker], r.t, **args))
            cursor[r.worker] = r.t
        elif r.kind == TIMEOUT:
            events.append(x(_PID_WORKERS, r.worker, "barrier-stall",
                            cursor[r.worker], r.t, round=r.round))
            events.append(inst(_PID_WORKERS, r.worker, "barrier-timeout",
                               r.t, round=r.round))
        elif r.kind == ARRIVAL:
            tid = _LINK_TID.get(r.link_class, 0)
            if tid not in seen_link_tids:
                seen_link_tids.add(tid)
                events += _meta(_PID_LINKS, "links", tid=tid,
                                thread_name=r.link_class or "msg")[1:]
            args = {"round": r.round}
            if r.nbytes:
                args["bytes"] = r.nbytes
            if r.retried:
                args["retried"] = True
            events.append(x(_PID_LINKS, tid, f"{r.src}→{r.worker}",
                            r.t - r.wire_time, r.t, **args))
        elif r.kind == FAIL:
            down_since[r.worker] = r.t
            cursor[r.worker] = r.t
        elif r.kind == JOIN:
            t0 = down_since.pop(r.worker, None)
            if t0 is not None:
                events.append(x(_PID_WORKERS, r.worker, "down", t0, r.t))
            events.append(inst(_PID_WORKERS, r.worker, "rejoin", r.t))
            cursor[r.worker] = r.t
        elif r.kind == SWITCH:
            events.append({"ph": "i", "s": "g", "pid": _PID_WORKERS, "tid": 0,
                           "name": "topology-switch", "ts": r.t * TIME_SCALE})
        elif r.kind == LINK_DOWN:
            fault_open.setdefault((r.link_class, r.src), r.t)
        elif r.kind == LINK_UP:
            t0 = fault_open.pop((r.link_class, r.src), None)
            if t0 is not None:
                tid = _FAULT_TID.get(r.link_class, 10)
                events += _meta(_PID_LINKS, "links", tid=tid,
                                thread_name=f"{r.link_class}-faults")[1:]
                pod = "all" if r.src < 0 else r.src
                events.append(x(_PID_LINKS, tid, f"fault pod={pod}", t0, r.t,
                                link_class=r.link_class))
    # unterminated windows close at the trace horizon
    for j, t0 in down_since.items():
        events.append(x(_PID_WORKERS, j, "down", t0, t_last))
    for (cls, pod), t0 in fault_open.items():
        tid = _FAULT_TID.get(cls, 10)
        events += _meta(_PID_LINKS, "links", tid=tid,
                        thread_name=f"{cls}-faults")[1:]
        events.append(x(_PID_LINKS, tid,
                        f"fault pod={'all' if pod < 0 else pod}", t0, t_last,
                        link_class=cls))

    for g in getattr(trace, "gauges", []):
        events.append({"ph": "C", "pid": _PID_HEALTH, "name": g.name,
                       "ts": g.t * TIME_SCALE, "args": {"value": g.value}})
    for e in trace.evals:
        events.append({"ph": "C", "pid": _PID_HEALTH, "name": "eval_loss",
                       "ts": e.t * TIME_SCALE, "args": {"value": e.value}})

    events.sort(key=lambda ev: (ev.get("ts", -1.0), ev["ph"] != "M"))
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"meta": dict(trace.meta), "M": trace.M,
                      "time_scale": TIME_SCALE},
    }


def save_perfetto(trace, path: str, **kw) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    doc = trace_to_perfetto(trace, **kw)
    with open(path, "w") as f:
        json.dump(doc, f, default=float)
    return path


# ---------------------------------------------------------------------------
# Schema check (the CI gate on emitted artifacts)
# ---------------------------------------------------------------------------

_KNOWN_PH = {"X", "B", "E", "i", "I", "C", "M", "b", "e", "n", "s", "t", "f"}


def validate_chrome_trace(doc: Any) -> list[str]:
    """Structural validation of a Chrome-trace JSON document.

    Returns a list of human-readable problems (empty ⇒ valid). Checks the
    invariants Perfetto's importer relies on: a ``traceEvents`` array whose
    entries carry a known phase, numeric non-negative timestamps/durations
    on timed events, pids/tids where required, and numeric counter values.
    """
    errors: list[str] = []
    if not isinstance(doc, dict):
        return [f"document must be a JSON object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing traceEvents array"]
    if not events:
        errors.append("traceEvents is empty")
    num = (int, float)
    for n, ev in enumerate(events):
        where = f"traceEvents[{n}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in _KNOWN_PH:
            errors.append(f"{where}: unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing/non-string name")
        if ph != "M":
            ts = ev.get("ts")
            if not isinstance(ts, num) or isinstance(ts, bool) or ts < 0:
                errors.append(f"{where}: bad ts {ts!r}")
        if "pid" in ev and not isinstance(ev["pid"], int):
            errors.append(f"{where}: non-int pid {ev['pid']!r}")
        elif "pid" not in ev:
            errors.append(f"{where}: missing pid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, num) or isinstance(dur, bool) or dur < 0:
                errors.append(f"{where}: X event bad dur {dur!r}")
            if "tid" not in ev:
                errors.append(f"{where}: X event missing tid")
        if ph == "C":
            args = ev.get("args")
            if not isinstance(args, dict) or not args or not all(
                    isinstance(v, num) and not isinstance(v, bool)
                    for v in args.values()):
                errors.append(f"{where}: C event needs numeric args")
        if len(errors) > 50:
            errors.append("... (truncated)")
            break
    return errors
