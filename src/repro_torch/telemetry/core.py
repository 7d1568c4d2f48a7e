"""Run-scoped telemetry sink: spans, counters, gauges — zero overhead off.

The port of the reference's ``repro/telemetry/core.py``. One process-wide
*current sink* (module state, :func:`get` / :func:`install`) backs every
instrumented layer — the train loop, the gossip bus, and the simulator's
entry point all emit through it. Two implementations share the API:

* :class:`NullTelemetry` — the default. Every method is a no-op returning a
  cached null context manager; instrumented code pays one attribute check
  (``tel.active``) per hook and no device work or host sync. With the null
  sink installed an instrumented ``train()`` is bit-identical to the
  untelemetered one — no numerical state is ever touched.
* :class:`Telemetry` — in-memory event lists (spans / counters / gauges /
  instants) flushed to ``telemetry.json`` with a provenance header.

The port runs eagerly, so a hook fires every time its code runs: the bus
counters count calls (the reference counts compiles of a jitted program).

Use :func:`run` to scope a sink to a run directory::

    from repro_torch import telemetry
    with telemetry.run("results/runs/myrun") as tel:
        train(..., steps=100)            # emits through the current sink
    # -> results/runs/myrun/telemetry.json

Timestamps are host ``perf_counter`` seconds relative to sink creation;
simulator *virtual*-time series live in ``sim.Trace.gauges`` instead (the
engine owns virtual time), and the Perfetto exporter merges both.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any

__all__ = ["Telemetry", "NullTelemetry", "NULL", "get", "install",
           "enabled", "run"]


class _NullContext:
    """Reusable no-op context manager (one instance, zero allocation)."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullContext()


class NullTelemetry:
    """The disabled sink: every emit is a no-op, ``active`` is False."""

    active = False

    def span(self, name: str, **attrs):
        return _NULL_CTX

    def complete(self, name: str, ts: float, dur: float, **attrs) -> None:
        pass

    def counter(self, name: str, value: float = 1, **attrs) -> None:
        pass

    def gauge(self, name: str, value: float, t: float | None = None,
              **attrs) -> None:
        pass

    def instant(self, name: str, t: float | None = None, **attrs) -> None:
        pass

    def annotate(self, name: str):
        """Profiler annotation — a no-op context when disabled."""
        return _NULL_CTX

    def save(self, path: str | None = None) -> None:
        pass


NULL = NullTelemetry()


class _Span:
    __slots__ = ("_tel", "_name", "_attrs", "_t0")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self._tel, self._name, self._attrs = tel, name, attrs

    def __enter__(self):
        self._t0 = self._tel.now()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        self._tel.complete(self._name, t0, self._tel.now() - t0,
                           **self._attrs)
        return False


class Telemetry:
    """Recording sink; see module docstring.

    Args:
      run_dir: default directory :meth:`save` writes ``telemetry.json`` to
        (None → save only on explicit path).
      meta: free-form run metadata merged into the saved header.
    """

    active = True

    def __init__(self, run_dir: str | None = None,
                 meta: dict[str, Any] | None = None):
        self.run_dir = run_dir
        self.meta: dict[str, Any] = dict(meta or {})
        self._t0 = time.perf_counter()
        self.spans: list[dict] = []
        self.counters: dict[str, float] = {}
        self.gauges: list[dict] = []
        self.instants: list[dict] = []

    # -- clock ------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the sink was created (host wall clock)."""
        return time.perf_counter() - self._t0

    # -- emit -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager timing a host-side region."""
        return _Span(self, name, attrs)

    def complete(self, name: str, ts: float, dur: float, **attrs) -> None:
        """Record an already-measured span retroactively (amortized windows
        — e.g. one span per ``log_every`` train window)."""
        rec = {"name": name, "ts": float(ts), "dur": float(dur)}
        if attrs:
            rec["attrs"] = attrs
        self.spans.append(rec)

    def counter(self, name: str, value: float = 1, **attrs) -> None:
        self.counters[name] = self.counters.get(name, 0) + value

    def gauge(self, name: str, value: float, t: float | None = None,
              **attrs) -> None:
        rec = {"name": name, "t": self.now() if t is None else float(t),
               "value": float(value)}
        if attrs:
            rec["attrs"] = attrs
        self.gauges.append(rec)

    def instant(self, name: str, t: float | None = None, **attrs) -> None:
        rec = {"name": name, "t": self.now() if t is None else float(t)}
        if attrs:
            rec["attrs"] = attrs
        self.instants.append(rec)

    def annotate(self, name: str):
        """Profiler annotation: a ``torch.profiler.record_function`` range, so
        the region shows up named in a ``torch.profiler`` trace around the
        kernels it launches (the fused bus mix wraps its ``gossip_mix``
        launches with it)."""
        import torch

        return torch.profiler.record_function(name)

    # -- persistence ------------------------------------------------------

    def to_json(self) -> dict:
        from repro_torch.telemetry.provenance import provenance

        return {
            "provenance": provenance(),
            "meta": self.meta,
            "counters": dict(self.counters),
            "spans": list(self.spans),
            "gauges": list(self.gauges),
            "instants": list(self.instants),
        }

    def save(self, path: str | None = None) -> str | None:
        if path is None:
            if self.run_dir is None:
                return None
            path = os.path.join(self.run_dir, "telemetry.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, default=float)
        return path


# ---------------------------------------------------------------------------
# Current-sink plumbing
# ---------------------------------------------------------------------------

_CURRENT: NullTelemetry | Telemetry = NULL


def get() -> NullTelemetry | Telemetry:
    """The process-wide current sink (the null sink unless installed)."""
    return _CURRENT


def enabled() -> bool:
    return _CURRENT.active


def install(sink: NullTelemetry | Telemetry | None):
    """Set the current sink (None → the null sink); returns the previous."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = NULL if sink is None else sink
    return prev


@contextlib.contextmanager
def run(run_dir: str | None = None, meta: dict[str, Any] | None = None):
    """Scope a recording sink: install, yield it, save + restore on exit."""
    tel = Telemetry(run_dir=run_dir, meta=meta)
    prev = install(tel)
    try:
        yield tel
    finally:
        install(prev)
        tel.save()
