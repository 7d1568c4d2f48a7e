"""Run-scoped telemetry sink: spans, counters, gauges — zero overhead off.

The port of the reference's ``repro/telemetry/core.py``. One process-wide
*current sink* (module state, :func:`get` / :func:`install`) backs every
instrumented layer — the train step, the gossip bus, remat's recompute,
the train loop and the simulator's entry point all emit through it. Two
implementations share the API:

* :class:`NullTelemetry` — the default. Every method is a no-op and
  :meth:`~NullTelemetry.span` returns one shared null context manager;
  instrumented code pays one attribute check or one call per hook and no
  device work, host sync or allocation. With the null sink installed an
  instrumented step is bit-identical to the untelemetered one — no
  numerical state is ever touched.
* :class:`Telemetry` — in-memory event lists (spans / counters / gauges /
  instants) flushed to ``telemetry.json`` with a provenance header.

A span on an active sink is one region on two records: a
``torch.profiler.record_function`` range of the same name, so a
``torch.profiler`` trace shows it around the kernels launched inside it,
and a host interval in the sink, ``{name, ts, dur, parent, thread}``.
``parent`` is the name of the innermost span still open in the current
``contextvars`` context (None at the top); ``thread`` is the native id of
the thread that ran it. Remat's recompute runs on autograd's device thread
in a copy of the forward's context, after the forward's span has closed, so
its parent is the span around the whole gradient.

The spans the port emits:

* ``train.step`` (``core.decentralized`` step, both modes) holding
  ``train.grad`` (forward, backward and recompute; the backward is its own
  time), ``train.forward`` (the loss function under the vmapped
  ``grad_and_value``), ``train.optim`` (the optimizer's update) and
  ``train.stats`` (the step's metrics);
* ``model.remat.recompute`` (``models.remat``): the recomputed forward of
  one layer in the backward pass, its backward left out;
* ``bus.mix`` (``core.bus.mix_bus``, every path) holding ``bus.pack``,
  ``bus.fused_mix`` (the neighbour gathers or exchanges and the kernel
  launches; its own time is the gathers), ``bus.kernel`` (each
  ``gossip_mix`` launch) and ``bus.unpack``; ``bus.compressed_mix``
  (``core.bus.mix_bus_compressed``);
* ``train.host_sync`` and the retroactive ``train.window`` (``train.loop``).

The port runs eagerly, so a hook fires every time its code runs: the bus
counters count calls (the reference counts compiles of a jitted program),
and the bus's byte counters (``bus.bytes_packed``, ``bus.bytes_gathered``,
``bus.bytes_kernel``, ``bus.bytes_unpacked``) add each call's bytes read
plus written, worked out from the tensors' sizes on the host.

Use :func:`run` to scope a sink to a run directory::

    from repro_torch import telemetry
    with telemetry.run("results/runs/myrun") as tel:
        train(..., steps=100)            # emits through the current sink
    # -> results/runs/myrun/telemetry.json

Timestamps are host ``perf_counter`` seconds relative to sink creation.
``telemetry.json`` keeps the clock's origin (``clock``: ``perf_counter_ns``
and ``unix_ns`` read together at creation); ``torch.profiler`` stamps its
events in Unix nanoseconds, so ``unix_ns + ts·1e9`` lays a span over a
profiler trace of the same process. Simulator *virtual*-time series live in
``sim.Trace.gauges`` instead (the engine owns virtual time), and the
Perfetto exporter merges both.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import threading
import time
from typing import Any

import torch

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

    def save(self, path: str | None = None) -> None:
        pass


NULL = NullTelemetry()


# The innermost span open in the current context (a _Span, or None).
_OPEN: contextvars.ContextVar = contextvars.ContextVar("repro_torch_span", default=None)


def _open_parent() -> "_Span | None":
    """The innermost span of the current context that is still open: a
    context copied while a span was open (remat's recompute) may outlive it."""
    up = _OPEN.get()
    while up is not None and up.closed:
        up = up.up
    return up


class _Span:
    __slots__ = ("_tel", "name", "_attrs", "_t0", "_range", "_token", "up", "closed")

    def __init__(self, tel: "Telemetry", name: str, attrs: dict):
        self._tel, self.name, self._attrs = tel, name, attrs
        self.closed = False

    def __enter__(self):
        self.up = _open_parent()
        self._token = _OPEN.set(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = self._tel.now()
        return self

    def __exit__(self, *exc):
        t0 = self._t0
        dur = self._tel.now() - t0
        self._range.__exit__(*exc)
        self.closed = True
        _OPEN.reset(self._token)
        self._tel._record(self.name, t0, dur, self.up, self._attrs)
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
        self._t0_ns = time.perf_counter_ns()
        self._unix0_ns = time.time_ns()
        self.spans: list[dict] = []
        self.counters: dict[str, float] = {}
        self.gauges: list[dict] = []
        self.instants: list[dict] = []

    # -- clock ------------------------------------------------------------

    def now(self) -> float:
        """Seconds since the sink was created (host monotonic clock)."""
        return (time.perf_counter_ns() - self._t0_ns) * 1e-9

    # -- emit -------------------------------------------------------------

    def span(self, name: str, **attrs):
        """Context manager over a region: a ``torch.profiler`` range named
        ``name`` and a host interval in :attr:`spans` (module docstring)."""
        return _Span(self, name, attrs)

    def complete(self, name: str, ts: float, dur: float, **attrs) -> None:
        """Record an already-measured span retroactively (amortized windows
        — e.g. one span per ``log_every`` train window); it has no
        profiler range."""
        self._record(name, ts, dur, _open_parent(), attrs)

    def _record(self, name: str, ts: float, dur: float, parent, attrs: dict) -> None:
        rec = {"name": name, "ts": float(ts), "dur": float(dur),
               "parent": None if parent is None else parent.name,
               "thread": threading.get_native_id()}
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

    # -- persistence ------------------------------------------------------

    def to_json(self) -> dict:
        from repro_torch.telemetry.provenance import provenance

        return {
            "provenance": provenance(),
            "meta": self.meta,
            "clock": {"perf_counter_ns": self._t0_ns, "unix_ns": self._unix0_ns},
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
