"""Faults planted under the timed path, for the control runs and the tests
that show the comparison catches them. Nothing in a benchmark run uses
this module.

Training: ``unchanged`` (the step's mix returns the params it was given,
so the step returns its state unchanged), ``half_batch`` (the loss over the
first half of each worker's rows, the mean taken over them; over the first
half of the sequence where a worker has one row), ``no_mix`` (the update
applied without the exchange between workers).
"""
from __future__ import annotations

import contextlib


class Fault:
    def __init__(self, name: str):
        if name not in ("unchanged", "half_batch", "no_mix"):
            raise ValueError(f"unknown fault {name!r}")
        self.name = name

    def loss(self, fn):
        if self.name != "half_batch":
            return fn

        def half(params, batch):
            t = batch["tokens"]
            t = t[: t.shape[0] // 2] if t.shape[0] > 1 else t[:, : t.shape[1] // 2 + 1]
            return fn(params, dict(batch, tokens=t))
        return half

    @contextlib.contextmanager
    def patch(self):
        from repro_torch import _tree
        from repro_torch.core import bus

        saved = bus.mix_bus
        if self.name == "unchanged":
            bus.mix_bus = lambda params, *a, **k: params
        elif self.name == "no_mix":
            bus.mix_bus = lambda params, *a, updates=None, **k: _tree.map(
                lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)
        try:
            yield
        finally:
            bus.mix_bus = saved
