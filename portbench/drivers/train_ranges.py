"""The training driver with ranges of its own, for cells whose parameters
mostly stand still in their stored dtype over the checked steps.

A run is ``drivers/train.run``'s: the program's set-up, window and traced
windows (``train.program``), then the plain reference's three steps
(``train.reference_readings``). Two things differ:

- In a traced run each function that the mix's ``ranges`` names
  (``{"<range>": "<module>:<attribute>"}``) is swapped for
  ``trace.wrap(fn, "<range>")`` and restored after. The swap is of the
  module's attribute, so it reaches every caller that looks the function up
  there (``ssm.mamba2_apply`` from the model, ``ssm.ssd_chunked`` from the
  mixer); a reader finds the device time launched inside in
  ``trace["ranges"]["portbench.<range>"]``, as ``optim_ms.train`` reads its
  range. A run without the trace swaps nothing.
- The comparison (:func:`gaps`) is ``train.gaps`` but for the tensors
  whose change it compares: those whose change the reference's steps left
  above zero. Where updates fall under half a unit in the last place of a
  tensor's stored values (Granite 4.0-H's norm scales and Mamba vectors at
  lr 0.01 in bf16, scaled down by its multipliers), a tensor does not
  change at all, or only in its few entries nearest zero, where one
  rounding more or less on either side reads as a large gap; ``train.gaps``
  would take 0 for the median that scales the change and divide by it.
  Over the tensors that moved, the median gap (``change_med``) is what
  separates a mix left out from rounding, while the largest
  (``change_gap``) still lands on the conv's rounding.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import statistics

import torch

from portbench import trace as tr
from portbench.drivers import train


@contextlib.contextmanager
def ranges(spec: dict):
    saved = []
    try:
        for name, target in spec.items():
            module, attr = target.split(":")
            mod = importlib.import_module(module)
            saved.append((mod, attr, getattr(mod, attr)))
            setattr(mod, attr, tr.wrap(getattr(mod, attr), name))
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def gaps(prog: dict, ref: dict) -> tuple[dict, dict]:
    """``train.gaps``'s numbers, the change compared over the tensors that
    the reference's steps moved: a first gradient at least a thousandth of
    the median tensor's, as there, and a change above zero."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - g) / max(g, med_g) for n, g in ref["grad"].items()}
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g and ref["change"][n] > 0]
    med_c = statistics.median(ref["change"][n] for n in moved)
    change = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
              for n in moved}
    worst = {"grad": max(grad, key=grad.get), "change": max(change, key=change.get)}
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_med": statistics.median(grad.values()), "change_gap": max(change.values()),
            "change_med": statistics.median(change.values())}, worst


def run(cell: dict, seed: int, seconds: float, trace: bool, device, *, setup_from: float,
        fault=None) -> dict:
    with fault.patch() if fault is not None else contextlib.nullcontext(), \
            ranges(cell["mix"].get("ranges", {})) if trace else contextlib.nullcontext():
        run_ = train.program(cell, seed, device, seconds=seconds, trace=trace, fault=fault)
    run_["setup_s"] = run_["t_window"] - setup_from
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers, worst = gaps(run_["readings"], train.reference_readings(cell, seed, device))
    run_["check"] = {k: {"value": numbers[k], "limit": v} for k, v in cell["limits"].items()}
    run_["numbers"], run_["worst"] = numbers, worst
    run_["attempted"] = run_["steps"]
    return run_
