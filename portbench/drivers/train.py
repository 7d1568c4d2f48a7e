"""The training driver: the port's decentralized step (eq. 3), driven as
``repro_torch.train.train`` drives it, but bounded by time.

Set-up builds one step object over M replicas of the seeded weights and
the optimizer's state, and drives it through three steps on the
window's own feed (a fresh (M, batch, seq_len + 1) token block from the
card's generator every step): the comparison reads their losses, the first
gradient as the optimizer's state holds it after step one, and the change
of every parameter after step three. Four more steps, dispatched back to
back as the window dispatches its steps, time a step, which sizes the
window to ``--seconds``. The window runs that many steps and ends
in a synchronize; the peak memory is that of the window. With the trace, a
few more steps run under the profiler twice: first with the card's
activity alone recorded, which slows the host least (the card's busy
time), then with the host's operations too and the
optimizer's update, ``core.bus.mix_bus`` and
``core.decentralized.step_metrics`` in named ranges (the layers' device
time). Then the program's state is freed, and the plain reference follows
the first three steps from the same seeded weights and tokens.

The mix names its topology and optimizer (``port.gossip``,
``port.optimizer``); the reference takes the matrices and the optimizer's
arithmetic from its own files of the same names.

``train()`` itself takes a step count, not a time, and builds its own state
from the initial params, so it cannot hand the state the comparison read to
the window; this loop is its body without the host-side logging.
"""
from __future__ import annotations

import dataclasses
import contextlib
import gc
import statistics
import time

import torch

from portbench import harness, port, trace as tr, weights
from portbench.reference import plain

CHECK_STEPS = 3
TIMING_STEPS = 4


def _norms(named: dict[str, torch.Tensor]) -> dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t, dtype=torch.float32)) for n, t in named.items()}


def feed(gen: torch.Generator, M: int, B: int, L: int, V: int, device) -> torch.Tensor:
    return torch.randint(0, V, (M, B, L + 1), generator=gen, device=device)


def gaps(prog: dict, ref: dict) -> tuple[dict, dict]:
    """The numbers compared, and the tensor each worst one is at.

    ``loss_gap``: the largest relative gap of the mean loss over steps 1–3.
    Per tensor (each layer's leaf apart), the gap between the program's and
    the reference's norm of the first gradient over the larger of the
    reference's norm and the median tensor's: ``grad_gap`` its largest,
    ``grad_med`` its median over the tensors. The same for the change of
    the parameters after step 3 (``change_gap``, ``change_med``), over the
    tensors whose first reference gradient is at least a thousandth of the
    median tensor's."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    med_g = statistics.median(ref["grad"].values())
    grad = {n: abs(prog["grad"][n] - g) / max(g, med_g) for n, g in ref["grad"].items()}
    moved = [n for n, g in ref["grad"].items() if g >= 1e-3 * med_g]
    med_c = statistics.median(ref["change"][n] for n in moved)
    change = {n: abs(prog["change"][n] - ref["change"][n]) / max(ref["change"][n], med_c)
              for n in moved}
    worst = {"grad": max(grad, key=grad.get), "change": max(change, key=change.get)}
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "grad_med": statistics.median(grad.values()), "change_gap": max(change.values()),
            "change_med": statistics.median(change.values())}, worst


def reference_readings(cell: dict, seed: int, device, prec: str = "fp32") -> dict:
    """The plain reference's three steps from the run's seeded weights and
    tokens: losses, first-gradient norms and change norms per tensor."""
    c, mix = cell["cfg"], cell["mix"]
    plain.no_tf32()
    ref = harness.reference(c["model_type"])
    W = weights.make(c, harness.sub_seed(seed, "weights"), device)
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "tokens"))
    M, B, L = mix["workers"], mix["batch_per_worker"], mix["seq_len"]
    batches = [feed(gen, M, B, L, c["vocab_size"], device) for _ in range(CHECK_STEPS)]
    g, opt = mix["gossip"], mix["optimizer"]
    topo = harness.reference_topology(g["topology"])
    losses, grad, change = plain.train_steps(
        lambda p, t, pr: ref.loss(p, c, t, pr), W,
        lambda k: topo.matrix(k, **g.get("args", {})), batches,
        opt=harness.reference_optimizer(opt["name"]), opt_args=opt.get("args", {}), prec=prec,
        dtype=weights.dtype_of(c))
    return {"losses": losses, "grad": grad, "change": change}


def program(cell: dict, seed: int, device, *, seconds: float, trace: bool,
            fault=None) -> dict:
    """Set-up, the window and, with ``trace``, the profiled steps of the
    program; returns the run's record with the comparison's readings."""
    from repro_torch.core import bus, decentralized as Dc
    from repro_torch.models import model as Mo

    c, mix = cell["cfg"], cell["mix"]
    cfg = port.model_config(c, cell["config"])
    M, B, L = mix["workers"], mix["batch_per_worker"], mix["seq_len"]
    opt = port.optimizer(mix["optimizer"])
    opt_ref = harness.reference_optimizer(mix["optimizer"]["name"])
    if trace:
        opt = dataclasses.replace(opt, update=tr.wrap(opt.update, "optim"))
    loss_fn = lambda p, b: Mo.loss_fn(p, cfg, b)
    if fault is not None:
        loss_fn = fault.loss(loss_fn)
    step = Dc.make_train_step(loss_fn, opt, gossip=port.gossip(mix["gossip"], M),
                              mode=mix["mode"])

    p0 = port.program_params(cfg, weights.make(c, harness.sub_seed(seed, "weights"), device))
    state = Dc.init_state(Dc.replicate_for_workers(p0, M), opt)
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, "tokens"))
    batch = lambda: {"tokens": feed(gen, M, B, L, c["vocab_size"], device)}
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)

    losses = []
    for k in range(CHECK_STEPS):
        state, m = step(state, batch())
        losses.append(m.loss)
        if k == 0:
            grad = _norms(port.benchmark_names(cfg, opt_ref.first_gradient(state.opt_state),
                                               lead=1))
    start = port.benchmark_names(cfg, p0)
    change = _norms({n: t - start[n] for n, t in port.benchmark_names(cfg, state.params,
                                                                      lead=1).items()})
    del p0, start
    sync()
    t = time.perf_counter()
    for _ in range(TIMING_STEPS):
        state, m = step(state, batch())
    sync()
    step_s = (time.perf_counter() - t) / TIMING_STEPS
    n_steps = max(2, round(seconds / step_s))

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_losses = []
    t0 = time.perf_counter()
    for _ in range(n_steps):
        state, m = step(state, batch())
        window_losses.append(m.loss)
    sync()
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    window_losses = torch.stack(window_losses).float().cpu()

    traced = None
    if trace:
        traced = {"steps": max(2, min(8, round(1.5 / step_s))), "busy": {}}
        with tr.device_only(traced["busy"], device):
            for _ in range(traced["steps"]):
                state, m = step(state, batch())
        saved = bus.mix_bus, Dc.step_metrics
        bus.mix_bus, Dc.step_metrics = tr.wrap(bus.mix_bus, "mix"), tr.wrap(Dc.step_metrics,
                                                                             "stats")
        try:
            with tr.profiled(traced, device):
                for _ in range(traced["steps"]):
                    state, m = step(state, batch())
        finally:
            bus.mix_bus, Dc.step_metrics = saved
    return {"kind": "train", "cfg": c, "mix": mix, "window_s": window_s, "t_window": t0,
            "steps": n_steps, "step_s": step_s, "tokens": n_steps * M * B * L,
            "peak_bytes": peak, "failed": int((~torch.isfinite(window_losses)).sum()),
            "trace": traced,
            "readings": {"losses": [float(x) for x in losses], "grad": grad, "change": change}}


def run(cell: dict, seed: int, seconds: float, trace: bool, device, *, setup_from: float,
        fault=None) -> dict:
    with fault.patch() if fault is not None else contextlib.nullcontext():
        run_ = program(cell, seed, device, seconds=seconds, trace=trace, fault=fault)
    run_["setup_s"] = run_["t_window"] - setup_from
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(cell, seed, device)
    numbers, worst = gaps(run_["readings"], ref)
    run_["check"] = {k: {"value": numbers[k], "limit": v} for k, v in cell["limits"].items()}
    run_["numbers"], run_["worst"] = numbers, worst
    run_["attempted"] = run_["steps"]
    return run_
