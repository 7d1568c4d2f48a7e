"""The port's spans read from a trace: device time by launch on hand-built
events, the splits from it, and the probe run whole on the CPU at a tiny
size."""
from types import SimpleNamespace

import pytest
import torch

from portbench import spans
from portbench.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def ev(name, start, end, *, device=False, corr=0, annotation=False):
    return SimpleNamespace(name=name, id=corr, is_user_annotation=annotation,
                           device_type=CUDA if device else CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def trace():
    """train.grad (main thread, 0–100 µs) around train.forward (0–40) and a
    recompute (on another thread, 60–70); kernels launched in each, one in
    train.grad itself (the backward), one outside every span, one whose
    launch the trace lost; the ranges' own device annotations."""
    return [
        ev("train.grad", 0, 100), ev("train.forward", 0, 40),
        ev("model.remat.recompute", 60, 70),
        ev("cudaLaunchKernel", 10, 11, corr=1), ev("fwd_kernel", 12, 30, device=True, corr=1),
        ev("cudaLaunchKernel", 50, 51, corr=2), ev("bwd_kernel", 52, 60, device=True, corr=2),
        ev("cudaLaunchKernel", 65, 66, corr=3), ev("re_kernel", 66, 70, device=True, corr=3),
        ev("cudaMemcpyAsync", 120, 121, corr=4), ev("Memcpy HtoD", 121, 125, device=True, corr=4),
        ev("lost_kernel", 130, 131, device=True, corr=5),
        ev("train.grad", 12, 70, device=True, corr=6, annotation=True),
        ev("portbench.feed", 120, 125, device=True, corr=7, annotation=True),
    ]


def test_device_ops_drop_annotations_of_any_name():
    names = [e.name for e in spans.device_ops(trace())]
    assert names == ["fwd_kernel", "bwd_kernel", "re_kernel", "Memcpy HtoD", "lost_kernel"]


def test_attribute_by_innermost_launch():
    got = spans.attribute(trace(), ["train.grad", "train.forward", "model.remat.recompute",
                                    "train.optim"])
    assert {n: c for n, (c, _) in got["spans"].items()} == {
        "train.grad": 1, "train.forward": 1, "model.remat.recompute": 1, "train.optim": 0}
    assert {n: s for n, (_, s) in got["spans"].items()} == pytest.approx(
        {"train.grad": 8e-6, "train.forward": 18e-6, "model.remat.recompute": 4e-6,
         "train.optim": 0.0})
    assert got["outside_s"] == pytest.approx(5e-6)


def test_layers_read_the_splits_or_none():
    cfg = tiny.cell("granite.train.ring-m4")["cfg"]
    by_span = {n: [0, 0.0] for n in spans.SPANS}
    by_span.update({"train.forward": [2, 0.02], "train.grad": [2, 0.04],
                    "model.remat.recompute": [4, 0.01], "bus.mix": [2, 0.001],
                    "bus.pack": [2, 0.002], "bus.fused_mix": [2, 0.003],
                    "bus.kernel": [2, 0.004]})
    from portbench import yardstick as Y

    bound = Y.mix_bytes(cfg, 4)
    got = spans.layers(by_span, {"bus.bytes_kernel": 10 * bound}, 2, cfg, 4)
    assert got["fwd_ms"] == pytest.approx(10.0) and got["bwd_ms"] == pytest.approx(20.0)
    assert got["recompute_ms"] == pytest.approx(5.0)
    assert got["bus_copy_ms"] == pytest.approx(3.0)
    assert got["gossip_roofline"] == pytest.approx(100 * bound / Y.HBM_BYTES_PER_S / 0.002)
    assert got["bus_bytes_x"] == pytest.approx(5.0)
    none = spans.layers({n: [0, 0.0] for n in spans.SPANS}, {}, 2, cfg, 4)
    assert none["gossip_roofline"] is None and none["bus_bytes_x"] is None


def test_probe_runs_a_cell_on_the_cpu():
    out = spans.probe(tiny.cell("granite.train.ring-m4"), 2 ** 33 + 5, torch.device("cpu"),
                      cost_s=0.01, cost_windows=2)
    w = out["sink_window"]
    n = w["steps"]
    assert {k: v[0] for k, v in w["spans"].items()} == {
        s: 2 * n if s == "model.remat.recompute" else n for s in spans.SPANS}
    assert w["counters"]["bus.mix_calls"] == n and w["counters"]["bus.bytes_unpacked"] == 0
    # M = 4 on the ring: params and updates packed, 2 stacks gathered, the kernel
    # reads 4 buffers and writes 1: (7 + 3·2) / 3 of the least bytes, and padding
    assert 13 / 3 <= w["layers"]["bus_bytes_x"] < 13 / 3 * 1.1
    assert len(out["cost"]["off"]) == len(out["cost"]["on"]) == 1
    assert set(out["driver_window"]["ranges"]) == set(out["driver_window"]["wrappers_by_launch"]) \
        == {"portbench.optim", "portbench.mix", "portbench.stats"}
