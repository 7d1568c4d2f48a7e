"""The two cells that Granite 4.0-H's configuration brought, run whole on
the CPU at a tiny size: the comparison passes the program and fails it
with each fault planted, and with each bug planted in the Mamba-2 mixer
(the cross-chunk state dropped, the conv's taps reversed) at the cell's own
limits; the float8 control reads far above the program;
the ranges driver swaps its functions for a traced run only, and puts
them back."""
import time

import pytest
import torch

from portbench import control_any, harness
from portbench.drivers import train, train_ranges
from portbench.faults import Fault

CPU = torch.device("cpu")
LOOSE = {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05}
HYBRID = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
              intermediate_size=128, shared_intermediate_size=128, vocab_size=256,
              num_hidden_layers=4, layer_types=["mamba", "mamba", "attention", "mamba"],
              mamba_n_heads=4, mamba_d_head=16, mamba_expand=1, mamba_d_state=16,
              mamba_chunk_size=8, torch_dtype="float32")
GRANITE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
               intermediate_size=128, vocab_size=256, num_hidden_layers=2,
               attention_multiplier=16 ** -0.5)
CELLS = {"granite4h.train.clique-m2-4k": (HYBRID, 32),
         "granite.train.onepeer-m8": (GRANITE, 16)}


def tiny(name: str) -> dict:
    over, seq = CELLS[name]
    c = harness.cell(name)
    c["cfg"].update(over)
    c["mix"].update(batch_per_worker=min(2, c["mix"]["batch_per_worker"]), seq_len=seq)
    return dict(c, limits=LOOSE)


def correct(run):
    return all(v["value"] <= v["limit"] for v in run["check"].values()) and not run["failed"]


@pytest.mark.parametrize("name", list(CELLS))
def test_cell_is_correct_and_reports_its_metrics(name):
    cell = tiny(name)
    run = harness.driver(cell["driver"]).run(cell, 2 ** 40 + 9, 0.1, True, CPU,
                                             setup_from=time.perf_counter())
    assert correct(run), run["check"]
    bench = harness.benchmark()
    e2e = harness.read_metrics(run, harness.metrics_of(name, bench, False))
    assert {"train_tokens_per_s", "train_peak_gb", "setup_s"} <= set(e2e)
    wanted = {m["name"] for m in harness.metrics_of(name, bench, True)}
    assert ({"ssm_ms.train", "ssd_ms.train"} <= wanted) == name.startswith("granite4h")
    if name.startswith("granite4h"):
        assert {"portbench.ssm", "portbench.scan"} <= set(run["trace"]["ranges"])
        # the scan runs inside the mixer: every scan range within a mixer range
        assert run["trace"]["ranges"]["portbench.scan"][0] == \
            run["trace"]["ranges"]["portbench.ssm"][0]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mix"])
@pytest.mark.parametrize("name", list(CELLS))
def test_fault_is_caught(name, fault):
    cell = tiny(name)
    run = harness.driver(cell["driver"]).run(cell, 12345, 0.1, False, CPU,
                                             setup_from=time.perf_counter(), fault=Fault(fault))
    assert not correct(run), run["check"]


@pytest.mark.parametrize("plant", list(control_any.PLANTS))
def test_planted_mixer_bug_is_caught(plant):
    name = "granite4h.train.clique-m2-4k"
    cell = dict(tiny(name), limits=harness.cell(name)["limits"])
    run = train_ranges.run(cell, 12345, 0.1, False, CPU, setup_from=time.perf_counter())
    assert correct(run), run["check"]
    with control_any.PLANTS[plant]():
        run = train_ranges.run(cell, 12345, 0.1, False, CPU, setup_from=time.perf_counter())
    assert not correct(run), run["check"]


def test_hybrid_control_reads_far_above_program():
    cell = tiny("granite4h.train.clique-m2-4k")
    ref = train.reference_readings(cell, 21, CPU)
    ctl, _ = train_ranges.gaps(train.reference_readings(cell, 21, CPU, prec="fp8"), ref)
    prog, _ = train_ranges.gaps(train.program(cell, 21, CPU, seconds=0.1, trace=False)["readings"],
                                ref)
    assert any(ctl[k] >= 3 * prog[k] for k in prog), (ctl, prog)


def test_ranges_swap_for_the_traced_run_only():
    from repro_torch.models import ssm

    plain = ssm.mamba2_apply, ssm.ssd_chunked
    spec = harness.cell("granite4h.train.clique-m2-4k")["mix"]["ranges"]
    with train_ranges.ranges(spec):
        assert ssm.mamba2_apply.__wrapped__ is plain[0]
        assert ssm.ssd_chunked.__wrapped__ is plain[1]
    assert (ssm.mamba2_apply, ssm.ssd_chunked) == plain
    with pytest.raises(RuntimeError), train_ranges.ranges(spec):
        raise RuntimeError("the swap is undone on the way out")
    assert (ssm.mamba2_apply, ssm.ssd_chunked) == plain
