"""Whole runs on the CPU at a tiny size, past the harness's look for a card:
the comparison passes the program as it is and fails it with each fault
planted under the timed path; the control reads far above the program;
no run loads JAX or the JAX package."""
import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.drivers import train
from portbench.faults import Fault
from portbench.tests import tiny

CPU = torch.device("cpu")
TRAIN = ["granite.train.ring-m4", "dsv2lite.train.clique-m2", "granite.train.hypercube-m8"]
LOOSE = {"loss_gap": 1e-3, "grad_gap": 0.05, "change_gap": 0.05, "grad_med": 0.05}


def correct(run):
    return all(v["value"] <= v["limit"] for v in run["check"].values()) and not run["failed"]


@pytest.mark.parametrize("name", TRAIN)
def test_train_run_is_correct(name):
    cell = dict(tiny.cell(name), limits=LOOSE)
    run = train.run(cell, 2 ** 33 + 17, 0.2, True, CPU, setup_from=time.perf_counter())
    assert correct(run), run["check"]
    bench = harness.benchmark()
    e2e = harness.read_metrics(run, harness.metrics_of(name, bench, False))
    assert {"train_tokens_per_s", "train_peak_gb", "setup_s"} <= set(e2e)
    assert "mfu.train" in harness.read_metrics(run, harness.metrics_of(name, bench, True))


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mix"])
@pytest.mark.parametrize("name", TRAIN)
def test_train_fault_is_caught(name, fault):
    cell = dict(tiny.cell(name), limits=LOOSE)
    run = train.run(cell, 12345, 0.2, False, CPU, setup_from=time.perf_counter(),
                    fault=Fault(fault))
    assert not correct(run), run["check"]


def test_train_control_reads_far_above_program():
    cell = tiny.cell("granite.train.ring-m4")
    ref = train.reference_readings(cell, 21, CPU)
    ctl, _ = train.gaps(train.reference_readings(cell, 21, CPU, prec="fp8"), ref)
    prog, _ = train.gaps(train.program(cell, 21, CPU, seconds=0.1, trace=False)["readings"], ref)
    assert any(ctl[k] >= 3 * prog[k] for k in prog), (ctl, prog)


def test_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path[:0] = ['src', '.'];"
            "from portbench.tests import tiny; from portbench.drivers import train;"
            "from portbench import harness;"
            "c = dict(tiny.cell('granite.train.ring-m4'), limits={'loss_gap': 1, 'grad_gap': 1,"
            " 'change_gap': 1});"
            "train.run(c, 3, 0.1, False, torch.device('cpu'), setup_from=time.perf_counter());"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"


def test_run_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", "granite.train.ring-m4",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.gpu
def test_result_line_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "granite.train.hypercube-m8", "--seed", "5", "--seconds", "3",
                        "--trace", "0"], cwd=harness.ROOT, capture_output=True, text=True)
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
