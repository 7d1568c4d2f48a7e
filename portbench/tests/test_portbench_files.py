"""Every file of the benchmark parses, and names only what exists."""
import json
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parents[1]
BENCH = harness.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("name", CELLS)
def test_workload_file_matches_benchmark(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.cell(name)
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == entry[k], k
    assert cell["driver"] == cell["mix"]["driver"]
    assert (HERE / "drivers" / f"{cell['driver']}.py").exists()
    assert (HERE / "reference" / f"{cell['cfg']['model_type']}.py").exists()
    assert cell["limits"]


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    c = json.loads((harness.ROOT / cfg["file"]).read_text())
    assert c["source"] == cfg["source"]
    assert c["reduced"] == cfg["reduced"]
    for key in cfg["reduced"]:
        assert c[key] != c["published"][key], key
    assert "num_hidden_layers" in cfg["reduced"] or c["num_hidden_layers"] == \
        c["published"]["num_hidden_layers"]


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_reader_and_cells(metric):
    assert (HERE / "metrics" / f"{metric['name']}.py").exists()
    assert callable(harness.reader(metric["name"]))
    for w in metric.get("workloads", []):
        assert w in CELLS
    if "moves" in metric:
        moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
        assert set(metric["workloads"]) <= set(moved.get("workloads", CELLS))


def test_every_cell_reports_enough():
    for name in CELLS:
        e2e = harness.metrics_of(name, BENCH, False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert harness.metrics_of(name, BENCH, True)


def test_every_config_used_once_per_traffic():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert {c["name"] for c in BENCH["configs"]} == {w["config"] for w in BENCH["workloads"]}
