"""What every cell's run shares: finding the cell's files by name, seeds,
the checks on the device and on the loaded modules, the readers of the
metrics, and the result line.

A cell is ``workloads/<cell>.json`` (its configuration, traffic and
driver); its configuration is ``configs/<config>.json``, its traffic
``mixes/<traffic>.json``, each metric ``metrics/<metric>.py`` (a
``read(run)`` that returns a number, or None where the run has nothing to
read), each driver ``drivers/<driver>.py``. A model family (a
configuration's ``model_type``) is two files: ``families/<model_type>.py``
(its tensors and the port's ModelConfig) and its plain reference
``reference/<model_type>.py``. A mix's topology and optimizer are found by
name too: in the port by ``portbench.port``, in the reference as
``reference/topology/<name>.py`` and ``reference/optimizer/<name>.py``.
The metrics a run reports are the ones ``BENCHMARK.json`` lists for its
cell.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str) -> dict:
    """The workload file of cell ``name`` with its configuration and mix."""
    w = load_json(HERE / "workloads" / f"{name}.json")
    return dict(w, name=name, cfg=load_json(HERE / "configs" / f"{w['config']}.json"),
                mix=load_json(HERE / "mixes" / f"{w['traffic']}.json"))


def metrics_of(name: str, bench: dict, trace: bool) -> list[dict]:
    """The metrics ``BENCHMARK.json`` lists for cell ``name``: its
    end-to-end ones in a run without the trace, its per-layer ones with it."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str):
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        HERE / "metrics" / f"{metric}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def family(model_type: str):
    return importlib.import_module(f"portbench.families.{model_type}")


def reference(model_type: str):
    return importlib.import_module(f"portbench.reference.{model_type}")


def reference_topology(name: str):
    return importlib.import_module(f"portbench.reference.topology.{name}")


def reference_optimizer(name: str):
    return importlib.import_module(f"portbench.reference.optimizer.{name}")


def sub_seed(seed: int, stream: str) -> int:
    """A seed of its own for each use of the run's seed (weights, tokens,
    order), under 2**63 for any seed the driver gives."""
    h = 1469598103934665603
    for ch in f"{int(seed)}:{stream}".encode():
        h = ((h ^ ch) * 1099511628211) % (1 << 64)
    return h % (1 << 63)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def read_metrics(run: dict, wanted: list[dict]) -> dict:
    out = {}
    for m in wanted:
        v = reader(m["name"])(run)
        if v is None:
            continue
        if not math.isfinite(v):
            raise RuntimeError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(*, correct: bool, attempted: int, failed: int, metrics: dict, device: dict,
                check: dict, breakdown: dict | None = None) -> str:
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["check"] = check
    return json.dumps(out)


def check_lines(check: dict) -> list[str]:
    return [f"check {k}: {v['value']!r} limit {v['limit']!r}" for k, v in check.items()]
