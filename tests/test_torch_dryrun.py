"""The dry run end to end: ``python -m repro_torch.launch.dryrun``.

Each run is a process of its own, as the dry run must be (the fake
process group is global to a process):

* ``--smoke``: reduced nemotron-4-340b in gossip mode on the fused bus
  over a (pod=2, data=2, model=2) meta mesh must run and issue
  collective-permutes;
* ``--hier-smoke``: the ``hier`` topology with ``hierarchical=True`` on
  the same mesh gives intra-pod permutes (ici > 0), inter-pod permutes on
  the pod axis alone (dci > 0) and none that mixes the two (the
  reference's CI gate, read from the recorded pairs instead of HLO);
* the reference's ``test_dryrun_small_mesh_end_to_end`` matrix: granite,
  mamba2 and mixtral at reduced widths × train, prefill and decode at its
  reduced shapes × the (4, 2) and (2, 2, 2) meshes, each ``ok`` with a
  bottleneck among the three terms;
* ``slow``: nemotron-4-340b × train_4k at full width on (2, 16, 16), fused
  bus: its collective-permute bytes per rank are twice (a degree-2 ring)
  the per-shard bus buffer its layout plans, exactly.
"""
import json
import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
sys.path.insert(0, SRC)

ARCHS = ("granite-3-2b", "mamba2-2.7b", "mixtral-8x7b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"4x2": False, "2x2x2": True}


def _run(args, timeout=600, code=None) -> str:
    env = dict(os.environ, PYTHONPATH=SRC)
    cmd = [sys.executable, "-c", code] if code else \
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-6000:]}"
    return res.stdout


def test_smoke_lane_issues_permutes():
    out = _run(["--smoke"])
    line = next(ln for ln in out.splitlines() if ln.startswith("SMOKE OK"))
    assert int(line.split("collective-permutes=")[1].split()[0]) > 0, line


def test_hier_smoke_lane_keeps_the_link_classes_pure():
    out = _run(["--hier-smoke"])
    line = next(ln for ln in out.splitlines() if ln.startswith("HIER SMOKE"))
    got = dict(kv.split("=") for kv in line.split("classes ")[1].split())
    assert int(got["ici"]) > 0 and int(got["dci"]) > 0 and int(got["mixed"]) == 0, line


MATRIX = """
import json, sys
import repro_torch.launch.mesh as ML
ML.SINGLE_POD = (4, 2)
ML.MULTI_POD = (2, 2, 2)
from repro_torch.launch import dryrun as dr
dr.INPUT_SHAPES.update({
    "train_4k": dict(seq_len=128, global_batch=8, kind="train"),
    "prefill_32k": dict(seq_len=256, global_batch=4, kind="prefill"),
    "decode_32k": dict(seq_len=256, global_batch=8, kind="decode"),
})
out = {}
for arch in %r:
    for shape in %r:
        res = dr.run_one(arch, shape, multi_pod=%r, reduced=True)
        out[arch + ":" + shape] = {"ok": res.ok, "error": res.error,
                                   "roofline": res.roofline, "mesh": res.mesh}
print("RESULTS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def matrix():
    """Both meshes' runs, one process each, side by side."""
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = {name: subprocess.Popen(
        [sys.executable, "-c", MATRIX % (ARCHS, SHAPES, multi)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, multi in MESHES.items()}
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{stderr[-6000:]}"
        line = next(ln for ln in stdout.splitlines() if ln.startswith("RESULTS "))
        out[name] = json.loads(line[len("RESULTS "):])
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_small_mesh_matrix_runs(matrix, arch, shape, mesh):
    res = matrix[mesh][f"{arch}:{shape}"]
    assert res["ok"], res["error"]
    assert res["mesh"] == ("multipod_2x2x2" if MESHES[mesh] else "pod_4x2")
    r = res["roofline"]
    assert r["bottleneck"] in ("compute", "memory", "collective")
    assert r["flops_per_chip"] > 0 and r["bytes_per_chip"] > 0 and r["peak_bytes_per_chip"] > 0


NEMOTRON = """
import json
import torch
from repro_torch import _tree
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as dr, shardings as S
from repro_torch.launch.mesh import make_worker_mesh
from repro_torch.models import model as M
from repro_torch.models.params import abstract_tree
res = dr.run_one("nemotron-4-340b", "train_4k", multi_pod=True, gossip_backend="fused")
assert res.ok, res.error
cfg = get_config("nemotron-4-340b")
wm = make_worker_mesh(multi_pod=True)
planned = wm.sim_payload_bytes(abstract_tree(M.model_defs(cfg), torch.bfloat16),
                               S.param_pspecs(cfg, wm, "gossip"))
print("RESULTS " + json.dumps({"collectives": res.collectives, "counts": res.coll_counts,
                               "planned": planned, "roofline": res.roofline}))
"""


@pytest.mark.slow
def test_nemotron_full_width_permutes_twice_the_planned_buffer():
    out = _run([], timeout=3600, code=NEMOTRON)
    got = json.loads(next(ln for ln in out.splitlines()
                          if ln.startswith("RESULTS "))[len("RESULTS "):])
    assert got["counts"]["collective-permute"] == 2, got["counts"]
    assert got["collectives"]["collective-permute"] == 2 * got["planned"], got
