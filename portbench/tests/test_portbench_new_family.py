"""A model family, a topology and a cell added as new files only: a copy of
the benchmark gains them, and a training run of the new cell finds every
one by name and proves correct, while no file the benchmark already had
changes."""
import hashlib
import json
import shutil
import subprocess
import sys

from portbench import harness

FAMILY = '''"""A dense decoder with full multi-head attention (a family of the test)."""


def layer(c, i):
    D, H, F = c["hidden_size"], c["num_attention_heads"], c["intermediate_size"]
    hd = D // H
    return [("attn_norm", (D,), "ones"), ("wq", (D, H, hd), D ** -0.5),
            ("wk", (D, H, hd), D ** -0.5), ("wv", (D, H, hd), D ** -0.5),
            ("wo", (H, hd, D), D ** -0.5), ("mlp_norm", (D,), "ones"),
            ("w_gate", (D, F), D ** -0.5), ("w_up", (D, F), D ** -0.5),
            ("w_down", (F, D), F ** -0.5)]


def routed(c):
    return None


def model_config(c, name):
    from portbench import port

    return port.model_config_of(dict(c, num_key_value_heads=c["num_attention_heads"]), name,
                                arch_type="dense",
                                head_dim=c["hidden_size"] // c["num_attention_heads"])
'''

REFERENCE = '''"""Plain reference of the test's dense multi-head decoder."""
from portbench.reference.plain import (causal_attention, cross_entropy, product, rmsnorm,
                                       rope, swiglu)


def loss(W, c, tokens, prec):
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    hd = c["hidden_size"] // c["num_attention_heads"]
    x = W["embed"][tokens[:, :-1].long()].float()
    for i in range(c["num_hidden_layers"]):
        p = lambda n: W[f"layers.{i}.{n}"].float()
        h = rmsnorm(x, p("attn_norm"), eps)
        q, k = (rope(product("bld,dhk->blhk", h, p(w), prec), theta) for w in ("wq", "wk"))
        o = causal_attention(q, k, product("bld,dhk->blhk", h, p("wv"), prec), hd ** -0.5, prec)
        x = x + product("blhk,hkd->bld", o, p("wo"), prec)
        x = x + swiglu(rmsnorm(x, p("mlp_norm"), eps), p("w_gate"), p("w_up"), p("w_down"), prec)
    h = rmsnorm(x, W["final_norm"], eps)
    return cross_entropy(product("bld,vd->blv", h, W["embed"], prec), tokens[:, 1:])
'''

TOPOLOGY = '''"""Consensus matrix of the ring lattice of degree d: each worker and the
d/2 on either side, equal weights."""
from portbench.reference.plain import uniform_over


def matrix(step, M, d):
    return uniform_over([{(j + k) % M for k in range(-(d // 2), d // 2 + 1)}
                         for j in range(M)])
'''

CONFIG = {"source": "a test's own", "model_type": "mhadense", "hidden_size": 32,
          "intermediate_size": 64, "num_attention_heads": 4, "num_hidden_layers": 2,
          "vocab_size": 128, "tie_word_embeddings": True, "hidden_act": "silu",
          "rms_norm_eps": 1e-6, "rope_theta": 10000.0, "torch_dtype": "float32",
          "reduced": []}
MIX = {"driver": "train", "workers": 6,
       "gossip": {"topology": "ring_lattice", "args": {"M": 6, "d": 4}, "backend": "fused"},
       "mode": "gossip", "optimizer": {"name": "momentum_sgd", "args": {"lr": 0.01, "mu": 0.9}},
       "batch_per_worker": 2, "seq_len": 12, "tokens": "uniform", "why": "a test's own"}
CELL = {"config": "mhadense.l2", "traffic": "train.lattice-m6", "driver": "train", "chips": 1,
        "why": "a test's own",
        "limits": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}}

RUN = """
import json, sys, time, torch
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from portbench import harness, yardstick
from portbench.drivers import train
from portbench.faults import Fault
cell = harness.cell("mhadense.train.lattice-m6")
run = train.run(cell, 2 ** 40 + 3, 0.1, False, torch.device("cpu"),
                setup_from=time.perf_counter())
bad = train.run(cell, 2 ** 40 + 3, 0.1, False, torch.device("cpu"),
                setup_from=time.perf_counter(), fault=Fault("no_mix"))
print(json.dumps({"check": run["check"], "bad": bad["check"],
                  "n_params": yardstick.n_params(cell["cfg"]), "module": harness.__file__}))
"""


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_family_topology_and_cell_from_new_files_only(tmp_path):
    pb = tmp_path / "portbench"
    shutil.copytree(harness.HERE, pb, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(pb)
    (pb / "families" / "mhadense.py").write_text(FAMILY)
    (pb / "reference" / "mhadense.py").write_text(REFERENCE)
    (pb / "reference" / "topology" / "ring_lattice.py").write_text(TOPOLOGY)
    (pb / "configs" / "mhadense.l2.json").write_text(json.dumps(CONFIG))
    (pb / "mixes" / "train.lattice-m6.json").write_text(json.dumps(MIX))
    (pb / "workloads" / "mhadense.train.lattice-m6.json").write_text(json.dumps(CELL))
    after = _digests(pb)
    assert {k: after[k] for k in before} == before
    assert len(after) == len(before) + 6

    out = subprocess.run([sys.executable, "-c", RUN, str(tmp_path), str(harness.ROOT / "src")],
                         capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["module"].startswith(str(pb))
    assert all(v["value"] <= v["limit"] for v in r["check"].values()), r["check"]
    assert not all(v["value"] <= v["limit"] for v in r["bad"].values()), r["bad"]
    D, F, V = 32, 64, 128
    assert r["n_params"] == V * D + 2 * (4 * D * D + 3 * D * F)
