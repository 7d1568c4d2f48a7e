"""The launch tooling's parts against the JAX reference and first principles.

``launch/roofline.py`` (``active_params``, ``model_flops``, the card's
rates, ``RooflineTerms``), ``launch/cost.py`` (``measure``: FLOPs, bytes,
peak live bytes, kernel reports, collectives), ``launch/dryrun.py``'s
``make_topology`` and ``input_specs``, and the kernels' ``meta`` branches,
on the CPU.

Oracles. ``INPUT_SHAPES``, ``active_params``, ``model_flops``,
``make_topology`` and ``input_specs`` equal the reference's exactly
(integer arithmetic, the same matrices, the same shapes and dtypes). The
reference's ``tests/test_hlo_cost.py`` programs are written here as
Python loops: the port has no scan, so a loop counts once per turn and
needs no trip count. The forward and the nested loop come out at the
reference's ``analyze_hlo`` figures within its rtol 1e-3, and the bytes
within its bounds (more than the weights' bytes, less than 20 times them).
The gradient and remat come out at their exact arithmetic, not at the
reference's 3× and 4×: a Python loop's backward skips the first layer's
input gradient (X needs none), which a scan body cannot skip, so the
gradient is 8 + 8 + 7 = 23 products of 8, 2.875×; the port's remat
(``models/remat.py``) takes every saved input's cotangent in its
recomputed vjp, so it is 8 + 8 + 8 + 8 = 32, 4×.

The collectives run over torch's fake process group, in a process of its
own (the group is global to a process): this file, run as a script with
``fake-group OUT``, is that process. There ``collective_bytes`` gives the
reference's ``test_collective_regex_parser`` figures on the same three ops
issued through the port's call sites; the bus's collective contracts hold
at the call layer (``tests/test_bus.py``'s sharded bytes ratio,
``test_bus_layout.py``'s GQA bytes at the planned buffer; the row-split
gather count is the port's own, since that reference test fails); and in
a train step of each family and backend on a (2, 2, 2) meta mesh every
``c10d`` op the dispatch mode sees is accounted for by a recorded event.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

from repro_torch.configs import ARCH_NAMES, INPUT_SHAPES, get_config  # noqa: E402
from repro_torch.launch import cost, roofline  # noqa: E402
from repro_torch.launch import dryrun as tdr  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402

D = 256
TRUE = 2 * 32 * D * D * 8


@pytest.fixture(scope="module")
def jref():
    """The reference's dryrun and roofline modules. Importing the dryrun
    module would set XLA_FLAGS to 512 host devices for the whole process
    (its setdefault); a value set first keeps it from doing so."""
    pytest.importorskip("jax")
    had = "XLA_FLAGS" in os.environ
    os.environ.setdefault("XLA_FLAGS", "")
    try:
        import repro.launch.dryrun as jdr
        import repro.launch.roofline as jroof
    finally:
        if not had:
            del os.environ["XLA_FLAGS"]
    return jdr, jroof


def test_input_shapes_equal_the_reference():
    pytest.importorskip("jax")
    from repro.configs import INPUT_SHAPES as J

    assert INPUT_SHAPES == J


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_active_params_and_model_flops_equal_the_reference(jref, arch):
    from repro.configs import get_config as jget

    _, jroof = jref
    tcfg, jcfg = get_config(arch), jget(arch)
    assert roofline.active_params(tcfg) == jroof.active_params(jcfg)
    for kind in ("train", "serve"):
        for n in (1, 1000, 256 * 4096):
            assert roofline.model_flops(tcfg, n, kind) == jroof.model_flops(jcfg, n, kind)


@pytest.mark.parametrize("name,M,pod", [("ring", 16, 16), ("clique", 16, 16),
                                        ("expander", 16, 16), ("dirring", 16, 16),
                                        ("hypercube", 16, 16), ("hier", 32, 16),
                                        ("hier", 4, 2)])
def test_make_topology_equals_the_reference(jref, name, M, pod):
    jdr, _ = jref
    t, j = tdr.make_topology(name, M, pod_size=pod), jdr.make_topology(name, M, pod_size=pod)
    np.testing.assert_array_equal(np.asarray(t.A), np.asarray(j.A))


def _big(leaves):
    return [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in leaves
            if hasattr(x, "shape") and len(x.shape) >= 2]


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_input_specs_equal_the_reference(jref, arch):
    """Every input of every shape and mode: the same shapes and dtypes (the
    caches' tensors; their write positions are a Python int in the port)."""
    import jax
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.configs import get_config as jget
    from repro_torch import _tree

    jdr, _ = jref
    tcfg, jcfg = get_config(arch), jget(arch)
    for shape in INPUT_SHAPES:
        if not tdr.shape_applicable(tcfg, shape):
            continue
        for mode in (("gossip", "allreduce") if INPUT_SHAPES[shape]["kind"] == "train"
                     else ("serve",)):
            t = tdr.input_specs(tcfg, shape, AbstractMesh((16, 16), ("data", "model")), mode)
            j = jdr.input_specs(jcfg, shape, JAbstractMesh((16, 16), ("data", "model")), mode)
            assert sorted(t) == sorted(j), (shape, mode)
            for key in t:
                tl, jl = _tree.leaves(t[key]), jax.tree.leaves(j[key])
                if key == "caches":
                    assert _big(tl) == _big(jl), (shape, key)
                else:
                    assert [(tuple(x.shape), str(x.dtype).split(".")[-1]) for x in tl] == \
                        [(tuple(x.shape), str(x.dtype)) for x in jl], (shape, key)
                assert all(x.device.type == "meta" for x in tl if isinstance(x, torch.Tensor))


# ---------------------------------------------------------------------------
# The reference's HLO cost programs, as loops
# ---------------------------------------------------------------------------


def _x_ws():
    g = torch.Generator().manual_seed(0)
    return torch.ones(32, D), torch.randn(8, D, D, generator=g) / 16


def _forward(x, ws):
    for i in range(8):
        x = torch.tanh(x @ ws[i])
    return x.sum()


def _jax_program_flops(kind: str) -> float:
    """The reference's ``analyze_hlo`` FLOPs of its scan programs."""
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_cost import analyze_hlo

    X, WS = jnp.ones((32, D)), jnp.ones((8, D, D))

    def scan(x, ws):
        y, _ = jax.lax.scan(lambda c, w: (jnp.tanh(c @ w), None), x, ws)
        return y.sum()

    def nested(x, ws):
        def outer(c, _):
            y, _ = jax.lax.scan(lambda cc, w: (jnp.tanh(cc @ w), None), c, ws)
            return y, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y.sum()

    f = {"scan": scan, "nested": nested}[kind]
    return analyze_hlo(jax.jit(f).lower(X, WS).compile().as_text()).flops


def test_forward_loop_flops_and_bytes_match_the_reference():
    pytest.importorskip("jax")
    x, ws = _x_ws()
    _, c = cost.measure(_forward, x, ws)
    ref = _jax_program_flops("scan")
    assert np.isclose(c.flops / ref, 1.0, rtol=1e-3), (c.flops, ref)
    assert np.isclose(c.flops / TRUE, 1.0, rtol=1e-3)
    weight_bytes = 8 * D * D * 4
    assert weight_bytes < c.bytes < 20 * weight_bytes, c.bytes


def test_nested_loop_multiplies():
    pytest.importorskip("jax")
    x, ws = _x_ws()

    def nested(x, ws):
        for _ in range(3):
            for i in range(8):
                x = torch.tanh(x @ ws[i])
        return x.sum()

    _, c = cost.measure(nested, x, ws)
    ref = _jax_program_flops("nested")
    assert np.isclose(c.flops / ref, 1.0, rtol=1e-3), (c.flops, ref)
    assert np.isclose(c.flops / (3 * TRUE), 1.0, rtol=1e-3)


def test_gradient_is_its_exact_arithmetic():
    """8 forward products, 8 weight gradients, 7 input gradients (layer
    0's input X needs none): 23/8 of the forward, where the reference's scan
    counts 3×."""
    x, ws = _x_ws()
    _, c = cost.measure(torch.func.grad(lambda w: _forward(x, w)), ws)
    assert c.flops == TRUE * 23 / 8


def test_remat_adds_the_forward_recompute():
    """The port's remat: 8 forward products, 8 recomputed, then its vjp takes
    both cotangents of every layer (layer 0's carry included): 32/8."""
    from repro_torch.models.remat import checkpoint

    x, ws = _x_ws()

    def f(w):
        c = x
        for i in range(8):
            c = checkpoint(lambda a, b: torch.tanh(a @ b), c, w[i])
        return c.sum()

    _, c = cost.measure(torch.func.grad(f), ws)
    assert c.flops == TRUE * 32 / 8


def test_peak_counts_the_inputs_and_the_live_intermediates():
    x = torch.ones(1024, dtype=torch.float32, device="meta")

    def f(x):
        a = x * 2          # 4 KB live
        b = a + 1          # 8 KB live
        del a
        c = b * 3          # a released: 8 KB live
        return c

    _, c = cost.measure(f, x)
    assert c.peak_bytes == 3 * 4096          # x, a, b
    assert c.bytes == 3 * 2 * 4096           # three ops, each one input and one output
    assert c.flops == 0


# ---------------------------------------------------------------------------
# The kernels' meta branches
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k,with_update", [(1, True), (2, True), (2, False)])
def test_gossip_mix_meta_branch(k, with_update):
    from repro_torch.kernels.gossip_mix import gossip_mix_2d

    w = torch.empty(1000, 128, dtype=torch.bfloat16, device="meta")
    nbr = torch.empty(k, 1000, 128, dtype=torch.bfloat16, device="meta")
    u = torch.empty(1000, 128, dtype=torch.float32, device="meta") if with_update else None
    before = gossip_mix_2d.launches
    out, c = cost.measure(gossip_mix_2d, w, nbr, [0.5] + [0.5 / k] * k, u,
                          -1.0 if with_update else None)
    assert out.shape == w.shape and out.dtype == w.dtype and out.device.type == "meta"
    assert gossip_mix_2d.launches == before           # nothing launched
    n = w.numel()
    # chip_smoke.py's bound: k+1 multiplies, k adds, then multiply and subtract;
    # w, k neighbours and the output, plus the update
    want = (n * (2 * k + 1 + 2 * with_update),
            n * 2 * (k + 2) + (n * 4 if with_update else 0))
    assert [(e.name, e.ops, e.nbytes, e.products) for e in c.kernels] == \
        [("gossip_mix", *want, False)]
    assert c.flops == 0 and c.bytes == want[1]


def test_quant_pack_meta_branch():
    from repro_torch.kernels.quant_pack import quantize_pack_2d

    x = torch.empty(512, 128, dtype=torch.float32, device="meta")
    (v, s), c = cost.measure(quantize_pack_2d, x)
    assert (v.shape, v.dtype, s.shape, s.dtype) == ((512, 128), torch.int8, (512, 1),
                                                    torch.float32)
    n = x.numel()
    assert [(e.name, e.ops, e.nbytes) for e in c.kernels] == \
        [("quant_pack", 4 * n + 2 * 512, n * 4 + n + 512 * 4)]


@pytest.mark.parametrize("Lq,Lkv,causal,window", [(1100, 1100, True, None),
                                                  (700, 700, True, 64),
                                                  (300, 500, False, None),
                                                  (37, 53, True, 5)])
def test_flash_pairs_count_the_reference_mask(Lq, Lkv, causal, window):
    from repro_torch.kernels.flash_attention.kernel import pairs

    qi, ki = np.arange(Lq)[:, None], np.arange(Lkv)[None, :]
    ok = np.ones((Lq, Lkv), bool)
    if causal:
        ok &= ki <= qi
    if window is not None:
        ok &= ki > qi - window
    assert pairs(Lq, Lkv, causal, window) == int(ok.sum())


def test_flash_attention_meta_branch():
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fops

    B, H, Hkv, L, hd = 2, 8, 2, 1100, 64
    q = torch.empty(B, L, H, hd, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(B, L, Hkv, hd, dtype=torch.bfloat16, device="meta")
    before = flash_attention.launches
    o, c = cost.measure(fops.attention, q, kv, kv)
    assert o.shape == q.shape and o.dtype == q.dtype and o.device.type == "meta"
    assert flash_attention.launches == before
    ops = 4 * B * H * hd * (L * (L + 1) // 2)       # q·k and p·v over the causal pairs
    moved = (2 * q.numel() + 2 * kv.numel()) * 2
    assert [(e.name, e.ops, e.nbytes, e.products) for e in c.kernels] == \
        [("flash_attention", ops, moved, True)]
    assert c.flops == ops                             # its products count as FLOPs


def test_cpu_tensors_take_the_plain_versions_and_report_nothing():
    from repro_torch.kernels.gossip_mix import gossip_mix_2d

    w = torch.ones(16, 128)
    _, c = cost.measure(gossip_mix_2d, w, torch.ones(1, 16, 128), [0.5, 0.5])
    assert c.kernels == [] and c.bytes > 0


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


def test_rates_and_links():
    assert roofline.memory_rate("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.memory_rate("NVIDIA H100 NVL") == 3.9e12
    assert roofline.peak_flops("bfloat16") == 989e12
    assert roofline.peak_flops("float32") == 67e12
    assert roofline.link_rate([0]) is None
    assert roofline.link_rate(range(8)) == roofline.NVLINK_RATE
    assert roofline.link_rate(range(16)) == roofline.NETWORK_RATE
    assert roofline.link_rate([0, 16]) == roofline.NETWORK_RATE


def test_roofline_terms_keep_the_reference_keys(jref):
    _, jroof = jref
    cfg = get_config("granite-3-2b")
    c = cost.Cost(flops=989e12, bytes=3.35e12, collectives=[
        cost.Collective("all-reduce", 450e9, tuple(range(8))),
        cost.Collective("collective-permute", 50e9, (0, 8), ((0, 8), (8, 0)))])
    t = roofline.analyze(c, cfg, chips=16, n_tokens=1000)
    j = jroof.RooflineTerms(1.0, 1.0, 1.0, 16, 1000, 1.0).as_dict()
    assert set(j) <= set(t.as_dict())
    assert (t.t_compute, t.t_memory, t.t_collective) == (1.0, 1.0, 2.0)
    assert t.bottleneck == "collective" and t.t_bound == 2.0
    assert t.coll_bytes == 500e9 and t.coll_bytes_network == 50e9
    assert t.useful_flops_ratio == roofline.model_flops(cfg, 1000) / (989e12 * 16)


def test_dryrun_mesh_names_follow_the_production_shapes():
    assert tdr._mesh_name(False) == "pod_16x16"
    assert tdr._mesh_name(True) == "multipod_2x16x16"


# ---------------------------------------------------------------------------
# Over the fake process group, in a process of its own
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fake_group(tmp_path_factory):
    out = tmp_path_factory.mktemp("fake_group") / "results.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "..", "src"))
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "fake-group", str(out)],
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, f"stdout:\n{res.stdout}\nstderr:\n{res.stderr[-6000:]}"
    return json.loads(out.read_text())


def test_collective_bytes_match_the_reference_parser(fake_group, jref):
    """all-gather f32[16,32], all-reduce bf16[8,8] and collective-permute
    f32[4], the reference's regex-parser case, issued through the port's
    call sites."""
    _, jroof = jref
    hlo = """
ENTRY %main (p: f32[16,32]) -> f32[16,32] {
  %ag = f32[16,32]{1,0} all-gather(%p), replica_groups={}
  %ar = bf16[8,8]{1,0} all-reduce(%x), to_apply=%sum
  ROOT %cp = f32[4]{0} collective-permute(%y), source_target_pairs={{0,1}}
}
"""
    got = fake_group["parser"]
    assert got["bytes"] == jroof.collective_bytes(hlo)
    assert got["counts"] == jroof.collective_counts(hlo)
    assert got["unreported"] == 0


@pytest.mark.parametrize("k", [1, 2])
def test_ring_issues_two_permutes_at_every_k(fake_group, k):
    got = fake_group["ring"][str(k)]
    assert got["counts"]["collective-permute"] == 2 and got["unreported"] == 0


def test_ring_permute_bytes_drop_by_k(fake_group):
    ratio = (fake_group["ring"]["1"]["bytes"]["collective-permute"]
             / fake_group["ring"]["2"]["bytes"]["collective-permute"])
    assert 1.8 < ratio < 2.2, ratio


@pytest.mark.parametrize("k", [4, 16])
def test_gqa_tree_ships_the_planned_buffer(fake_group, k):
    got = fake_group["gqa"][str(k)]
    assert got["counts"]["collective-permute"] == 1
    assert got["bytes"]["collective-permute"] == got["planned"]
    assert got["bytes"]["collective-permute"] <= 1.02 * got["ideal"]


@pytest.mark.parametrize("nchunks", [1, 3])
def test_row_split_tree_gathers_once_per_dtype_group(fake_group, nchunks):
    """The port's own count: one all-gather per dtype group, one permute per
    chunk (the reference's HLO test of this fails)."""
    got = fake_group["row_split"][str(nchunks)]
    assert got["counts"]["all-gather"] == 1
    assert got["counts"]["collective-permute"] == nchunks
    assert got["unreported"] == 0


C10D_CASES = ["granite-fused-stats", "granite-ppermute", "granite-allreduce-backend",
              "granite-allreduce-mode", "granite-adafactor", "mamba2-fused",
              "mixtral-allreduce-mode-global-moe", "granite-hier"]


@pytest.mark.parametrize("case", C10D_CASES)
def test_every_c10d_op_is_a_recorded_collective(fake_group, case):
    got = fake_group["c10d"][case]
    assert got["c10d"] > 0 and got["unreported"] == 0, got


def test_the_c10d_cases_reach_every_call_site(fake_group):
    """Between them the cases issue every kind the port issues."""
    kinds = set()
    for got in fake_group["c10d"].values():
        kinds |= {k for k, n in got["counts"].items() if n}
    assert kinds == {"all-reduce", "all-gather", "collective-permute"}


def _events(c):
    return {"bytes": roofline.collective_bytes(c.collectives),
            "counts": roofline.collective_counts(c.collectives),
            "unreported": c.unreported_c10d(), "c10d": sum(c10d for c10d in c.c10d_ops.values())}


def _fake_group_main(out_path: str) -> None:
    """The fake-group worker: rank 0 of a world of 32 on ``meta``."""
    import torch.distributed as dist

    from repro_torch import _tree
    from repro_torch.core import bus
    from repro_torch.core import topology as T
    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.core.gossip import GossipSpec
    from repro_torch.launch import mesh as ML
    from repro_torch.launch import shardings as S
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.models import model as Mo
    from repro_torch.models.params import PartitionSpec as P
    from repro_torch.models.params import abstract_tree
    from repro_torch.optim import adafactor_like, momentum_sgd

    ML.init_fake_group(32)
    res: dict = {}

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def wmesh(*shape):
        return ML.WorkerMesh.from_mesh(ML.make_host_mesh(*shape, device="meta"))

    def local(tree, specs, wm):
        return _tree.map(lambda x: meta(x.shape, x.dtype), S.local_tree(tree, specs, wm))

    # the reference parser's three ops, through the port's call sites
    wm = wmesh(4, 2)
    g = wm.model_group

    def three():
        tp._all_gather(meta((8, 32)), (g,), 0)
        tp._all_reduce(meta((8, 8), torch.bfloat16), (g,), dist.ReduceOp.SUM)
        M = 4
        outs, pending = bus._ppermute([meta((1, 4))], [((j + 1) % M, j) for j in range(M)],
                                      wm, M)
        bus._wait([pending])

    _, c = cost.measure(three)
    res["parser"] = _events(c)

    # tests/test_bus.py: a degree-2 ring at k = 1 and 2
    M = 4
    params = {"w": meta((M, 256, 8, 128)), "emb": meta((M, 1024, 256)), "v": meta((M, 33, 5))}
    res["ring"] = {}
    for k in (1, 2):
        wm = wmesh(M, k)
        m_ax = "model" if k > 1 else None
        specs = {"w": P("data", None, m_ax, None), "emb": P("data", None, m_ax),
                 "v": P("data", None, None)}
        spec = GossipSpec.for_mesh(T.undirected_ring(M), wm, backend="fused")
        p = local(params, specs, wm)
        _, c = cost.measure(bus.mix_bus, p, spec, wm, param_specs=specs)
        res["ring"][str(k)] = _events(c)

    # tests/test_bus_layout.py: the GQA tree at k = 4 and 16
    M, Dm, H, KV, HD = 2, 512, 16, 8, 64
    params = {"q": meta((M, Dm, H * HD)), "o": meta((M, H * HD, Dm)),
              "wk": meta((M, Dm, KV * HD)), "wv": meta((M, Dm, KV * HD))}
    payload = sum(x[0].numel() for x in params.values()) * 4
    res["gqa"] = {}
    for k in (4, 16):
        wm = wmesh(M, k)
        specs = {"q": P("data", None, "model"), "o": P("data", "model", None),
                 "wk": P("data", None, None), "wv": P("data", None, None)}
        spec = GossipSpec.for_mesh(T.directed_ring_lattice(M, 1), wm, backend="fused")
        p = local(params, specs, wm)
        _, c = cost.measure(bus.mix_bus, p, spec, wm, param_specs=specs)
        flags = bus.sharded_leaf_flags(specs, "model")
        layout = bus.plan_layout({n: x[0] for n, x in p.items()}, lead_ndim=0, shards=k,
                                 leaf_sharded=flags)
        res["gqa"][str(k)] = dict(_events(c), planned=layout.padded_bytes(),
                                  ideal=payload / k)

    # tests/test_bus_layout.py: the row-split tree, nchunks 1 and 3
    M, k = 2, 4
    wm = wmesh(M, k)
    params = {"w": meta((M, 256, 16 * k)), "kv": meta((M, 257, 5))}
    specs = {"w": P("data", None, "model"), "kv": P("data", None, None)}
    spec = GossipSpec.for_mesh(T.directed_ring_lattice(M, 1), wm, backend="fused")
    p = local(params, specs, wm)
    res["row_split"] = {}
    for nchunks in (1, 3):
        _, c = cost.measure(bus.mix_bus, p, spec, wm, nchunks=nchunks, block_r=8,
                            param_specs=specs)
        res["row_split"][str(nchunks)] = _events(c)

    # a train step per family and backend on a (2, 2, 2) meta mesh
    wm = ML.WorkerMesh.from_mesh(ML.make_host_mesh(2, 2, 2, device="meta"))
    res["c10d"] = {}
    small = dict(seq=16, rows=2)

    def step_case(arch, *, backend="fused", mode="gossip", opt=None, stats=False,
                  topo="ring", hierarchical=False, **over):
        cfg = get_config(arch, reduced=True, **over)
        Mw = wm.n_workers
        defs = Mo.model_defs(cfg)
        specs = S.param_pspecs(cfg, wm, mode)
        params = abstract_tree(defs)
        if mode == "gossip":
            params = _tree.map(lambda x: meta((Mw,) + tuple(x.shape)), params)
            batch = {"tokens": meta((Mw, small["rows"], small["seq"]), torch.int32)}
        else:
            batch = {"tokens": meta((Mw * small["rows"], small["seq"]), torch.int32)}
        bspec = S.batch_pspecs(cfg, wm, "train", mode)
        p = local(params, specs, wm)
        b = local(batch, {"tokens": bspec["tokens"]}, wm)
        opt = opt or momentum_sgd(1e-2, 0.9)
        gossip = GossipSpec.for_mesh(tdr.make_topology(topo, Mw, pod_size=2), wm,
                                     backend=backend, hierarchical=hierarchical)
        step = make_train_step(lambda q, bb: Mo.loss_fn(q, cfg, bb), opt, gossip=gossip,
                               mode=mode, mesh=wm, compute_stats=stats, param_specs=specs)
        _, c = cost.measure(step, init_state(p, opt), b)
        return _events(c)

    cases = {
        "granite-fused-stats": lambda: step_case("granite-3-2b", stats=True),
        "granite-ppermute": lambda: step_case("granite-3-2b", backend="ppermute"),
        "granite-allreduce-backend": lambda: step_case("granite-3-2b", backend="allreduce"),
        "granite-allreduce-mode": lambda: step_case("granite-3-2b", mode="allreduce"),
        "granite-adafactor": lambda: step_case("granite-3-2b", opt=adafactor_like(1e-2)),
        "mamba2-fused": lambda: step_case("mamba2-2.7b"),
        "mixtral-allreduce-mode-global-moe": lambda: step_case(
            "mixtral-8x7b", mode="allreduce", moe_dispatch="global"),
        "granite-hier": lambda: step_case("granite-3-2b", topo="hier", hierarchical=True,
                                          backend="ppermute"),
    }
    for name, fn in cases.items():
        res["c10d"][name] = fn()
    with open(out_path, "w") as f:
        json.dump(res, f)


if __name__ == "__main__" and sys.argv[1:2] == ["fake-group"]:
    _fake_group_main(sys.argv[2])
