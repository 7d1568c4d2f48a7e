"""Card-only tests: the port's CUDA kernels against their plain PyTorch
versions on the card. They skip without a CUDA device and need no JAX, so
they run where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's kernel-test ones: atol 1e-5 for float32,
5e-2 for bf16. Kernel and plain version round the same float32 operations
in the same order, so in practice they agree bit for bit; quant_pack is
held to exact equality of values and scales. flash_attention sums in
another order than its plain version (tiles, online softmax), so it is held
to the reference's flash tolerances: atol 2e-5 for float32, 3e-2 for bf16,
and bf16 besides to one bf16 ulp of the plain value plus 1e-4 element by
element, as ``chip_smoke.py`` holds it (both sides round a float32 result
once to bf16).
"""
import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core import topology as T
from repro_torch.core.gossip import GossipSpec
from repro_torch.kernels.flash_attention import attention_reference, flash_attention
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.gossip_mix import gossip_mix_2d, gossip_mix_reference
from repro_torch.kernels.quant_pack import quantize_pack_2d, quantize_pack_reference

TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-2}
F32, BF16 = torch.float32, torch.bfloat16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, dtype, seed, device):
    g = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(g).to(device=device, dtype=dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1001, 128), (37, 129)])
@pytest.mark.parametrize("w_dt,u_dt", [(F32, F32), (BF16, BF16), (BF16, F32), (F32, BF16)])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("with_update", [True, False])
def test_cuda_kernel_matches_plain_version(cuda, shape, w_dt, u_dt, k, with_update):
    w = _randn(shape, w_dt, 0, cuda)
    nbr = _randn((k,) + shape, w_dt, 1, cuda)
    u = _randn(shape, u_dt, 2, cuda) if with_update else None
    wts = np.random.default_rng(k).dirichlet(np.ones(k + 1))
    eta = 0.1 if with_update else None
    before = gossip_mix_2d.launches
    out = gossip_mix_2d(w, nbr, wts, u, eta)
    torch.cuda.synchronize()
    assert gossip_mix_2d.launches == before + 1
    ref = gossip_mix_reference(w, nbr, wts, u, eta)
    assert out.dtype == w.dtype and out.device == w.device
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[w_dt], rtol=0)


@pytest.mark.gpu
def test_cuda_wrapper_raises_instead_of_falling_back(cuda):
    w = torch.zeros(8, 128, device=cuda)
    wts = [0.2, 0.4, 0.4]
    with pytest.raises(ValueError, match="contiguous"):
        gossip_mix_2d(w, torch.zeros(2, 128, 8, device=cuda).transpose(1, 2), wts)
    with pytest.raises(TypeError):
        gossip_mix_2d(w.half(), torch.zeros(2, 8, 128, device=cuda).half(), wts)
    with pytest.raises(ValueError, match="operands"):
        gossip_mix_2d(w, torch.zeros(2, 8, 128), wts)


@pytest.mark.gpu
def test_mix_bus_on_card_matches_cpu(cuda):
    M = 4
    p = {"w": _randn((M, 50, 50), F32, 3, "cpu"), "b": [_randn((M, 129), F32, 4, "cpu")]}
    u = {"w": _randn((M, 50, 50), F32, 5, "cpu"), "b": [_randn((M, 129), F32, 6, "cpu")]}
    assert bus.plan_layout(p).groups[0].rows == 24     # three 8-row blocks
    spec = GossipSpec(topology=T.undirected_ring(M), backend="fused")
    on_cpu = bus.mix_bus(p, spec, updates=u, eta=-1.0, nchunks=3, block_r=8)
    before = gossip_mix_2d.launches
    on_card = bus.mix_bus(_tree.map(lambda x: x.to(cuda), p), spec,
                          updates=_tree.map(lambda x: x.to(cuda), u), eta=-1.0,
                          nchunks=3, block_r=8)
    torch.cuda.synchronize()
    assert gossip_mix_2d.launches == before + 3          # one per chunk
    for a, b in zip(_tree.leaves(on_cpu), _tree.leaves(on_card)):
        torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fused_time_varying_step_matches_einsum_on_card(cuda, dtype):
    """One fused one-peer step per round on the card: one k = 1 kernel
    launch each, equal to the einsum step with the round's dense matrix."""
    from repro_torch.core.decentralized import init_state, make_train_step, replicate_for_workers
    from repro_torch.optim import momentum_sgd

    M = 8
    targets = _randn((M, 3, 130), F32, 9, cuda)

    def loss(p, b):
        return torch.mean((p["x"].float() - b) ** 2)

    opt = momentum_sgd(0.1, 0.9)
    states = {}
    for be in ("fused", "einsum"):
        spec = GossipSpec(topology=T.undirected_ring(M), backend=be,
                          time_varying="one_peer_exp")
        step = make_train_step(loss, opt, gossip=spec)
        s = init_state(replicate_for_workers({"x": torch.zeros(130, device=cuda, dtype=dtype)}, M), opt)
        before = dict(gossip_mix_2d.launches_by_k)
        for _ in range(5):
            s, _ = step(s, targets)
        torch.cuda.synchronize()
        launched = {k: v - before.get(k, 0) for k, v in gossip_mix_2d.launches_by_k.items()}
        assert launched.get(1, 0) == (5 if be == "fused" else 0)
        states[be] = s.params["x"]
    torch.testing.assert_close(states["fused"].float(), states["einsum"].float(),
                               atol=TOL[dtype], rtol=0)


@pytest.mark.gpu
def test_async_writer_on_card_tensors(cuda, tmp_path):
    """save() snapshots CUDA tensors without waiting on the device; the
    params changed in place right after reach neither file, monolithic or
    sharded, and both restore bit for bit. The values are multiples of 1/8,
    so the float32 consensus sums are exact in any order and the sharded
    consensus equals consensus_params bit for bit."""
    from repro_torch.train import checkpoint as ckpt

    def eighths(shape, dtype, seed):
        g = np.random.default_rng(seed).integers(-64, 64, size=shape) / 8
        return torch.from_numpy(g).to(device=cuda, dtype=dtype)

    p = {"w": eighths((4, 257, 129), BF16, 11), "b": [eighths((4, 7), F32, 12)]}
    want = _tree.map(lambda x: x.clone(), p)
    path, spath = str(tmp_path / "mono.npz"), str(tmp_path / "sharded")
    with ckpt.AsyncCheckpointWriter() as w:
        w.save(path, p, step=1)
        w.save(spath, p, step=1, sharded=True)
        _tree.map(lambda x: x.add_(1.0), p)            # the next step, in place
    for f in (path, spath):
        back = ckpt.restore(f, want, device=cuda)
        for a, b in zip(_tree.leaves(back), _tree.leaves(want)):
            assert a.device.type == "cuda" and torch.equal(a, b)
    mean = ckpt.consensus_from_sharded(spath, _tree.map(lambda x: x[0], want), device=cuda)
    for a, b in zip(_tree.leaves(mean), _tree.leaves(ckpt.consensus_params(want))):
        assert torch.equal(a, b)


def _quant_input(kind, dtype, device):
    if kind == "ties":     # amax 127 ⇒ scale exactly 1, entries k + 0.5
        x = np.tile(np.arange(-64, 64) + 0.5, (32, 1)).astype(np.float32)
        x[:, 0] = 127.0
        x[1::2] *= -1
        return torch.from_numpy(x).to(device=device, dtype=dtype)
    shape = {"rows128": (1001, 128), "odd_cols": (37, 129), "zeros_negative": (64, 128)}[kind]
    x = _randn(shape, torch.float32, 7, device) * torch.arange(
        1, shape[0] + 1, device=device, dtype=torch.float32)[:, None]
    if kind == "zeros_negative":
        x = -x.abs()
        x[5] = 0
    return x.to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["rows128", "odd_cols", "zeros_negative", "ties"])
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_quant_pack_kernel_equals_plain_version(cuda, kind, dtype):
    x = _quant_input(kind, dtype, cuda)
    before = quantize_pack_2d.launches
    v, s = quantize_pack_2d(x, block_r=x.shape[0])
    torch.cuda.synchronize()
    assert quantize_pack_2d.launches == before + 1
    rv, rs = quantize_pack_reference(x)
    assert v.dtype == torch.int8 and s.dtype == F32 and s.shape == (x.shape[0], 1)
    assert torch.equal(v, rv) and torch.equal(s, rs)


@pytest.mark.gpu
def test_quant_pack_unaligned_buffer_equals_plain_version(cuda):
    flat = _randn((1, 64 * 128 + 1), F32, 8, cuda).view(-1)
    x = flat[1:].view(64, 128)          # 4 bytes off a 16-byte boundary
    v, s = quantize_pack_2d(x)
    rv, rs = quantize_pack_reference(x)
    assert torch.equal(v, rv) and torch.equal(s, rs)


@pytest.mark.gpu
def test_quant_pack_raises_instead_of_falling_back(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        quantize_pack_2d(torch.zeros(128, 8, device=cuda).t())
    with pytest.raises(TypeError):
        quantize_pack_2d(torch.zeros(8, 128, device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError, match="block_r"):
        quantize_pack_2d(torch.zeros(48, 128, device=cuda), block_r=32)


@pytest.mark.gpu
@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_mix_bus_compressed_on_card_matches_cpu(cuda, wire):
    M = 4
    p = {"w": _randn((M, 127), F32, 9, "cpu"), "b": _randn((M, 33, 5), F32, 10, "cpu"),
         "steps": torch.arange(M * 300, dtype=torch.int32).view(M, 300)}
    spec = GossipSpec(topology=T.undirected_ring(M), backend="fused")
    x_cpu, r_cpu = p, None
    x_gpu, r_gpu = _tree.map(lambda t: t.to(cuda), p), None
    before = quantize_pack_2d.launches
    for _ in range(3):
        x_cpu, r_cpu = bus.mix_bus_compressed(x_cpu, spec, wire_dtype=wire, residual=r_cpu,
                                              block_r=32)
        x_gpu, r_gpu = bus.mix_bus_compressed(x_gpu, spec, wire_dtype=wire, residual=r_gpu,
                                              block_r=32)
    torch.cuda.synchronize()
    assert quantize_pack_2d.launches == before + (3 if wire == "int8" else 0)
    for a, b in zip(_tree.leaves(x_cpu), _tree.leaves(x_gpu)):
        assert b.device.type == "cuda" and b.dtype == a.dtype
        torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0)
    for a, b in zip(r_cpu, r_gpu):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0)


FLASH_TOL = {F32: 2e-5, BF16: 3e-2}
# (B, Lq, Lkv, H, Hkv, hd, causal, window): lengths off the 64-row tile,
# Lq != Lkv both ways, windows smaller than a tile, MQA, every head dim;
# then the bf16 kernel's 128-row q and kv tiles: lengths 1 past a multiple,
# Lkv < Lq, windows that end inside a tile, each head dim
ODD_FLASH_CASES = [
    (2, 333, 333, 8, 2, 64, True, None),
    (1, 100, 100, 4, 2, 16, True, None),
    (1, 70, 150, 4, 1, 32, True, None),
    (1, 150, 70, 4, 2, 32, True, None),
    (1, 200, 200, 2, 2, 16, True, 5),
    (1, 130, 130, 4, 1, 128, False, 17),
    (1, 65, 65, 8, 1, 64, True, None),
    # rows that no key reaches (Lq >= Lkv + window): the mean of v
    (1, 150, 70, 4, 2, 32, True, 5),
    (1, 150, 70, 4, 2, 32, False, 5),
    (1, 200, 130, 2, 1, 64, False, 40),
    (1, 129, 129, 4, 2, 64, True, None),
    (2, 257, 257, 2, 1, 16, True, None),
    (1, 129, 257, 4, 2, 32, False, None),
    (1, 257, 129, 4, 2, 128, True, None),
    (1, 300, 300, 4, 2, 32, True, 100),
    (1, 385, 385, 2, 2, 128, True, 200),
    (1, 257, 257, 4, 1, 64, False, 70),
]


def _qkv(B, Lq, Lkv, H, Hkv, hd, dtype, device, seed=0):
    """(B, H, L, hd) views of (B, L, H, hd) tensors, as ops.attention passes them."""
    q = _randn((B, Lq, H, hd), dtype, seed, device)
    k = _randn((B, Lkv, Hkv, hd), dtype, seed + 1, device)
    v = _randn((B, Lkv, Hkv, hd), dtype, seed + 2, device)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ODD_FLASH_CASES)
@pytest.mark.parametrize("dtype", [F32, BF16])
def test_flash_attention_kernel_matches_plain_version(cuda, case, dtype):
    B, Lq, Lkv, H, Hkv, hd, causal, window = case
    q, k, v = _qkv(B, Lq, Lkv, H, Hkv, hd, dtype, cuda)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_reference(q, k, v, causal=causal, window=window)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=FLASH_TOL[dtype], rtol=0)
    if dtype == BF16:
        excess = ((out.float() - ref.float()).abs() - 2.0 ** -7 * ref.float().abs() - 1e-4)
        assert excess.max().item() <= 0


@pytest.mark.gpu
def test_flash_attention_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, F32, cuda)
    with pytest.raises(ValueError, match="operands"):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        flash_attention(q, k.to(BF16), v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q[..., :24], k[..., :24], v[..., :24])
    with pytest.raises(ValueError, match="contiguous head dim"):
        flash_attention(q.transpose(2, 3), k.transpose(2, 3), v.transpose(2, 3))
    # bf16 rows whose stride is not a multiple of 16 bytes: TMA cannot copy
    # them, and nothing takes them elsewhere
    qb, kb, vb = (t.to(BF16) for t in _qkv(1, 64, 64, 4, 2, 36, F32, cuda))
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_attention(qb[..., :32], kb[..., :32], vb[..., :32])
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(qb[..., :24], kb[..., :24], vb[..., :24])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,kernel", [(BF16, "flash_attention_fwd_wgmma_kernel"),
                                          (F32, "flash_attention_fwd_f32_kernel")])
def test_flash_attention_dtype_picks_its_one_kernel(cuda, dtype, kernel):
    """bf16 runs the wgmma kernel, float32 the CUDA-core kernel, and nothing
    else: the kernel names the profiler sees on the card."""
    from torch.profiler import ProfilerActivity, profile

    q, k, v = _qkv(1, 200, 200, 4, 2, 64, dtype, cuda)
    flash_attention(q, k, v)                     # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        flash_attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if "flash_attention_fwd" in e.key]
    assert names and all(kernel in n for n in names)


@pytest.mark.gpu
def test_flash_ops_attention_backward_raises(cuda):
    q, k, v = _qkv(1, 64, 64, 4, 2, 32, F32, cuda)
    q = q.transpose(1, 2).detach().requires_grad_()
    out = flash_ops.attention(q, k.transpose(1, 2), v.transpose(1, 2))
    with pytest.raises(NotImplementedError, match="backward"):
        out.sum().backward()


@pytest.mark.gpu
def test_generate_on_card_matches_cpu(cuda):
    """A prompt longer than the dense threshold: prefill through the kernel
    on the card, through the plain version on the CPU; same greedy tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import generate

    cfg = get_config("granite-3-2b", reduced=True, n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, 256, size=(2, 1100)).astype(np.int32)
    on_cpu = generate(params, cfg, prompt, n_new=6)
    before = flash_attention.launches
    on_card = generate(_tree.map(lambda x: x.to(cuda), params), cfg, prompt, n_new=6)
    assert flash_attention.launches == before + cfg.n_layers
    assert np.array_equal(on_cpu.tokens, on_card.tokens)
    np.testing.assert_allclose(on_card.logprobs, on_cpu.logprobs, atol=1e-4)


# ---------------------------------------------------------------------------
# The paper's problems, the simulator and telemetry on the card
# ---------------------------------------------------------------------------


def _sim_linear(cuda, M=4, n=8):
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split

    rng = np.random.default_rng(0)
    X = rng.normal(size=(256, n)).astype(np.float32)
    y = (X @ rng.normal(size=n)).astype(np.float32)

    def loss(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    def batches():
        bt = WorkerBatcher((X, y), pad_to_equal(random_split(256, M)), batch_size=16, seed=0)
        while True:
            yield bt.next()

    return loss, batches, {"w": torch.zeros(n, device=cuda)}


@pytest.mark.gpu
def test_paper_problem_fused_train_launches_once_per_step(cuda):
    """The classifier through train() on the fused bus: one gossip_mix launch
    per step, per-step losses within 1e-4 relative of the einsum run."""
    from repro_torch import problems
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.data import WorkerBatcher, pad_to_equal, random_split
    from repro_torch.optim import sgd
    from repro_torch.train import train

    arrays, _, p0, loss, _ = problems.problem_classifier(S=256, n=16)
    parts = pad_to_equal(random_split(256, 4))
    hist = {}
    for be in ("einsum", "fused"):
        bt = WorkerBatcher(arrays, parts, batch_size=8, seed=0)
        before = gossip_mix_2d.launches
        _, h = train(loss, replicate_for_workers(p0, 4), sgd(0.5), (bt.next() for _ in range(6)),
                     steps=6, gossip=GossipSpec(topology=T.undirected_ring(4), backend=be),
                     device=cuda, verbose=False)
        assert gossip_mix_2d.launches - before == (6 if be == "fused" else 0)
        hist[be] = h.loss
    np.testing.assert_allclose(hist["fused"], hist["einsum"], rtol=1e-4)


@pytest.mark.gpu
def test_sim_full_commit_launches_once_per_commit(cuda):
    from repro_torch.optim import momentum_sgd
    from repro_torch.sim import scenarios
    from repro_torch.train.loop import run_simulated

    loss, batches, p0 = _sim_linear(cuda)
    from repro_torch.core.decentralized import replicate_for_workers

    runs = {}
    for commit, be in (("slice", "einsum"), ("full", "fused")):
        before = gossip_mix_2d.launches
        runs[commit] = run_simulated(
            loss, replicate_for_workers(p0, 4), momentum_sgd(0.05, 0.9), batches(),
            gossip=GossipSpec(topology=T.undirected_ring(4), backend=be), commit=commit,
            scenario=scenarios.heavy_tail("spark", seed=7), rounds=4, device=cuda)
        commits = sum(1 for r in runs[commit].trace.records if r.kind == "compute_done")
        assert gossip_mix_2d.launches - before == (commits if be == "fused" else 0)
    s, f = runs["slice"], runs["full"]
    assert [r[:6] for r in s.trace.signature()] == [r[:6] for r in f.trace.signature()]
    torch.testing.assert_close(f.params["w"], s.params["w"], rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
def test_sim_commits_write_rows_in_place_on_card(cuda):
    """W, opt and the snapshot planes keep their storage across commits."""
    from repro_torch.core.decentralized import replicate_for_workers
    from repro_torch.optim import momentum_sgd
    from repro_torch.sim import Engine, SyncGossip, TrainExecutor, scenarios

    loss, batches, p0 = _sim_linear(cuda)
    topo = T.undirected_ring(4)
    ex = TrainExecutor(loss, momentum_sgd(0.05, 0.9), replicate_for_workers(p0, 4), batches(),
                       GossipSpec(topology=topo, backend="einsum"))
    proto = SyncGossip(executor=ex)
    ptrs = lambda: [x.data_ptr() for x in _tree.leaves((ex.W, ex.opt, proto._snaps.planes))]
    seen = []
    bind = proto.bind

    def bind_and_record(engine, stop_round=None):
        bind(engine, stop_round)
        seen.append(ptrs())

    proto.bind = bind_and_record
    Engine(topo, scenarios.heavy_tail("spark", seed=1)).run(proto, until_round=6)
    assert proto.rounds.min() == 6
    assert ptrs() == seen[0]
    assert ex.W["w"].is_cuda and proto._snaps.planes[0]["w"].is_cuda


@pytest.mark.gpu
def test_fused_mix_range_encloses_the_kernel_in_a_profile(cuda, tmp_path):
    import json

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import telemetry

    params = {"w": _randn((4, 1000), F32, 3, cuda)}
    spec = GossipSpec(topology=T.undirected_ring(4), backend="fused")
    with telemetry.run() as tel:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bus.mix_bus(params, spec)
            torch.cuda.synchronize()
    assert tel.counters["bus.mix_calls"] == 1
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    evs = json.load(open(path))["traceEvents"]
    ranges = [e for e in evs if e.get("name") == "bus.fused_mix" and e.get("ph") == "X"]
    kernels = [e for e in evs if e.get("cat") == "kernel" and "gossip_mix" in e.get("name", "")]
    assert ranges and len(kernels) == 1
    corr = kernels[0].get("args", {}).get("correlation")
    launch = [e for e in evs if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and e.get("args", {}).get("correlation") == corr]
    host = [r for r in ranges if r.get("cat") == "user_annotation"]
    device = [r for r in ranges if r.get("cat") == "gpu_user_annotation"]
    inside = lambda t, r: r["ts"] <= t <= r["ts"] + r["dur"]
    assert (launch and any(inside(launch[0]["ts"], r) for r in host)) or \
        any(inside(kernels[0]["ts"], r) for r in device)
