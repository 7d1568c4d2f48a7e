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
import time

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
# head dims 192 and 256 (nemotron, gemma): the bf16 kernel's 64-row kv
# tiles; MQA, GQA, windows, lengths off a tile, Lq != Lkv, rows no key reaches
WIDE_FLASH_CASES = [
    (1, 200, 200, 8, 1, 256, True, None),
    (2, 333, 333, 4, 2, 192, True, 100),
    (1, 150, 300, 4, 1, 256, True, 64),
    (1, 300, 150, 4, 2, 192, False, None),
    (1, 65, 65, 2, 1, 192, True, None),
    (1, 385, 385, 2, 2, 256, True, 200),
    (1, 150, 70, 4, 2, 256, True, 5),
    (1, 257, 129, 4, 2, 192, True, None),
]


def _qkv(B, Lq, Lkv, H, Hkv, hd, dtype, device, seed=0):
    """(B, H, L, hd) views of (B, L, H, hd) tensors, as ops.attention passes them."""
    q = _randn((B, Lq, H, hd), dtype, seed, device)
    k = _randn((B, Lkv, Hkv, hd), dtype, seed + 1, device)
    v = _randn((B, Lkv, Hkv, hd), dtype, seed + 2, device)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ODD_FLASH_CASES + WIDE_FLASH_CASES)
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


@pytest.mark.gpu
@pytest.mark.parametrize("Lp", [20, 45])
def test_ring_decode_matches_full_cache_windowed_decode(cuda, Lp):
    """Reduced mixtral (window 32), float32 on the card: a prompt shorter
    and longer than the window, then decode steps across the ring's wrap,
    through the ring cache against a full-length cache with the window mask
    (the reference's non-ring branch), and against the CPU's ring route."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    cfg = get_config("mixtral-8x7b", reduced=True)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, Lp)).astype(np.int32)
    fed = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 16)).astype(np.int32)
    max_len = Lp + fed.shape[1]

    def run(p, dev, ring):
        tok = torch.from_numpy(prompt).to(dev)
        if ring:
            logits, caches, *_ = Mo.prefill(p, cfg, tok, max_len=max_len)
            assert caches[0][0].k.shape[1] == cfg.window
        else:
            caches = Mo.init_cache(p, dataclasses.replace(cfg, window=None), 2, max_len)
            _, caches = Mo.forward(p, cfg, tok, caches=caches)
            assert caches[0][0].k.shape[1] == max_len
        out = []
        for t in range(fed.shape[1]):
            logits, caches = Mo.decode_step(p, cfg, caches, torch.from_numpy(fed[:, t:t + 1]).to(dev))
            out.append(logits[:, -1].float().cpu())
        return torch.stack(out)

    on_card = _tree.map(lambda x: x.to(cuda), params)
    ring = run(on_card, cuda, True)
    torch.testing.assert_close(ring, run(on_card, cuda, False), atol=1e-5, rtol=0)
    torch.testing.assert_close(ring, run(params, "cpu", True), atol=1e-5, rtol=0)


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


# ---------------------------------------------------------------------------
# Continuous batching: the decode step as one CUDA graph
# ---------------------------------------------------------------------------


def _continuous(cuda, dtype, temperature=0.0):
    """A reduced granite (2 scanned layers) ContinuousBatcher on the card
    with 4 requests in flight after one step."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config("granite-3-2b", reduced=True, scan_layers=True,
                     param_dtype=dtype, compute_dtype=dtype)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    cb = ContinuousBatcher(_tree.map(lambda x: x.to(cuda), params), cfg, 4, 32, page_size=4,
                           max_new=8, temperature=temperature, seed=1)
    rng = np.random.default_rng(0)
    for n in (3, 9, 5, 12):
        cb.submit(rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), 8)
    cb.step()
    return cb


def _equal_but_dump(a, b, dump):
    """Leaf by leaf bit equality of two decode states; the pools' dump page
    (garbage by design, written by every inactive slot) is left out."""
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        if x.is_floating_point() and x.dim() >= 4:
            keep = [i for i in range(x.shape[-4]) if i != dump]
            x, y = x[..., keep, :, :, :], y[..., keep, :, :, :]
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_continuous_graph_step_equals_eager_step(cuda, dtype, temperature):
    """One graph replay against the same step run eagerly on a copy of the
    state (for sampling, from the same generator state): bit for bit."""
    cb = _continuous(cuda, dtype, temperature)
    st = cb.stats()
    assert st["decode"] == "cuda graph" and st["decode_traces"] == 1
    twin = _tree.map(torch.clone, cb.state())
    gen_state = cb._gen.get_state()
    cb.step()                                   # graph replay
    cb._gen.set_state(gen_state)
    cb.decode_eager(*twin)
    torch.cuda.synchronize()
    _equal_but_dump(cb.state(), twin, cb.pool.dump)
    assert int(cb.n_gen.sum()) == 4 * 3         # the four slots advanced


@pytest.mark.gpu
def test_continuous_reset_keeps_the_captured_storage(cuda):
    """warmup() resets the state in place: the tensors the graph captured
    keep their storage, and the graph still decodes what eager decodes."""
    cb = _continuous(cuda, "float32")
    ptrs = [t.data_ptr() for t in _tree.leaves(cb.state())]
    cb.run_until_done()
    cb.warmup()
    assert [t.data_ptr() for t in _tree.leaves(cb.state())] == ptrs
    assert cb.stats()["decode_traces"] == 1
    cb.submit(np.arange(1, 7, dtype=np.int32), 8)
    cb.step()
    twin = _tree.map(torch.clone, cb.state())
    cb.step()
    cb.decode_eager(*twin)
    _equal_but_dump(cb.state(), twin, cb.pool.dump)
    st = cb.stats()
    assert (st["decode_replays"], st["eager_decodes"]) == (2, 0)


@pytest.mark.gpu
def test_first_token_clock_reads_the_device_time(cuda):
    """FirstTokenClock puts a mark queued behind ~50 ms of device work at
    the host time that work ended: after the host queued it, before the
    host's sync returned, and not at the time of the mark's launch."""
    from repro_torch.serving.engine import FirstTokenClock

    clock = FirstTokenClock(cuda)
    t0 = time.perf_counter()
    torch.cuda._sleep(100_000_000)          # ~50 ms at the H100's clock
    t_launch = time.perf_counter()
    clock.mark([7])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    at = clock.read(7)
    assert t0 < at <= t1 + 1e-3
    assert at - t_launch > 0.5 * (t1 - t_launch)


@pytest.mark.gpu
def test_continuous_on_card_matches_cpu(cuda):
    """The same requests through a batcher on the card and one on the CPU:
    the same greedy tokens, logprobs within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config("granite-3-2b", reduced=True)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, cfg.vocab_size, size=int(rng.integers(2, 11))).astype(np.int32),
             int(rng.integers(1, 9))) for _ in range(6)]
    out = []
    for p in (params, _tree.map(lambda x: x.to(cuda), params)):
        cb = ContinuousBatcher(p, cfg, 4, 32, page_size=4, max_new=8)
        cb.warmup()
        rids = [cb.submit(t, n) for t, n in reqs]
        cb.run_until_done()
        out.append([(cb.done[r], cb.done_logprobs[r]) for r in rids])
    for (t_cpu, l_cpu), (t_gpu, l_gpu) in zip(*out):
        assert np.array_equal(t_cpu, t_gpu)
        np.testing.assert_allclose(l_gpu, l_cpu, atol=1e-4)


# ---------------------------------------------------------------------------
# MLA, Mamba-2 and the RG-LRU hybrid on the card
# ---------------------------------------------------------------------------


@pytest.mark.gpu
def test_mla_long_prefill_takes_the_kernel_with_padded_v(cuda):
    """Reduced deepseek-v2-lite with qk head dim 64 (a kernel head dim) and
    v head dim 32: a prompt past the dense threshold takes the float32
    kernel once per layer with v zero-padded to 64; the same greedy tokens
    as the CPU's plain version."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import generate

    cfg = get_config("deepseek-v2-lite-16b", reduced=True, qk_nope_dim=48, qk_rope_dim=16)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size, size=(2, 1100))
    prompt = prompt.astype(np.int32)
    on_cpu = generate(params, cfg, prompt, n_new=6)
    before = flash_attention.launches
    on_card = generate(_tree.map(lambda x: x.to(cuda), params), cfg, prompt, n_new=6)
    assert flash_attention.launches == before + cfg.n_layers
    assert np.array_equal(on_cpu.tokens, on_card.tokens)
    np.testing.assert_allclose(on_card.logprobs, on_cpu.logprobs, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_moe_continuous_graph_step_equals_eager_step(cuda, dtype):
    """Reduced deepseek-v2-lite (MLA, capacity-routed MoE, 3 layers, the MoE
    ones scanned) through ContinuousBatcher on the card: the decode step,
    MoE included, captured as one CUDA graph; a replay equals the same step
    run eagerly on a copy of the state bit for bit (the dump page left
    out: pages dim 1 of a stacked pool, 0 of a single layer's)."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import ContinuousBatcher

    cfg = get_config("deepseek-v2-lite-16b", reduced=True, n_layers=3, scan_layers=True,
                     param_dtype=dtype, compute_dtype=dtype)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    cb = ContinuousBatcher(_tree.map(lambda x: x.to(cuda), params), cfg, 4, 32, page_size=4,
                           max_new=8)
    assert cb.stats()["decode"] == "cuda graph"
    rng = np.random.default_rng(0)
    for n in (3, 9, 5, 12):
        cb.submit(rng.integers(0, cfg.vocab_size, size=n).astype(np.int32), 8)
    cb.step()
    twin = _tree.map(torch.clone, cb.state())
    cb.step()                                   # graph replay
    cb.decode_eager(*twin)
    torch.cuda.synchronize()
    keep = torch.tensor([i for i in range(cb.pool.n_pages) if i != cb.pool.dump], device=cuda)
    for seg_g, seg_e in zip(cb.caches, twin[0]):
        stacked = not isinstance(seg_g, list)
        for g, e in (zip([seg_g], [seg_e]) if stacked else zip(seg_g, seg_e)):
            for i, (a, b) in enumerate(zip(g, e)):
                if i < 2:
                    a, b = (t.index_select(int(stacked), keep) for t in (a, b))
                assert torch.equal(a, b)
    for a, b in zip(cb.state()[1:], twin[1:]):
        assert torch.equal(a, b)
    assert cb.stats()["decode_replays"] == 2 and int(cb.n_gen.sum()) == 4 * 3


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_recurrent_generate_on_card_matches_cpu(cuda, name):
    """Reduced Mamba-2 and RG-LRU hybrid, float32: a 40-token prompt (past
    the hybrid's 32-token window) and 8 decode steps on the card, the same
    greedy tokens as on the CPU, logprobs within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo
    from repro_torch.serving import generate

    cfg = get_config(name, reduced=True)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(2, 40)).astype(np.int32)
    on_cpu = generate(params, cfg, prompt, n_new=8)
    on_card = generate(_tree.map(lambda x: x.to(cuda), params), cfg, prompt, n_new=8)
    assert np.array_equal(on_cpu.tokens, on_card.tokens)
    np.testing.assert_allclose(on_card.logprobs, on_cpu.logprobs, atol=1e-4)


# ---------------------------------------------------------------------------
# The encoder-decoder on the card
# ---------------------------------------------------------------------------


def _seamless_1100():
    """Reduced seamless (float32, 2 + 2 layers) over 1100 frames: past the
    1024-key threshold, so prefill takes the kernel, non-causal."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    cfg = get_config("seamless-m4t-large-v2", reduced=True, encoder_seq=1100)
    params = Mo.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    rng = np.random.default_rng(3)
    enc = rng.normal(size=(2, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab_size, size=(2, 9)).astype(np.int32)
    return cfg, params, enc, prompt


@pytest.mark.gpu
def test_encdec_generate_on_card_matches_cpu(cuda):
    """The encoder's non-causal attention through the kernel on the card,
    through its plain version on the CPU; the same greedy tokens, logprobs
    within 1e-4."""
    from repro_torch.serving import generate

    cfg, params, enc, prompt = _seamless_1100()
    on_cpu = generate(params, cfg, prompt, n_new=8, enc_embeds=enc)
    before = flash_attention.launches
    on_card = generate(_tree.map(lambda x: x.to(cuda), params), cfg, prompt, n_new=8,
                       enc_embeds=enc)
    assert flash_attention.launches == before + cfg.encoder_layers
    assert np.array_equal(on_cpu.tokens, on_card.tokens)
    np.testing.assert_allclose(on_card.logprobs, on_cpu.logprobs, atol=1e-4)


@pytest.mark.gpu
def test_encoder_prefill_launches_the_kernel_and_training_never(cuda):
    """One launch per encoder layer in prefill, none in loss_fn (the kernel
    has no backward: training encodes through blockwise_attention), whose
    gradients are finite."""
    from repro_torch.models import model as Mo

    cfg, params, enc, prompt = _seamless_1100()
    params = _tree.map(lambda x: x.to(cuda), params)
    enc, tok = torch.from_numpy(enc).to(cuda), torch.from_numpy(prompt).to(cuda)
    before = flash_attention.launches
    with torch.no_grad():
        Mo.prefill(params, cfg, tok, max_len=12, enc_embeds=enc)
    assert flash_attention.launches == before + cfg.encoder_layers
    grads = torch.func.grad(lambda p: Mo.loss_fn(p, cfg, {"tokens": tok, "enc_embeds": enc}))(
        params)
    assert flash_attention.launches == before + cfg.encoder_layers
    assert all(bool(torch.isfinite(g).all()) for g in _tree.leaves(grads))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["granite-3-2b", "seamless-m4t-large-v2"])
def test_remat_gradients_on_card_equal_or_within_the_float32_twin(cuda, name):
    """``cfg.remat`` under the step's vmap(grad_and_value) on the card, bf16
    reduced configs (seamless with stacked layers, so its encoder is
    recomputed too): gradients equal remat off bit for bit or, where a card
    kernel is not deterministic, within twice the remat-off route's
    distance from a float32 gradient; no flash_attention launch."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    cfg = get_config(name, reduced=True, param_dtype="bfloat16", compute_dtype="bfloat16",
                     scan_layers=True, remat=True)
    params = _tree.map(lambda x: x[None].expand((2,) + x.shape).contiguous(), Mo.init(
        torch.Generator(device="cuda").manual_seed(0), cfg, device=cuda))
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 2, 64), generator=gen,
                                     device=cuda)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn((2, 2, cfg.encoder_seq, cfg.d_model),
                                          generator=gen, device=cuda, dtype=torch.bfloat16)

    def grads(c, p):
        return torch.func.vmap(torch.func.grad_and_value(
            lambda q, b: Mo.loss_fn(q, c, b)))(p, batch)[0]

    before = flash_attention.launches
    g_on = grads(cfg, params)
    g_off = grads(dataclasses.replace(cfg, remat=False), params)
    assert flash_attention.launches == before
    pairs = list(zip(_tree.leaves(g_on), _tree.leaves(g_off)))
    if all(torch.equal(a, b) for a, b in pairs):
        return
    c32 = dataclasses.replace(cfg, remat=False, param_dtype="float32", compute_dtype="float32")
    g32 = grads(c32, _tree.map(lambda x: x.float(), params))
    twin = max((b.float() - c).abs().max().item() for b, c in zip(_tree.leaves(g_off),
                                                                   _tree.leaves(g32)))
    diff = max((a.float() - b.float()).abs().max().item() for a, b in pairs)
    assert diff <= 2 * twin, (diff, twin)


@pytest.mark.gpu
def test_world_size_one_mesh_mix_on_card_equals_meshless(cuda, tmp_path):
    """A world-size-1 NCCL group and the live 1 x 1 WorkerMesh hosting M = 4
    workers: the fused mix and an int8 round launch gossip_mix and
    quant_pack once each and equal the meshless path bit for bit."""
    import torch.distributed as dist

    from repro_torch.core.gossip import mix_pytree
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh

    params = {"a": _randn((4, 300, 7), BF16, 0, cuda), "b": _randn((4, 129), F32, 1, cuda)}
    topo = T.undirected_ring(4)
    flat = GossipSpec(topology=topo, backend="fused")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=1, device="cuda"))
        spec = GossipSpec.for_mesh(topo, wm, backend="fused")
        g0, q0 = gossip_mix_2d.launches, quantize_pack_2d.launches
        mixed = mix_pytree(params, spec, wm)
        assert gossip_mix_2d.launches == g0 + 2          # one per dtype group
        comp, res = bus.mix_bus_compressed(params, spec, wm, wire_dtype="int8")
        assert quantize_pack_2d.launches == q0 + 2        # both float groups go int8
        want = mix_pytree(params, flat)
        want_c, want_r = bus.mix_bus_compressed(params, flat, wire_dtype="int8")
        for a, b in zip(_tree.leaves((mixed, comp, res)), _tree.leaves((want, want_c, want_r))):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def _granite_tiny(cuda, M=4):
    """A 2-layer granite at narrow widths in bf16, different weights per
    worker from a numpy seed, and 3 batches of (M, 2, 16) tokens."""
    from repro_torch.configs import get_config
    from repro_torch.models import model as Mo

    cfg = get_config("granite-3-2b", reduced=True, n_layers=2, d_model=64, n_heads=4,
                     n_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
                     param_dtype="bfloat16", compute_dtype="bfloat16")
    rng = np.random.default_rng(4)
    params = _tree.map(lambda d: torch.from_numpy(
        (0.05 * rng.normal(size=(M,) + tuple(d.shape)) + (d.init == "ones")).astype(np.float32)
    ).to(cuda, BF16), Mo.model_defs(cfg))
    toks = torch.from_numpy(rng.integers(0, 256, size=(3, M, 2, 16))).to(cuda)
    return cfg, params, [{"tokens": toks[k]} for k in range(3)], (
        lambda p, b: Mo.loss_fn(p, cfg, b))


@pytest.mark.gpu
def test_world_size_one_mesh_train_step_on_card_equals_meshless(cuda, tmp_path):
    """make_train_step(mesh=, param_specs=) on the live 1 x 1 NCCL mesh
    hosting M = 4 workers: 3 fused steps equal the meshless step's params
    and losses bit for bit, one gossip_mix launch per step."""
    import torch.distributed as dist

    from repro_torch.core.decentralized import init_state, make_train_step
    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    from repro_torch.launch.shardings import param_pspecs
    from repro_torch.optim import momentum_sgd

    cfg, params, batches, loss = _granite_tiny(cuda)
    opt = momentum_sgd(0.05, 0.9)
    spec = GossipSpec(topology=T.undirected_ring(4), backend="fused")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=1, device="cuda"))
        runs = {}
        for mesh in (None, wm):
            step = make_train_step(loss, opt, gossip=spec, mesh=mesh,
                                   param_specs=param_pspecs(cfg, wm, "gossip") if mesh else None)
            s, losses = init_state(params, opt), []
            g0 = gossip_mix_2d.launches
            for b in batches:
                s, m = step(s, b)
                losses.append(m.loss)
            torch.cuda.synchronize()
            assert gossip_mix_2d.launches - g0 == len(batches)
            runs[mesh is None] = (s.params, torch.stack(losses))
    finally:
        dist.destroy_process_group()
    for a, b in zip(_tree.leaves(runs[False]), _tree.leaves(runs[True])):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_async_sharded_save_on_a_mesh_holds_no_device_memory(cuda, tmp_path):
    """AsyncCheckpointWriter.save(wmesh=) on the 1 x 1 NCCL mesh: the
    snapshot is a pinned host copy (the device's allocation does not grow),
    the params changed in place right after do not reach the files, which
    equal the meshless save's member for member; they restore bit for bit."""
    import zipfile

    import torch.distributed as dist

    from repro_torch.launch.mesh import WorkerMesh, make_host_mesh
    from repro_torch.train import checkpoint as ckpt

    _, params, _, _ = _granite_tiny(cuda)
    want = _tree.map(lambda x: x.clone(), params)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        wm = WorkerMesh.from_mesh(make_host_mesh(data=1, model=1, device="cuda")).mesh
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        with ckpt.AsyncCheckpointWriter() as w:
            w.save(str(tmp_path / "mesh"), params, step=2, wmesh=wm)
            grown = torch.cuda.memory_allocated() - before
            _tree.map(lambda x: x.add_(1.0), params)          # the next step, in place
    finally:
        dist.destroy_process_group()
    assert grown == 0
    ckpt.save_sharded(str(tmp_path / "flat"), want, step=2)
    for j in range(4):
        files = [str(tmp_path / f"{b}.shard-w{j}.npz") for b in ("mesh", "flat")]
        members = []
        for f in files:
            with zipfile.ZipFile(f) as z:
                members.append([(n, z.read(n)) for n in z.namelist()])
        assert members[0] == members[1]
    back = ckpt.restore(str(tmp_path / "mesh"), want, device=cuda)
    for a, b in zip(_tree.leaves(back), _tree.leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_async_save_snapshots_to_reserved_pinned_memory(cuda, tmp_path):
    """Meshless saves, monolithic and sharded, take the same snapshot as a
    mesh's: pinned host buffers, reserved ahead on the writer's thread and
    returned after each write, no device memory; the params changed in
    place right after reach no file."""
    from repro_torch.train import checkpoint as ckpt

    _, params, _, _ = _granite_tiny(cuda)
    want = _tree.map(lambda x: x.clone(), params)
    key = tuple((tuple(x.shape), x.dtype) for x in _tree.leaves(params))
    with ckpt.AsyncCheckpointWriter() as w:
        w._reserve(params)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        w.save(str(tmp_path / "mono.npz"), params, step=1)
        w.save(str(tmp_path / "sharded"), params, step=1, sharded=True)
        grown = torch.cuda.memory_allocated() - before
        _tree.map(lambda x: x.add_(1.0), params)          # the next step, in place
        w.wait()
        assert len(w._pinned[key]) == 2           # the reserved sets, returned
        assert all(b.is_pinned() for bufs in w._pinned[key] for b in bufs)
    assert grown == 0
    for f in ("mono.npz", "sharded"):
        back = ckpt.restore(str(tmp_path / f), want, device=cuda)
        for a, b in zip(_tree.leaves(back), _tree.leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_tensor_parallel_functions_under_vmap_at_group_size_one_on_card(cuda, tmp_path):
    """copy_to_model, reduce_from_model and max_over_model on CUDA tensors,
    their model group a world-size-1 NCCL group: inside a two-layer product
    under vmap(grad_and_value) over 3 stacked workers, plain and through
    remat.checkpoint, the loss and gradients equal the same function with
    no model group bit for bit (a sum over one rank is the value)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import tensor_parallel as tp
    from repro_torch.models import remat

    w1, w2 = _randn((3, 64, 96), F32, 0, cuda), _randn((3, 96, 64), F32, 1, cuda)
    x = _randn((3, 5, 64), F32, 2, cuda)

    def run(use_remat):
        def loss(w1, w2, x):
            def body(x, w1, w2):
                return tp.reduce_from_model(torch.relu(tp.copy_to_model(x) @ w1) @ w2)
            h = remat.checkpoint(body, x, w1, w2) if use_remat else body(x, w1, w2)
            return torch.sum(h ** 2) + torch.sum(tp.max_over_model(h))
        return torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1, 2)))(w1, w2, x)

    want = {r: run(r) for r in (False, True)}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        token = mesh_lib._MODEL.set(mesh_lib.ModelShard(dist.group.WORLD, 1, 0))
        try:
            got = {r: run(r) for r in (False, True)}
        finally:
            mesh_lib._MODEL.reset(token)
    finally:
        dist.destroy_process_group()
    for r in (False, True):
        for a, b in zip(_tree.leaves(got[r]), _tree.leaves(want[r])):
            assert a.is_cuda and torch.equal(a, b)


@pytest.mark.gpu
def test_gather_from_model_under_vmap_at_group_size_one_on_card(cuda, tmp_path):
    """gather_from_model on CUDA tensors, its model group a world-size-1
    NCCL group: inside an MoE-like router (the gathered logits through a
    softmax) under vmap(grad_and_value) over 3 stacked workers, the loss
    and gradients equal the same function with no model group bit for bit
    (a gather over one rank, and its backward's slice, are the value)."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import tensor_parallel as tp

    w, x = _randn((3, 64, 8), F32, 0, cuda), _randn((3, 5, 64), F32, 1, cuda)

    def run():
        def loss(w, x):
            z = tp.gather_from_model(tp.copy_to_model(x) @ w, -1)
            return torch.sum(torch.softmax(z, -1) * torch.arange(8.0, device=z.device))
        return torch.func.vmap(torch.func.grad_and_value(loss, argnums=(0, 1)))(w, x)

    want = run()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        token = mesh_lib._MODEL.set(mesh_lib.ModelShard(dist.group.WORLD, 1, 0))
        try:
            got = run()
        finally:
            mesh_lib._MODEL.reset(token)
    finally:
        dist.destroy_process_group()
    for a, b in zip(_tree.leaves(got), _tree.leaves(want)):
        assert a.is_cuda and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 4, 8])
def test_moe_expert_shards_fill_only_their_slots_on_card(cuda, k):
    """On the card, each of k expert shards fills and runs only its slots
    [r·(E/k)·C, (r+1)·(E/k)·C), dropped tokens included; the k partial
    outputs sum to the whole dispatch (rtol 1e-5 / atol 1e-6). float64, as
    the CPU twin: in float32 cuBLAS picks other products for a batch of
    one expert than of eight, 8.8e-6 apart, and only a wrong slot should
    show here."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as Ly

    cfg = get_config("mixtral-8x7b", reduced=True, d_model=64, n_experts=8, top_k=2,
                     d_ff_expert=32, param_dtype="float64", compute_dtype="float64")
    rng = np.random.default_rng(0)
    params = _tree.map(lambda d: torch.from_numpy(0.3 * rng.normal(size=d.shape)).to(cuda),
                       Ly.moe_defs(cfg))
    xf = _randn((96, 64), F32, 3, cuda).double()
    topw, _, keep, slot, capacity, _ = Ly._route_logits(cfg, (xf @ params["router"]).float())
    assert not bool(keep.all())
    want = Ly._dispatch(params, cfg, xf, topw, keep, slot, capacity)
    e = cfg.n_experts // k
    total = torch.zeros_like(want)
    for r in range(k):
        local = {n: params[n][r * e:(r + 1) * e] for n in ("w_gate", "w_up", "w_down")}
        total += Ly._dispatch(local, cfg, xf, topw, keep, slot, capacity, first=r * e)
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-6)
