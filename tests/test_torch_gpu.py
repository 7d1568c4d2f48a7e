"""Card-only tests: the port's CUDA kernels against their plain PyTorch
versions on the card. They skip without a CUDA device and need no JAX, so
they run where the port runs:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Tolerances are the reference's kernel-test ones: atol 1e-5 for float32,
5e-2 for bf16. Kernel and plain version round the same float32 operations
in the same order, so in practice they agree bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch import _tree
from repro_torch.core import bus
from repro_torch.core import topology as T
from repro_torch.core.gossip import GossipSpec
from repro_torch.kernels.gossip_mix import gossip_mix_2d, gossip_mix_reference

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
