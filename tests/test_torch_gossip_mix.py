"""The gossip_mix kernel's plain version against the JAX reference kernel
(Pallas, interpret mode) and its oracle. The CUDA kernel is held against the
plain version on the card in tests/test_torch_gpu.py.

Tolerances are the reference's kernel-test ones (tests/test_kernels.py):
atol 1e-5 for float32 and 5e-2 for bf16. Both sides accumulate in float32
in the same order, so the float32 gap is rounding-order noise (FMA
contraction in XLA) and bf16 differs at most by one rounding of the output.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gossip_mix.kernel import gossip_mix_2d as jax_gossip_mix_2d  # noqa: E402
from repro.kernels.gossip_mix.ref import gossip_mix_reference as jax_reference  # noqa: E402
from repro_torch.kernels.gossip_mix import gossip_mix_2d, gossip_mix_reference  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
SHAPES = [(37, 129)] + [pytest.param(s, marks=pytest.mark.slow)
                        for s in [(256, 128), (1000, 3)]]


def _inputs(shape, k, dtype, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=shape).astype(np.float32)
    nbr = rng.normal(size=(k,) + shape).astype(np.float32)
    wts = rng.dirichlet(np.ones(k + 1)).astype(np.float32)
    u = rng.normal(size=shape).astype(np.float32)
    to_t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))
    to_j = lambda a: jnp.asarray(a, dtype)
    return (to_t(w), to_t(nbr), wts, to_t(u)), (to_j(w), to_j(nbr), jnp.asarray(wts), to_j(u))


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32),
                      np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("with_update", [True, False])
def test_plain_version_matches_jax_kernel(shape, dtype, k, with_update):
    (w, nbr, wts, u), (jw, jnbr, jwts, ju) = _inputs(shape, k, dtype, seed=k)
    eta = 0.1
    launches = gossip_mix_2d.launches
    if with_update:
        out = gossip_mix_2d(w, nbr, wts, u, eta)
        jout = jax_gossip_mix_2d(jw, jnbr, jwts, ju, jnp.asarray([eta], jnp.float32),
                                 block_r=shape[0], block_c=shape[1], interpret=True)
        jref = jax_reference(jw, jnbr, jwts, ju, eta)
    else:
        out = gossip_mix_2d(w, nbr, wts)
        jout = jax_gossip_mix_2d(jw, jnbr, jwts, block_r=shape[0], block_c=shape[1],
                                 interpret=True)
        jref = jax_reference(jw, jnbr, jwts, jnp.zeros_like(ju), 0.0)
    assert gossip_mix_2d.launches == launches      # CPU tensors: plain version
    assert torch.equal(out, gossip_mix_reference(w, nbr, wts, u if with_update else None,
                                                 eta if with_update else None))
    assert out.dtype == w.dtype and out.shape == w.shape
    for j in (jout, jref):
        np.testing.assert_allclose(_np(out), _np(j), atol=TOL[dtype], rtol=0)


def test_mixed_dtypes_match_jax_oracle():
    (w, nbr, wts, _), (jw, jnbr, jwts, _) = _inputs((9, 16), 2, "bfloat16", seed=0)
    u = torch.linspace(-1, 1, 9 * 16).reshape(9, 16)                  # float32 update
    out = gossip_mix_2d(w, nbr, wts, u, -1.0)
    jref = jax_reference(jw, jnbr, jwts, jnp.asarray(u.numpy()), -1.0)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), _np(jref), atol=TOL["bfloat16"], rtol=0)


def test_wrapper_checks_its_arguments():
    w, nbr = torch.zeros(4, 8), torch.zeros(2, 4, 8)
    with pytest.raises(ValueError, match="weights"):
        gossip_mix_2d(w, nbr, [0.5, 0.5])
    with pytest.raises(ValueError, match="stack"):
        gossip_mix_2d(w, torch.zeros(2, 4, 9), [0.2, 0.4, 0.4])
    with pytest.raises(ValueError, match="eta"):
        gossip_mix_2d(w, nbr, [0.2, 0.4, 0.4], torch.zeros(4, 8))
    with pytest.raises(ValueError, match="update"):
        gossip_mix_2d(w, nbr, [0.2, 0.4, 0.4], torch.zeros(4, 9), 1.0)
