"""The port's flat gossip bus against the JAX reference: ``mix_bus`` (meshless,
fused kernel) and the dense ``mix_pytree_reference`` oracle, plus the einsum
backend in bf16.

Tolerances: float32 atol 1e-5 (both sides accumulate in float32; only the
order of the dense oracle's sum differs); bf16 atol 5e-2, the reference's
bf16 kernel tolerance (one rounding of values of order 1).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bus as jbus  # noqa: E402
from repro.core import gossip as jgossip  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.core import bus as tbus  # noqa: E402
from repro_torch.core import gossip as tgossip  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402

CASES = [(4, "ring", 1), (4, "ring", 3), (4, "torus", 3), (4, "clique", 1),
         (8, "ring", 3), (8, "clique", 3)] + [
    pytest.param(*c, marks=pytest.mark.slow)
    for c in [(9, "torus", 1), (8, "hypercube", 3), (16, "torus", 3)]]


def _tree_np(M, dtype, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, 50, 50)).astype(dtype),
            "layers": [rng.normal(size=(M, 129)).astype(dtype),
                       rng.normal(size=(M, 7, 5)).astype(dtype)],
            "b": rng.normal(size=(M, 3)).astype(dtype)}


def _specs(M, name, backend):
    return (jgossip.GossipSpec(topology=JT.make(name, M), backend=backend),
            tgossip.GossipSpec(topology=TT.make(name, M), backend=backend))


def _assert_close(jtree, ttree, atol):
    jl, tl = jax.tree.leaves(jtree), _tree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.float().numpy(), np.asarray(a, np.float32),
                                   atol=atol, rtol=0)


@pytest.mark.parametrize("M,name,nchunks", CASES)
def test_mix_bus_matches_reference(M, name, nchunks):
    p_np, u_np = _tree_np(M, np.float32, 0), _tree_np(M, np.float32, 1)
    jspec, tspec = _specs(M, name, "fused")
    jp, ju = jax.tree.map(jnp.asarray, p_np), jax.tree.map(jnp.asarray, u_np)
    tp, tu = (convert.params_from_jax(x, device="cpu") for x in (p_np, u_np))
    # block_r=8 gives the 24-row buffer three row blocks, so nchunks=3 splits it
    assert tbus.plan_layout(tp).groups[0].rows == 24
    out = tbus.mix_bus(tp, tspec, updates=tu, eta=-1.0, nchunks=nchunks, block_r=8)
    jout = jbus.mix_bus(jp, jspec, updates=ju, eta=-1.0, nchunks=nchunks,
                        interpret=True, block_r=8)
    _assert_close(jout, out, 1e-5)
    dense = jax.tree.map(lambda m, u: m + u,
                         jgossip.mix_pytree_reference(jp, jspec.topology.A), ju)
    _assert_close(dense, out, 1e-5)
    # the pure mix (no update) against the dense oracle
    _assert_close(jgossip.mix_pytree_reference(jp, jspec.topology.A),
                  tbus.mix_bus(tp, tspec, nchunks=nchunks, block_r=8), 1e-5)


def test_mix_bus_bf16_matches_reference():
    p_np = _tree_np(4, jnp.bfloat16, 2)
    u_np = _tree_np(4, jnp.bfloat16, 3)
    jspec, tspec = _specs(4, "ring", "fused")
    out = tbus.mix_bus(convert.params_from_jax(p_np, device="cpu"), tspec,
                       updates=convert.params_from_jax(u_np, device="cpu"), eta=-1.0)
    jout = jbus.mix_bus(jax.tree.map(jnp.asarray, p_np), jspec,
                        updates=jax.tree.map(jnp.asarray, u_np), eta=-1.0, interpret=True)
    _assert_close(jout, out, 5e-2)
    assert {x.dtype for x in _tree.leaves(out)} == {torch.bfloat16}


def test_single_worker_has_no_communication():
    p_np, u_np = _tree_np(1, np.float32, 4), _tree_np(1, np.float32, 5)
    jspec, tspec = _specs(1, "clique", "fused")
    tp = convert.params_from_jax(p_np, device="cpu")
    out = tbus.mix_bus(tp, tspec, updates=convert.params_from_jax(u_np, device="cpu"),
                       eta=-1.0)
    jout = jbus.mix_bus(jax.tree.map(jnp.asarray, p_np), jspec,
                        updates=jax.tree.map(jnp.asarray, u_np), eta=-1.0, interpret=True)
    _assert_close(jout, out, 1e-6)
    assert tbus.mix_bus(tp, tspec) is tp


@pytest.mark.parametrize("M,name", [(4, "ring"), (9, "torus")])
def test_einsum_backend_bf16(M, name):
    p_np = _tree_np(M, jnp.bfloat16, 6)
    jspec, tspec = _specs(M, name, "einsum")
    out = tgossip.mix_pytree(convert.params_from_jax(p_np, device="cpu"), tspec)
    jout = jgossip.mix_pytree(jax.tree.map(jnp.asarray, p_np), jspec)
    _assert_close(jout, out, 5e-2)
    assert {x.dtype for x in _tree.leaves(out)} == {torch.bfloat16}


def test_fused_and_einsum_backends_agree_in_float32():
    p = convert.params_from_jax(_tree_np(8, np.float32, 7), device="cpu")
    spec_f = tgossip.GossipSpec(topology=TT.make("ring", 8), backend="fused")
    spec_e = tgossip.GossipSpec(topology=TT.make("ring", 8), backend="einsum")
    for a, b in zip(_tree.leaves(tgossip.mix_pytree(p, spec_f)),
                    _tree.leaves(tgossip.mix_pytree(p, spec_e))):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    # without a mesh the mesh backends ('auto' → 'ppermute' here) mix with
    # the einsum oracle, as the reference's do
    for a, b in zip(_tree.leaves(tgossip.mix_pytree(p, tgossip.GossipSpec(
            topology=TT.make("ring", 8)))), _tree.leaves(tgossip.mix_pytree(p, spec_e))):
        assert torch.equal(a, b)
