"""The port's compressed gossip lane against the JAX reference: wire rules,
``quantize_wire``/``dequantize_wire``, ``BusLayout.padded_bytes(wire)``,
the quant_pack kernel's plain version against the Pallas kernel (interpret
mode), and ``mix_bus_compressed`` over several rounds of error feedback.
The CUDA kernel is held against the plain version on the card in
tests/test_torch_gpu.py.

Tolerances: the quantizer is pinned bit for bit (values and scales, ties
included): both sides run the same float32 operations in the same order.
Mixed outputs and residuals: float32 atol 1e-5 (the gossip_mix kernel
tests' float32 tolerance); the ``None`` wire is bit-identical to the exact
mix.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import bus as jbus  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.core.gossip import GossipSpec as JSpec  # noqa: E402
from repro.kernels.quant_pack.kernel import quantize_pack_2d as jax_quantize_pack_2d  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch.core import bus as tbus  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.core.gossip import GossipSpec as TSpec  # noqa: E402
from repro_torch.kernels.quant_pack import (quantize_pack_2d,  # noqa: E402
                                            quantize_pack_reference)

BLK = dict(block_r=32)
F32_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return convert.params_to_numpy(x)
    return np.asarray(x)


def _bit_equal(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    assert np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8))


def _stacked_tree(M=4, seed=3):
    """The trees of tests/test_dci_compress.py (float32 (M,127) and
    (M,33,5)) from numpy, plus an int32 leaf that never quantizes."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(M, 127)).astype(np.float32),
            "b": rng.normal(size=(M, 33, 5)).astype(np.float32),
            "steps": rng.integers(-1000, 1000, size=(M, 300)).astype(np.int32)}


# ---------------------------------------------------------------------------
# Wire rules and the leaf quantizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,wire", [
    (np.float32, None), (np.float32, "bfloat16"), (np.float32, "int8"),
    (jnp.bfloat16, "bfloat16"), (jnp.bfloat16, "int8"),
    (np.int32, "int8"), (np.bool_, "bfloat16")])
def test_wire_dtype_rules_match_reference(dtype, wire):
    tdt = convert.params_from_jax(np.zeros(1, dtype), device="cpu").dtype
    want = jbus.wire_dtype_for(dtype, wire)
    got = tbus.wire_dtype_for(tdt, wire)
    assert (None if want is None else str(want)) == (
        None if got is None else str(got).removeprefix("torch."))
    if wire is not None:    # a torch dtype names the wire as well as a string
        assert tbus.wire_dtype_for(tdt, getattr(torch, wire)) == got


@pytest.mark.parametrize("bogus", ["int4", "float8_e4m3", "fp16", "e5m2"])
def test_unknown_wire_dtype_raises(bogus):
    with pytest.raises((ValueError, TypeError)):
        jbus.wire_dtype_for(jnp.float32, bogus)
    with pytest.raises(ValueError, match="wire dtype"):
        tbus.wire_dtype_for(torch.float32, bogus)
    with pytest.raises(ValueError, match="wire dtype"):
        tbus.quantize_wire(torch.zeros(3), bogus)


def test_quantize_wire_int8_matches_reference():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(6, 200)) *
         np.asarray([1e-3, 1.0, 50.0, 1e4, 1e-8, 0.0])[:, None]).astype(np.float32)
    jq, js = jbus.quantize_wire(jnp.asarray(x), "int8")
    tq, ts = tbus.quantize_wire(torch.from_numpy(x), "int8")
    _bit_equal(tq, jq)
    _bit_equal(ts, js)
    deq = tbus.dequantize_wire(tq, ts, torch.float32)
    _bit_equal(deq, jbus.dequantize_wire(jq, js, jnp.float32))
    assert np.all(np.abs(x - deq.numpy()) <= 0.5 * ts.numpy() * (1 + 1e-5) + 1e-30)
    assert ts[5, 0] == 1.0 and torch.equal(deq[5], torch.zeros(200))


def test_quantize_wire_bf16_is_a_cast():
    x = np.random.default_rng(1).normal(size=(33, 5)).astype(np.float32)
    jq, js = jbus.quantize_wire(jnp.asarray(x), "bfloat16")
    tq, ts = tbus.quantize_wire(torch.from_numpy(x), "bfloat16")
    assert js is None and ts is None and tq.dtype == torch.bfloat16
    _bit_equal(tq, jq)
    _bit_equal(tbus.dequantize_wire(tq, None, torch.float32),
               jbus.dequantize_wire(jq, None, jnp.float32))


def test_quantize_wire_scalar_path():
    jq, js = jbus.quantize_wire(jnp.asarray(2.5, jnp.float32), "int8")
    tq, ts = tbus.quantize_wire(torch.tensor(2.5), "int8")
    assert tq.shape == () and ts.shape == ()
    _bit_equal(tq, jq)
    _bit_equal(ts, js)
    _bit_equal(tbus.dequantize_wire(tq, ts, torch.float32),
               jbus.dequantize_wire(jq, js, jnp.float32))


# ---------------------------------------------------------------------------
# padded_bytes(wire)
# ---------------------------------------------------------------------------


def _layout_trees():
    rng = np.random.default_rng(2)
    return {
        "fp32": {"w": rng.normal(size=(70, 41)).astype(np.float32),
                 "b": rng.normal(size=(257,)).astype(np.float32)},
        "mixed": {"steps": np.arange(300, dtype=np.int32),
                  "acc": np.ones((64,), jnp.bfloat16),
                  "w": rng.normal(size=(9, 129)).astype(np.float32)},
    }


@pytest.mark.parametrize("tree", ["fp32", "mixed"])
@pytest.mark.parametrize("wire", [None, "bfloat16", "int8"])
def test_padded_bytes_wire_matches_reference(tree, wire):
    t = _layout_trees()[tree]
    jl = jbus.plan_layout(jax.tree.map(jnp.asarray, t), lead_ndim=0, **BLK)
    tl = tbus.plan_layout(convert.params_from_jax(t, device="cpu"), lead_ndim=0, **BLK)
    assert tl.padded_bytes(wire) == jl.padded_bytes(wire)
    if tree == "fp32" and wire == "int8":
        assert tl.padded_bytes() / tl.padded_bytes(wire) >= 3.5


# ---------------------------------------------------------------------------
# quant_pack: plain version against the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------


def _quant_input(kind, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":      # rows of very different magnitudes
        x = rng.normal(size=(64, 128)) * rng.uniform(1e-3, 1e3, size=(64, 1))
    elif kind == "odd_cols":
        x = rng.normal(size=(24, 129))
    elif kind == "zeros_and_negative":
        x = -np.abs(rng.normal(size=(32, 128)))
        x[3] = 0.0
        x[17] = 0.0
    else:                     # exact half-way ties: amax 127 ⇒ scale ≈ 1
        x = np.tile(np.arange(-64, 64) + 0.5, (32, 1))
        x[:, 0] = 127.0
        x[1::2] *= -1
    return x.astype(dtype)


@pytest.mark.parametrize("kind", ["random", "odd_cols", "zeros_and_negative", "ties"])
@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_plain_quant_pack_matches_jax_kernel(kind, dtype):
    x = _quant_input(kind, dtype)
    launches = quantize_pack_2d.launches
    tv, ts = quantize_pack_2d(convert.params_from_jax(x, device="cpu"), **BLK)
    assert quantize_pack_2d.launches == launches      # CPU tensors: plain version
    jv, js = jax_quantize_pack_2d(jnp.asarray(x), interpret=True, **BLK)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32 and ts.shape == (x.shape[0], 1)
    _bit_equal(tv, jv)
    _bit_equal(ts, js)
    xf = np.asarray(x, np.float32)
    assert np.all(np.abs(xf - tv.numpy() * ts.numpy()) <= 0.5 * ts.numpy() * (1 + 1e-5))


def test_ties_round_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]])
    v, s = quantize_pack_reference(x)
    # 127 · fl32(1/127) rounds to exactly 1.0, so x / scale = x
    assert s.item() == 1.0
    assert v.tolist() == [[127, 0, 2, 2, 0, -2, -2, 4]]


def test_wrapper_checks_its_arguments():
    with pytest.raises(ValueError, match="block_r"):
        quantize_pack_2d(torch.zeros(48, 128), block_r=32)
    with pytest.raises(ValueError, match="buffer"):
        quantize_pack_2d(torch.zeros(4, 8, 2))
    with pytest.raises(ValueError, match="buffer"):
        quantize_pack_2d(torch.zeros(4, 0))


# ---------------------------------------------------------------------------
# mix_bus_compressed against the reference, residuals carried
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("wire", ["bfloat16", "int8"])
def test_mix_bus_compressed_matches_reference_over_rounds(wire):
    M, rounds = 4, 5
    t = _stacked_tree(M)
    jspec = JSpec(topology=JT.undirected_ring(M), backend="fused")
    tspec = TSpec(topology=TT.undirected_ring(M), backend="fused")
    jx, jres = jax.tree.map(jnp.asarray, t), None
    tx, tres = convert.params_from_jax(t, device="cpu"), None
    for r in range(rounds):
        jx, jres = jbus.mix_bus_compressed(jx, jspec, None, wire_dtype=wire,
                                           residual=jres, interpret=True, **BLK)
        tx, tres = tbus.mix_bus_compressed(tx, tspec, wire_dtype=wire,
                                           residual=tres, **BLK)
        for a, b in zip(jax.tree.leaves(jx), _tree.leaves(tx)):
            assert _np(b).dtype == np.asarray(a).dtype
            np.testing.assert_allclose(_np(b), np.asarray(a), atol=F32_TOL, rtol=0,
                                       err_msg=f"round {r}")
        assert len(tres) == len(jres)
        for a, b in zip(jres, tres):
            assert (a is None) == (b is None)       # the int32 group stays exact
            if a is not None:
                np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=F32_TOL,
                                           rtol=0, err_msg=f"residual, round {r}")
    np.testing.assert_array_equal(_np(tx["steps"]), np.asarray(jx["steps"]))


def test_mix_bus_compressed_none_wire_is_exact_mix():
    t = convert.params_from_jax(_stacked_tree(), device="cpu")
    spec = TSpec(topology=TT.undirected_ring(4), backend="fused")
    got, res = tbus.mix_bus_compressed(t, spec, wire_dtype=None, **BLK)
    for a, b in zip(_tree.leaves(got), _tree.leaves(tbus.mix_bus(t, spec, **BLK))):
        _bit_equal(a, b)
    assert res is None
    sentinel = ["opaque"]
    assert tbus.mix_bus_compressed(t, spec, wire_dtype=None, residual=sentinel,
                                   **BLK)[1] is sentinel
    with pytest.raises(ValueError, match="residual"):
        tbus.mix_bus_compressed(t, spec, wire_dtype="int8", residual=[None], **BLK)
    one = {"w": torch.ones(1, 5)}
    assert tbus.mix_bus_compressed(one, TSpec(topology=TT.clique(1), backend="fused"),
                                   wire_dtype="int8")[0] is one
