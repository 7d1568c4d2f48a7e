"""The port's flash-attention plain version and CPU wrapper against the JAX
reference, on the same numpy inputs.

JAX's side runs as its own tests run it: ``attention_reference`` plain and
the Pallas ``ops.attention`` in interpret mode, on the reference's five
``FLASH_CASES`` (``tests/test_kernels.py``). Tolerances are the reference's
kernel-test ones: atol 2e-5 for float32, 3e-2 for bf16 (the two sides sum
the products in different orders; bf16 outputs round once more). On the CPU
the wrapper runs the plain version and launches nothing.

The CUDA bf16 kernel cannot run here, so its arithmetic is emulated: the
tile loop of ``csrc/flash_attention_bf16.cuh`` (128-row q tiles, 128-row kv
tiles, 64-row at head dims 192 and 256, the kv tiles each q tile visits, exp2 with the scale folded in, P split into
bf16 hi and lo terms for P·V) in float32 on bf16 values, held to the JAX
reference at 3e-2 and, element by element, to one bf16 ulp of the reference
plus 1e-4 (the card check's bound).
"""
import math

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import attention as jflash_op  # noqa: E402
from repro.kernels.flash_attention.ref import attention_reference as jattention_reference  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels.flash_attention import (attention_reference,  # noqa: E402
                                                 flash_attention)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.models.attention import blockwise_attention  # noqa: E402

FLASH_CASES = [
    # (B, Lq, Lkv, H, Hkv, hd, causal, window)
    (2, 128, 128, 4, 2, 64, True, None),
    (1, 256, 256, 8, 1, 32, True, 64),     # MQA + sliding window
    (2, 128, 128, 4, 4, 64, False, None),  # encoder (bidirectional)
    (1, 64, 64, 2, 2, 128, True, None),
    (1, 128, 128, 4, 2, 16, True, 32),
]
# rows past Lkv + window - 1 have no key in their mask: both references give
# the softmax of an all-NEG_INF row, the mean of v (the Pallas kernel's value
# there depends on its block sizes, so it is not compared on these)
KEYLESS_CASES = [
    (1, 150, 70, 4, 2, 32, True, 5),
    (1, 200, 130, 2, 1, 64, False, 40),
]
TOL = {"float32": 2e-5, "bfloat16": 3e-2}
# a longer GQA prompt: several 128-row q tiles and kv tiles, a ragged edge
LONG_GQA_CASE = (1, 1100, 1100, 8, 2, 64, True, None)
# head dims 192 and 256 (nemotron, gemma): GQA, MQA, a window, Lq != Lkv
WIDE_CASES = [
    (1, 300, 300, 4, 1, 256, True, None),
    (1, 260, 200, 4, 2, 192, True, 70),
    (1, 130, 190, 2, 2, 256, False, None),
]
KERNEL_BQ = 128                       # csrc/flash_attention_bf16.cuh: BQ, Tile::BKV


def _kernel_bkv(hd):
    return 64 if hd > 128 else 128
NEG_INF = -1e30


def _inputs(case, dtype, seed=0):
    """q, k, v in the model's (B, L, H, hd) layout: numpy (in ``dtype``) and
    the same values as CPU tensors."""
    B, Lq, Lkv, H, Hkv, hd, _, _ = case
    rng = np.random.default_rng(seed)
    arrs = [np.asarray(jnp.asarray(rng.normal(size=s).astype(np.float32), dtype))
            for s in ((B, Lq, H, hd), (B, Lkv, Hkv, hd), (B, Lkv, Hkv, hd))]
    return arrs, [convert.params_from_jax(a, device="cpu") for a in arrs]


def _bhld(x):
    return x.transpose(1, 2)


@pytest.mark.parametrize("case", FLASH_CASES + KEYLESS_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_and_wrapper_match_jax_reference(case, dtype):
    causal, window = case[6], case[7]
    (qn, kn, vn), (q, k, v) = _inputs(case, dtype)
    want = np.asarray(jattention_reference(
        jnp.asarray(qn).transpose(0, 2, 1, 3), jnp.asarray(kn).transpose(0, 2, 1, 3),
        jnp.asarray(vn).transpose(0, 2, 1, 3), causal=causal, window=window), np.float32)
    plain = attention_reference(_bhld(q), _bhld(k), _bhld(v), causal=causal, window=window)
    before = flash_attention.launches
    wrapped = flash_attention(_bhld(q), _bhld(k), _bhld(v), causal=causal, window=window)
    assert flash_attention.launches == before           # the CPU launches nothing
    for got in (plain, wrapped):
        assert got.dtype == getattr(torch, dtype) and got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_attention_matches_pallas_kernel(case, dtype):
    """The (B, L, H, hd) op against the Pallas kernel in interpret mode."""
    causal, window = case[6], case[7]
    (qn, kn, vn), (q, k, v) = _inputs(case, dtype, seed=1)
    want = np.asarray(jflash_op(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                causal=causal, window=window, block_q=64, block_kv=64),
                      np.float32)
    got = flash_ops.attention(q, k, v, causal=causal, window=window)
    assert got.shape == want.shape and got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("case", [c for c in FLASH_CASES if c[6]])
def test_ops_attention_matches_blockwise_twin(case):
    """The kernel's plain route and the port's blockwise attention (the
    training path) compute the same function."""
    window = case[7]
    _, (q, k, v) = _inputs(case, "float32", seed=2)
    a = flash_ops.attention(q, k, v, causal=True, window=window)
    b = blockwise_attention(q, k, v, 0, causal=True, window=window, q_chunk=64, kv_chunk=64)
    torch.testing.assert_close(a, b, atol=2e-5, rtol=0)


def test_backward_raises_rather_than_dropping_gradients():
    _, (q, k, v) = _inputs(FLASH_CASES[0], "float32")
    q.requires_grad_()
    out = flash_ops.attention(q, k, v)
    assert out.grad_fn is not None
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        out.sum().backward()


def test_wrapper_validates_before_choosing_a_device():
    _, (q, k, v) = _inputs(FLASH_CASES[0], "float32")
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(_bhld(q)[:, :3], _bhld(k), _bhld(v))
    with pytest.raises(ValueError, match="do not fit"):
        flash_attention(_bhld(q), _bhld(k)[..., :32], _bhld(v)[..., :32])
    with pytest.raises(ValueError, match="window"):
        flash_attention(_bhld(q), _bhld(k), _bhld(v), window=0)


def _emulate_bf16_kernel(q, k, v, *, causal, window, scale, split_p=True):
    """The bf16 CUDA kernel's tile loop on (B, H, L, hd) bf16 tensors, in
    float32: exact bf16 products summed in float32, as the tensor cores do.
    ``split_p=False`` rounds P once to bf16 instead of splitting it."""
    B, H, Lq, hd = q.shape
    Hkv, Lkv = k.shape[1], k.shape[2]
    c = torch.tensor(scale, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                dtype=torch.float32)
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    out = torch.empty_like(q)
    bkv = _kernel_bkv(hd)
    n_kv = -(-Lkv // bkv)
    for q0 in range(0, Lq, KERNEL_BQ):
        q_last = min(q0 + KERNEL_BQ, Lq) - 1
        keyless = window is not None and q_last >= Lkv + window - 1
        hi = min(q_last // bkv + 1, n_kv) if causal and not keyless else n_kv
        lo = max(q0 - window + 1, 0) // bkv if window and not keyless else 0
        rows = torch.arange(q0, q_last + 1)[:, None]
        qt = q[:, :, q0:q_last + 1].float()
        m = torch.full(qt.shape[:3], NEG_INF)
        l = torch.zeros(qt.shape[:3])
        acc = torch.zeros(qt.shape)
        for kt in range(lo, hi):
            k0, k1 = kt * bkv, min((kt + 1) * bkv, Lkv)   # keys past Lkv: p = 0
            keys = torch.arange(k0, k1)[None, :]
            ok = torch.ones(rows.shape[0], k1 - k0, dtype=torch.bool)
            if causal:
                ok &= keys <= rows
            if window is not None:
                ok &= keys > rows - window
            x = torch.where(ok, (qt @ kf[:, :, k0:k1].transpose(-1, -2)) * c, NEG_INF)
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            p_hi = p.to(torch.bfloat16).float()
            pv = p_hi @ vf[:, :, k0:k1]
            if split_p:
                pv = pv + (p - p_hi).to(torch.bfloat16).float() @ vf[:, :, k0:k1]
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, q0:q_last + 1] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
    return out


def _ulp_excess(got, want):
    """Largest amount by which |got - want| exceeds one bf16 ulp of want
    (2^-7·|want|) plus 1e-4; > 0 fails the card check's bound."""
    return (np.abs(got - want) - 2.0 ** -7 * np.abs(want) - 1e-4).max()


def _jax_reference_bf16(case, seed):
    causal, window = case[6], case[7]
    (qn, kn, vn), (q, k, v) = _inputs(case, "bfloat16", seed=seed)
    want = np.asarray(jattention_reference(
        jnp.asarray(qn).transpose(0, 2, 1, 3), jnp.asarray(kn).transpose(0, 2, 1, 3),
        jnp.asarray(vn).transpose(0, 2, 1, 3), causal=causal, window=window), np.float32)
    return want, (_bhld(q), _bhld(k), _bhld(v))


@pytest.mark.parametrize("case", FLASH_CASES + KEYLESS_CASES + [LONG_GQA_CASE] + WIDE_CASES)
def test_bf16_kernel_arithmetic_matches_jax_reference(case):
    """The wgmma kernel's numerical design, emulated, within the reference's
    3e-2 and within one bf16 ulp + 1e-4 of it element by element."""
    causal, window, hd = case[6], case[7], case[5]
    want, (q, k, v) = _jax_reference_bf16(case, seed=3)
    got = _emulate_bf16_kernel(q, k, v, causal=causal, window=window, scale=1.0 / np.sqrt(hd))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=0)
    assert _ulp_excess(got, want) <= 0


def test_one_bf16_rounding_of_p_breaks_the_ulp_bound():
    """Why the kernel splits P: rounded once to bf16 before P·V, as FA2 and
    FA3 do, P puts outputs of the long GQA case more than one bf16 ulp off
    the reference, though within its 3e-2."""
    want, (q, k, v) = _jax_reference_bf16(LONG_GQA_CASE, seed=3)
    got = _emulate_bf16_kernel(q, k, v, causal=True, window=None, scale=1.0 / 8.0,
                               split_p=False).float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL["bfloat16"], rtol=0)
    assert _ulp_excess(got, want) > 0
