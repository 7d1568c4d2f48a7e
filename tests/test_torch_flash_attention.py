"""The port's flash-attention plain version and CPU wrapper against the JAX
reference, on the same numpy inputs.

JAX's side runs as its own tests run it: ``attention_reference`` plain and
the Pallas ``ops.attention`` in interpret mode, on the reference's five
``FLASH_CASES`` (``tests/test_kernels.py``). Tolerances are the reference's
kernel-test ones: atol 2e-5 for float32, 3e-2 for bf16 (the two sides sum
the products in different orders; bf16 outputs round once more). On the CPU
the wrapper runs the plain version and launches nothing.
"""
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
