"""The port's Adam, Adafactor and learning-rate schedules against the JAX
reference.

The reference computes its schedules and Adam's bias corrections
(``1 − b**t`` with ``t = float32(step) + 1``) and Adafactor's
``b2 = 1 − t^(−decay)`` in float32 on the device; the port computes them on
the host in ``np.float32``. ``np.cos``/``np.power`` and XLA's may differ by
one float32 ulp, so schedules are held to one float32 ulp, float32 moments
to rtol 1e-6 (Adam, elementwise: the same operations in the same order) or
1e-5 (Adafactor, whose row/column means sum in different orders), and bf16
updates are equal or one bf16 ulp apart (the ulp shows up where the float32
update lies near a bf16 rounding boundary; all but a few elements are
equal).
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro_torch import _tree, convert  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402

STEPS = 5


def _ulps_f32(a, b) -> np.ndarray:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("make", [
    lambda m: m.constant(0.3),
    lambda m: m.cosine(0.1, 7),
    lambda m: m.cosine(3e-4, 1000, final_frac=0.0),
    lambda m: m.warmup_cosine(0.01, 2, 5),
    lambda m: m.warmup_cosine(1e-4, 1, 2),
    lambda m: m.warmup_cosine(0.05, 10, 100, final_frac=0.2),
    lambda m: m.warmup_cosine(0.05, 0, 3),
], ids=["constant", "cosine", "cosine0", "wc-2-5", "wc-1-2", "wc-10-100", "wc-0-3"])
def test_schedules_within_one_float32_ulp(make):
    """Against the reference's schedule called as is: one float32 ulp. Under
    jit, XLA fuses the schedule and computes the cosine another way (5 ulps
    apart at ``cosine(0.1, 7)``, step 6, where ``1 + cos`` cancels); that is
    held to 4 float32 epsilons of the peak rate."""
    jsched, tsched = make(joptim), make(toptim)
    jitted = jax.jit(jsched)
    steps = list(range(12)) + [50, 99, 100, 101, 999, 1000, 1200]
    peak = max(tsched(s) for s in steps)
    for step in steps:
        got = tsched(step)
        assert isinstance(got, float) and got == float(np.float32(got))
        want = jsched(jnp.asarray(step, jnp.int32))
        assert _ulps_f32(got, want) <= 1, (step, got, float(want))
        fused = float(jitted(jnp.asarray(step, jnp.int32)))
        assert abs(got - fused) <= 4 * float(np.finfo(np.float32).eps) * peak, \
            (step, got, fused)


def _trees(rng, shapes, dtype):
    p = {f"p{i}": rng.normal(size=s) for i, s in enumerate(shapes)}
    jtree = jax.tree.map(lambda x: jnp.asarray(x, dtype), p)
    return jtree, convert.params_from_jax(jtree, device="cpu")


def _check_bf16_or_f32(want, got, rtol, what):
    for a, b in zip(jax.tree.leaves(want), _tree.leaves(got), strict=True):
        a = np.asarray(a)
        b = convert.params_to_numpy(b)
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if a.dtype == np.float32:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-30, err_msg=what)
        else:   # bf16: equal or one bf16 ulp apart
            d = np.abs(a.view(np.uint16).astype(np.int32) - b.view(np.uint16).astype(np.int32))
            assert d.max() <= 1, (what, d.max())
            assert (d == 0).mean() > 0.95, (what, (d == 0).mean())


def _run(jopt, topt, rng, shapes, dtype, rtol):
    jp, tp = _trees(rng, shapes, dtype)
    js, ts = jopt.init(jp), topt.init(tp)
    _check_bf16_or_f32(js, ts, 0, "init")
    for k in range(STEPS):
        jg, tg = _trees(rng, shapes, dtype)
        ju, js = jopt.update(jg, js, jp, jnp.asarray(k, jnp.int32))
        tu, ts2 = topt.update(tg, ts, tp, k)
        _check_bf16_or_f32(ju, tu, rtol, f"updates at step {k}")
        _check_bf16_or_f32(js, ts2, rtol, f"state at step {k}")
        ts = ts2


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adam_matches_reference(dtype, wd, rng):
    sched = lambda m: m.warmup_cosine(1e-3, 2, STEPS)
    _run(joptim.adam(sched(joptim), weight_decay=wd),
         toptim.adam(sched(toptim), weight_decay=wd),
         rng, [(33,), (4, 16, 9), (7, 5)], dtype, 1e-6)


def test_adam_does_not_update_state_in_place(rng):
    """Stepping twice from one state gives the same result."""
    _, tp = _trees(rng, [(3, 8)], jnp.float32)
    _, tg = _trees(rng, [(3, 8)], jnp.float32)
    opt = toptim.adam(1e-3)
    s0 = opt.init(tp)
    u1, s1 = opt.update(tg, s0, tp, 0)
    u2, s2 = opt.update(tg, s0, tp, 0)
    assert all(torch.equal(a, b) for a, b in zip(_tree.leaves((u1, s1)), _tree.leaves((u2, s2))))
    assert all(not x.any() for x in _tree.leaves(s0))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("shapes", [
    [(40,)],                         # 1-D: unfactored
    [(12, 20)],                      # 2-D: row/column factored
    [(4, 12, 20), (4, 40)],          # worker-stacked: a 1-D param arrives 2-D
], ids=["1d", "2d", "stacked"])
def test_adafactor_matches_reference(dtype, shapes, rng):
    _run(joptim.adafactor_like(1e-2), toptim.adafactor_like(1e-2), rng, shapes,
         dtype, 1e-5)


def test_adafactor_state_structure():
    p = {"w": torch.zeros(4, 3, 5), "b": torch.zeros(7)}
    s = toptim.adafactor_like(1e-2).init(p)
    assert set(s["w"]) == {"row", "col"} and set(s["b"]) == {"v"}
    assert s["w"]["row"].shape == (4, 3) and s["w"]["col"].shape == (4, 5)


def _one_step_losses():
    """The same one-step loss on each side: one sgd step on a least-squares
    problem from a common start, then the loss."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(64, 6)).astype(np.float32)
    y = (X @ rng.normal(size=6) + 0.1 * rng.normal(size=64)).astype(np.float32)
    w0 = np.zeros(6, np.float32)

    def jax_loss(lr):
        f = lambda w: jnp.mean((jnp.asarray(X) @ w - jnp.asarray(y)) ** 2)
        w = jnp.asarray(w0) - lr * jax.grad(f)(jnp.asarray(w0))
        return float(f(w))

    def torch_loss(lr):
        Xt, yt = torch.from_numpy(X), torch.from_numpy(y)
        w = torch.from_numpy(w0).requires_grad_()
        loss = torch.mean((Xt @ w - yt) ** 2)
        (g,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            return float(torch.mean((Xt @ (w - lr * g) - yt) ** 2))

    return jax_loss, torch_loss


def test_smith_lr_range_test_matches_reference():
    jax_loss, torch_loss = _one_step_losses()
    want = joptim.smith_lr_range_test(jax_loss)
    same = toptim.smith_lr_range_test(jax_loss)         # the same loss: equal
    assert same[0] == want[0]
    np.testing.assert_array_equal(same[1], want[1])
    np.testing.assert_array_equal(same[2], want[2])
    got = toptim.smith_lr_range_test(torch_loss)        # the port's loss: close
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert got[0] == want[0]
    flat = toptim.smith_lr_range_test(lambda lr: 1.0, n_points=5)
    assert flat[0] == joptim.smith_lr_range_test(lambda lr: 1.0, n_points=5)[0]
