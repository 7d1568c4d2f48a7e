"""The port's copy of the paper's analysis (``core/analysis.py``) and of the
replicated and by-label partitions, against the JAX package's.

Both sides are numpy: the bounds, moments, horizons and constants must agree
at rtol 1e-12, and the partitions (seeded ``default_rng``) bit for bit.
"""
import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import analysis as JA  # noqa: E402
from repro.core import topology as JT  # noqa: E402
from repro.data import partition as JP  # noqa: E402
from repro_torch.core import analysis as TA  # noqa: E402
from repro_torch.core import topology as TT  # noqa: E402
from repro_torch.data import partition as TP  # noqa: E402

TOL = 1e-12


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=TOL, atol=0)


def test_analysis_imports_only_the_port():
    import inspect

    src = inspect.getsource(TA)
    assert "from repro." not in src and "import repro." not in src


@pytest.mark.parametrize("lam2", [0.0, 0.3, 0.97, 1.0 - 1e-13])
def test_bounds_match_reference(lam2):
    K = np.arange(1, 301, dtype=np.float64)
    kw = dict(M=8, eta=0.05, dist0=1.7, E=12.0, E_sp=5.0, H=2.2, R_sp=0.4,
              alpha=0.6, lam2=lam2)
    for name in ("bound_new", "bound_local"):
        _close(getattr(TA, name)(K, **kw), getattr(JA, name)(K, **kw))
    kw_old = dict(M=8, eta=0.05, dist0=1.7, E=12.0, R=0.9, lam2=lam2)
    _close(TA.bound_old(K, **kw_old), JA.bound_old(K, **kw_old))
    kw_fb = dict(M=8, eta=0.05, dist0=1.7, L=1.3, R=0.9, lam2=lam2)
    _close(TA.bound_full_batch(K, **kw_fb), JA.bound_full_batch(K, **kw_fb))
    _close(TA._lam_series(lam2, K), JA._lam_series(lam2, K))
    _close(TA.toy_example_objective(K, lam2=lam2, eta=0.1, zeta=0.5),
           JA.toy_example_objective(K, lam2=lam2, eta=0.1, zeta=0.5))


def test_constants_and_moments_match_reference(rng):
    M = 8
    samples = [rng.normal(size=(6, M)) + 0.3 for _ in range(5)]
    grads = [rng.normal(size=(3, 2)) for _ in range(M)]
    _close(TA.gradient_matrix(grads), JA.gradient_matrix(grads))
    for jt, tt in [(JT.undirected_ring(M), TT.undirected_ring(M)),
                   (JT.clique(M), TT.clique(M)), (JT.hypercube(3), TT.hypercube(3))]:
        a, b = TA.estimate_constants(samples, tt), JA.estimate_constants(samples, jt)
        for f in ("E", "E_sp", "H", "alpha", "beta", "ratio_E_Esp", "ratio_E_H"):
            _close(getattr(a, f), getattr(b, f))
        assert a.M == b.M == M
    for C in (1, 2, 4):
        kw = dict(M=4, S=48, B=4, C=C, grad_norm2=1.3, sigma2=2.1, alpha=0.7)
        a, b = TA.prop33_moments(**kw), JA.prop33_moments(**kw)
        for f in ("E", "E_sp", "H", "alpha", "beta_hat"):
            _close(getattr(a, f), getattr(b, f))
    pts = rng.normal(size=(24, 5)) + 0.5
    for C in (1, 2):
        a = TA.monte_carlo_moments(pts, M=4, B=3, C=C, n_perm=4, n_batch=3, seed=2)
        b = JA.monte_carlo_moments(pts, M=4, B=3, C=C, n_perm=4, n_batch=3, seed=2)
        for f in ("E", "E_sp", "H"):
            assert getattr(a, f) == getattr(b, f)
    with pytest.raises(ValueError):
        TA.prop33_moments(M=4, S=48, B=4, C=5, grad_norm2=1.0, sigma2=1.0)


def test_divergence_iteration_and_horizons_match_reference():
    K = np.arange(1, 201, dtype=np.float64)
    loss = 1.0 / np.sqrt(K) + 0.05
    kw = dict(M=8, eta=0.05, dist0=1.0, E=4.0, R=0.5)
    for pct in (0.01, 0.05, 0.5):
        for K_max in (None, 50):
            got = TA.predicted_divergence_iteration(
                lambda k, l2: TA.bound_old(k, lam2=l2, **kw), lam2_sparse=0.95,
                lam2_dense=0.1, loss_curve_dense=loss, pct=pct, K_max=K_max)
            want = JA.predicted_divergence_iteration(
                lambda k, l2: JA.bound_old(k, lam2=l2, **kw), lam2_sparse=0.95,
                lam2_dense=0.1, loss_curve_dense=loss, pct=pct, K_max=K_max)
            assert got == want
    for lam2 in (0.5, 0.9):
        _close(TA.lian_horizon(L=1.2, M=16, sigma2=0.8, f0=2.0, lam2=lam2),
               JA.lian_horizon(L=1.2, M=16, sigma2=0.8, f0=2.0, lam2=lam2))
        _close(TA.pu_horizon(L=1.2, M=16, mu=0.3, lam2=lam2),
               JA.pu_horizon(L=1.2, M=16, mu=0.3, lam2=lam2))


@pytest.mark.parametrize("n,M,C,seed", [(48, 4, 1, 0), (48, 4, 2, 3), (30, 6, 3, 1),
                                        (20, 4, 4, 0), (64, 8, 2, 7)])
def test_replicated_split_bit_equal(n, M, C, seed):
    got, want = TP.replicated_split(n, M, C, seed), JP.replicated_split(n, M, C, seed)
    assert len(got) == len(want) == M
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        TP.replicated_split(10, 4, 1)


def test_split_by_label_bit_equal(rng):
    labels = rng.integers(0, 10, size=200)
    for M, seed in [(4, 0), (10, 3), (3, 1)]:
        got, want = TP.split_by_label(labels, M, seed), JP.split_by_label(labels, M, seed)
        assert len(got) == len(want) == M
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
