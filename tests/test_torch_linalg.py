"""gpz_tpu_torch.linalg against gpz_tpu.linalg in float64 on the CPU, for
d in {1, 3, 5, 8}: the d-unrolled functions keep JAX's operation order, so
they agree to rounding."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu import linalg as jl
from gpz_tpu_torch import linalg as tl

DIMS = [1, 3, 5, 8]
TOL = dict(rtol=1e-12, atol=1e-13)


def spd(rng, batch, d):
    A = rng.standard_normal(batch + (d, d))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(d)


def both(fn_name, *arrays, **kw):
    """(torch result, jax result) of linalg.<fn_name>, as numpy tuples."""
    t = getattr(tl, fn_name)(*(torch.from_numpy(np.array(a)) for a in arrays),
                             **kw)
    j = getattr(jl, fn_name)(*map(jnp.asarray, arrays), **kw)
    t = t if isinstance(t, tuple) else (t,)
    j = j if isinstance(j, tuple) else (j,)
    return [np.asarray(a) for a in t], [np.asarray(a) for a in j]


def assert_same(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **(tol or TOL))


@pytest.mark.parametrize("d", DIMS)
def test_unrolled_cholesky_and_solve(d):
    rng = np.random.default_rng(d)
    A = spd(rng, (4, 6), d)
    b = rng.standard_normal((4, 6, d))
    assert_same(*both("unrolled_cholesky", A))
    L = np.linalg.cholesky(A)
    assert_same(*both("unrolled_solve_lower", L, b))


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("unroll_max", [8, 0], ids=["unrolled", "library"])
def test_inv_and_quad_logdet(d, unroll_max):
    rng = np.random.default_rng(10 + d)
    A = spd(rng, (5, 3), d)
    delta = rng.standard_normal((5, 3, d))
    assert_same(*both("unrolled_inv_psd", A, unroll_max=unroll_max))
    assert_same(*both("quad_logdet_psd", A, delta, unroll_max=unroll_max))


@pytest.mark.parametrize("d", DIMS)
def test_masked_psd(d):
    rng = np.random.default_rng(20 + d)
    A = spd(rng, (7,), d)
    mask = rng.random((7, d)) < 0.6
    assert_same(*both("masked_psd", A, mask), rtol=0, atol=0)


@pytest.mark.parametrize("d", DIMS)
def test_safe_cholesky_and_logdet(d):
    rng = np.random.default_rng(30 + d)
    A = spd(rng, (6,), d)
    got, want = both("safe_cholesky", A)
    assert_same(got, want)
    assert_same(*both("chol_logdet", want[0]))
    # slightly indefinite: the zero-jitter factor fails and both walk the
    # jitter ladder to the same level
    v = rng.standard_normal((2, d, 1)) * (d > 1)
    R = v @ np.swapaxes(v, -1, -2) - 1e-3 * np.eye(d)
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(R))).all()
    got, want = both("safe_cholesky", R)
    assert np.isfinite(got[0]).all()
    assert_same(got, want)


def test_safe_cholesky_all_levels_fail_gives_nan():
    A = -np.eye(3)[None].repeat(2, axis=0)
    got, want = both("safe_cholesky", A)
    lower = np.tril(np.ones((3, 3), bool))
    assert np.isnan(got[0][:, lower]).all() and (got[0][:, ~lower] == 0).all()
    assert_same(got, want, rtol=0, atol=0)


def test_non_pd_unrolled_gives_nan():
    A = np.array([[[1.0, 2.0], [2.0, 1.0]]])
    got, want = both("quad_logdet_psd", A, np.ones((1, 2)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert np.isnan(g).all()
