"""gpz_tpu_torch.linalg against gpz_tpu.linalg in float64 on the CPU, for
d in {1, 3, 5, 8}: the d-unrolled functions keep JAX's operation order, so
they agree to rounding."""

import numpy as np
import jax
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


# the (m x m) solve of the objective: values and gradients of two float64
# Cholesky solves whose libraries differ (LAPACK through XLA and PyTorch)
SOLVE = dict(rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("k,m", [(1, 6), (2, 9), (3, 1)])
def test_solves_against_jax(k, m):
    rng = np.random.default_rng(40 + m)
    SIGMA = spd(rng, (k,), m)
    rhs = rng.standard_normal((m, k))
    B = rng.standard_normal((k, m, 4))
    L = np.linalg.cholesky(SIGMA)
    assert_same(*both("chol_solve", L, B), **SOLVE)
    assert_same(*both("solve_psd", SIGMA, B), **SOLVE)
    assert_same(*both("solve_w_logdet", SIGMA, rhs), **SOLVE)


@pytest.mark.parametrize("k,m", [(1, 6), (2, 9)])
def test_solve_w_logdet_gradient_against_jax(k, m):
    """Native autograd through cholesky_ex / solve_triangular against
    gpz_tpu's hand-written cotangents, for a cotangent in w and in logdet.
    SIGMA enters symmetrized, so both sides see a symmetric perturbation."""
    rng = np.random.default_rng(50 + m)
    SIGMA = spd(rng, (k,), m)
    rhs = rng.standard_normal((m, k))
    cw = rng.standard_normal((m, k))
    cl = rng.standard_normal(k)

    def jloss(S, r):
        w, ld = jl.solve_w_logdet(0.5 * (S + jnp.swapaxes(S, -1, -2)), r)
        return jnp.sum(w * cw) + jnp.sum(ld * cl)

    S = torch.from_numpy(SIGMA).requires_grad_(True)
    r = torch.from_numpy(rhs).requires_grad_(True)
    w, ld = tl.solve_w_logdet(0.5 * (S + S.transpose(-1, -2)), r)
    loss = (w * torch.from_numpy(cw)).sum() + (ld * torch.from_numpy(cl)).sum()
    gS, gr = torch.autograd.grad(loss, (S, r))
    jS, jr = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(SIGMA),
                                             jnp.asarray(rhs))
    np.testing.assert_allclose(gS.numpy(), np.asarray(jS), **SOLVE)
    np.testing.assert_allclose(gr.numpy(), np.asarray(jr), **SOLVE)


def test_safe_cholesky_is_differentiable_at_its_jitter():
    """A slightly indefinite matrix is factored at the first jitter level
    that works, and the gradient flows through that factorization."""
    rng = np.random.default_rng(60)
    v = rng.standard_normal((4, 1))
    R = torch.from_numpy(v @ v.T - 1e-9 * np.eye(4)).requires_grad_(True)
    L = tl.safe_cholesky(R[None])[0]
    assert torch.isfinite(L).all()
    g, = torch.autograd.grad(tl.chol_logdet(L), R)
    assert torch.isfinite(g).all() and g.abs().max() > 0
