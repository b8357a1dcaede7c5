"""gpz_tpu_torch.optim.minimize_batched against minimize of each lane alone,
bit for bit, and against jax.vmap(gpz_tpu.optim.minimize), in float64 on
the CPU.

The lanes are starts of one row-wise objective with explicit gradients,
written once for numpy-like namespaces (torch, jax.numpy). The last
coordinate of a lane is a label whose gradient is zero, so it never moves
and picks the lane's problem:

  0  Rosenbrock in (x0, x1) from (-1.2, 1): progress below prog_tol
  1  Rosenbrock scaled by 1.5: max|g| below opt_tol, six iterations later
  2  a 4-D quadratic scored by -(x0 - 1/2)^2, whose path passes x0 = 1/2:
     early stop after max_attempts non-improving iterations
  3  a first step whose curvature pair has y'y = inf and s'g = 0: the
     next quasi-Newton direction is -0, not a descent direction, so the
     second iteration falls back to steepest descent (step 1 / sum|g|)
  4  a non-finite objective at the start: line search failed at once

The two packages agree on every lane's iterations, evaluations and status,
and on x and x_best within 1e-12 (measured 9e-16 at most).
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.optim import minimize as jminimize

from gpz_tpu_torch.optim import lbfgs, minimize, minimize_batched

A, B = 0.7e154, 1.2e154          # B^2 + A^2 overflows, B^2 does not
C = np.array([1.0, 4.0, 16.0, 64.0])
X0 = np.array([[-1.2, 1.0, 0.0, 0.0, 0.0],
               [-1.0, 1.2, 0.0, 0.0, 1.0],
               [-2.0, 3.0, -1.0, 2.0, 2.0],
               [0.0, 0.0, 0.0, 0.0, 3.0],
               [60.0, 0.0, 0.0, 0.0, 4.0]])
STATUSES = [lbfgs.STATUS_STEP_TOO_SMALL, lbfgs.STATUS_OPTIMAL,
            lbfgs.STATUS_EARLY_STOP, lbfgs.STATUS_OPTIMAL,
            lbfgs.STATUS_LS_FAILED]
OPTS = dict(max_iter=200, max_attempts=3)
X_TOL = dict(rtol=0.0, atol=1e-12)


def rows(xp, X):
    """(f, g) of the lanes X (..., 5), row by row."""
    x, lab = X[..., :4], X[..., 4]
    x0, x1 = x[..., 0], x[..., 1]
    zero = 0.0 * x0
    s = xp.where(lab == 1, 1.5, 1.0)
    u, v = s * x0, s * x1
    f_rosen = 100.0 * (v - u * u) ** 2 + (1.0 - u) ** 2
    g_rosen = [s * (-400.0 * u * (v - u * u) - 2.0 * (1.0 - u)),
               s * (200.0 * (v - u * u)), zero, zero]
    c = xp.asarray(C)
    f_quad = 0.5 * (c * (x - 1.0) ** 2).sum(-1)
    g_quad = [c[i] * (x[..., i] - 1.0) for i in range(4)]
    # lane 3: linear in x1 where it starts, then a plateau of gradient
    # (B, 0) where the first step lands, then a bowl
    start = (x1 < 0.5) & (x0 > -0.5)
    land = (x1 >= 0.5) & (x0 > -0.5)
    f_fall = xp.where(start, -A * x1, xp.where(
        land, -1e150 + B * x0,
        -3e150 + 0.5 * ((x0 + 2.0) ** 2 + (x1 - 1.0) ** 2)))
    g_fall = [xp.where(start, zero, xp.where(land, B + zero, x0 + 2.0)),
              xp.where(start, -A + zero, xp.where(land, zero, x1 - 1.0)),
              zero, zero]
    f = xp.where(lab == 2, f_quad, xp.where(lab == 3, f_fall, xp.where(
        (lab == 4) & (x0 > 50.0), np.nan, f_rosen)))
    g = [xp.where(lab == 2, q, xp.where(lab == 3, h, r))
         for q, h, r in zip(g_quad, g_fall, g_rosen)]
    return f, xp.stack(g + [zero], axis=-1)


def score_rows(xp, X):
    f, _ = rows(xp, X)
    return xp.where(X[..., 4] == 2, -(X[..., 0] - 0.5) ** 2, -f)


def port_fun(x):
    f, g = rows(torch, x)
    return f, g, ()


def port_score(x, aux):
    s = score_rows(torch, x)
    return s, {"score_copy": s}


def jax_fun(x):
    f, g = rows(jnp, x)
    return f, g, ()


def jax_score(x, aux):
    s = score_rows(jnp, x)
    return s, {"score_copy": s}


def assert_same(got, want):
    """Every field and trace of two MinimizeResults, bit for bit."""
    for key in ("x", "x_best"):
        assert torch.equal(getattr(got, key), getattr(want, key)), key
    for key in ("f", "best_score"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    assert (got.iterations, got.fun_evals, got.status) == (
        want.iterations, want.fun_evals, want.status)
    for key in ("f", "opt_cond", "step", "score", "fevals"):
        np.testing.assert_array_equal(got.trace[key], want.trace[key],
                                      err_msg=key)
    assert got.trace["extras"].keys() == want.trace["extras"].keys()
    for key, v in want.trace["extras"].items():
        np.testing.assert_array_equal(got.trace["extras"][key], v)


def test_each_lane_is_minimize_alone_bit_for_bit():
    res = minimize_batched(port_fun, torch.tensor(X0), score_fn=port_score,
                           **OPTS)
    assert [r.status for r in res] == STATUSES
    assert len({r.iterations for r in res}) == len(res)
    # lane 3's second iteration starts from steepest descent
    assert res[3].trace["step"][2] == 1.0 / B
    for r, lane in enumerate(res):
        alone = minimize(port_fun, torch.tensor(X0[r]), score_fn=port_score,
                         **OPTS)
        assert_same(lane, alone)


def test_a_finished_lane_is_not_evaluated_again():
    """One objective call per round with every unfinished lane's trial:
    max(fun_evals) calls of sum(fun_evals) rows; one score call per round
    in which lanes end an iteration."""
    calls, scored = [], []

    def fun(X):
        calls.append(X.shape[0])
        return port_fun(X)

    def score(X, aux):
        scored.append(X.shape[0])
        return port_score(X, aux)

    res = minimize_batched(fun, torch.tensor(X0), score_fn=score, **OPTS)
    evals = [r.fun_evals for r in res]
    assert len(calls) == max(evals) and sum(calls) == sum(evals)
    assert calls == sorted(calls, reverse=True)
    ends = [e for r in res for e in r.trace["fevals"]]
    assert len(scored) == len(set(ends)) and sum(scored) == len(ends)


def test_lanes_match_jax_vmap_of_minimize():
    res = minimize_batched(port_fun, torch.tensor(X0), score_fn=port_score,
                           **OPTS)
    jres = jax.vmap(lambda x0: jminimize(jax_fun, x0, score_fn=jax_score,
                                         **OPTS))(jnp.asarray(X0))
    for key in ("iterations", "fun_evals", "status"):
        assert [getattr(r, key) for r in res] == np.asarray(
            getattr(jres, key)).tolist(), key
    for key in ("x", "x_best"):
        np.testing.assert_allclose(
            np.stack([getattr(r, key).numpy() for r in res]),
            np.asarray(getattr(jres, key)), err_msg=key, **X_TOL)


def test_continuation_and_attempts_per_lane():
    """init_best_score, x_best0 and max_attempts given lane by lane equal
    minimize with that lane's values (None: no floor, no cap)."""
    floors = [None, 1e300, -1.0, None, 0.0]
    best0 = torch.tensor(X0) + 0.25
    caps = [None, 2, 5, 1, 3]
    res = minimize_batched(port_fun, torch.tensor(X0), score_fn=port_score,
                           max_iter=60, max_attempts=caps,
                           init_best_score=floors, x_best0=best0)
    for r, lane in enumerate(res):
        alone = minimize(port_fun, torch.tensor(X0[r]), score_fn=port_score,
                         max_iter=60, max_attempts=caps[r],
                         init_best_score=floors[r], x_best0=best0[r])
        assert_same(lane, alone)
    # a floor no iterate reaches keeps the given best point and score
    assert torch.equal(res[1].x_best, best0[1]) and res[1].best_score == 1e300


def test_without_a_score_best_is_last():
    res = minimize_batched(port_fun, torch.tensor(X0[:2]), max_iter=30)
    for r, lane in enumerate(res):
        assert_same(lane, minimize(port_fun, torch.tensor(X0[r]),
                                   max_iter=30))
        assert torch.equal(lane.x_best, lane.x)
        assert lane.best_score == -lane.f


def test_per_lane_values_must_match_the_lanes():
    with pytest.raises(ValueError, match="3 values for 5 lanes"):
        minimize_batched(port_fun, torch.tensor(X0), max_attempts=[1, 2, 3])
