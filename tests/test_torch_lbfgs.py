"""gpz_tpu_torch.optim.minimize against gpz_tpu.optim.minimize in float64 on
the CPU: the problems of tests/test_lbfgs.py (without the patience exits,
which the port drops) and the continuation test of tests/test_continuation.py.
Each objective is written once in numpy-compatible operations and handed to
both optimizers, so the two runs see the same values; the port's host-side
search must then take the same branches: equal status, iterations and
evaluation counts, and the same f trace.

Tolerance of the trace: the iterates agree until rounding differences in the
dot products (XLA's reduction order against PyTorch's) are amplified by the
search; on these problems the f traces agree to 1e-9 relative, 1e-12
absolute (measured 3e-13 at most). max|g| and the step length are
differences of nearly equal numbers close to an optimum, so they are held to
1e-6 relative there (measured 1.1e-9).
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.optim import minimize as jminimize
from gpz_tpu.optim import lbfgs as jlbfgs
from gpz_tpu_torch.optim import minimize
from gpz_tpu_torch.optim import lbfgs

TRACE = dict(rtol=1e-9, atol=1e-12)
DERIVED = dict(rtol=1e-6, atol=1e-10)


def jwrap(f):
    vg = jax.value_and_grad(f)

    def fun(x):
        v, g = vg(x)
        return v, g, ()

    return fun


def twrap(f):
    def fun(x):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            v = f(x)
            g, = torch.autograd.grad(v, x)
        return v.detach(), g, ()

    return fun


def rosenbrock(x):
    return (100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1.0 - x[:-1]) ** 2).sum()


def _quadratic(xp):
    A = xp.asarray(np.diag([1.0, 10.0, 100.0]))
    b = xp.asarray(np.array([1.0, -2.0, 3.0]))
    return lambda x: 0.5 * x @ A @ x - b @ x


def _cosine_quadratic(xp):
    rng = np.random.default_rng(0)
    A = rng.standard_normal((20, 20))
    Q = xp.asarray(A @ A.T + np.eye(20))
    b = xp.asarray(rng.standard_normal(20))
    return lambda x: 0.5 * x @ Q @ x - b @ x + 0.1 * xp.cos(x).sum()


def _logistic(xp):
    rng = np.random.default_rng(1)
    X = rng.standard_normal((200, 5))
    y = (X @ rng.standard_normal(5) + 0.5 * rng.standard_normal(200) > 0
         ) * 2.0 - 1.0
    Xx, yx = xp.asarray(X), xp.asarray(y)
    return lambda w: xp.logaddexp(xp.zeros_like(yx), -yx * (Xx @ w)).sum(
        ) + 0.1 * w @ w


def _nan_region(xp):
    return lambda x: xp.where(x[0] > 2.0, np.nan, (x[0] - 1.9) ** 2).sum()


#: name -> (objective factory taking the array namespace, x0, options)
SMOOTH = {
    "quadratic": (_quadratic, np.zeros(3), dict(max_iter=100)),
    "rosenbrock-2d": (lambda xp: rosenbrock, np.array([-1.2, 1.0]),
                      dict(max_iter=500)),
    "rosenbrock-10d": (lambda xp: rosenbrock, np.zeros(10),
                       dict(max_iter=1000)),
    "cosine-quadratic": (_cosine_quadratic, np.zeros(20), dict(max_iter=200)),
    "logistic": (_logistic, np.zeros(5), dict(max_iter=200)),
    "nan-region": (_nan_region, np.array([-4.0]), dict(max_iter=100)),
    "small-history": (lambda xp: rosenbrock, np.zeros(6),
                      dict(max_iter=500, history=5)),
    "max-iter": (lambda xp: rosenbrock, np.array([-1.2, 1.0]),
                 dict(max_iter=7)),
    "already-optimal": (_quadratic, np.array([1.0, -0.2, 0.03]),
                        dict(max_iter=50)),
    "loose-wolfe": (lambda xp: rosenbrock, np.zeros(4),
                    dict(max_iter=300, c2=0.1, max_ls=6)),
}


def _wall(xp, alls):
    def f(x):
        ok = alls(abs(x) <= 0.01)
        v = xp.where(ok, 0.5 * ((x - 5.0) ** 2).sum(), np.nan)
        g = xp.where(ok, x - 5.0, np.nan)
        return v, g, ()
    return f


def _overflow(xp, alls):
    def f(x):
        v = xp.exp(50.0 * x[0]) - x[0]
        g = (50.0 * xp.exp(50.0 * x[0]) - 1.0).reshape(1)
        return v, g, ()
    return f


def _shell(xp, alls):
    def f(x):
        r = (x**2).sum()
        v = 0.5 * ((x - 2.0) ** 2).sum()
        bad = (r > 0.9) & (r < 1.1)
        return xp.where(bad, np.nan, v), xp.where(bad, np.nan, x - 2.0), ()
    return f


def _nan_start(xp, alls):
    def f(x):
        return (x * np.nan).sum(), x, ()
    return f


#: objectives that return their own gradient: name -> (factory, x0, options)
EXPLICIT = {
    "nonfinite-wall": (_wall, np.zeros(1), dict(max_iter=50)),
    "exp-overflow": (_overflow, np.array([5.0]), dict(max_iter=200)),
    "nan-shell": (_shell, np.zeros(2), dict(max_iter=100)),
    "nan-at-x0": (_nan_start, np.ones(2), dict(max_iter=10)),
}


def assert_same_run(res, jres, same_evals=True):
    n_it = int(jres.iterations)
    assert res.status == int(jres.status)
    assert res.iterations == n_it
    for key, tol in (("f", TRACE), ("score", TRACE), ("opt_cond", DERIVED),
                     ("step", DERIVED)):
        got = res.trace[key]
        assert got.shape == (n_it + 1,)
        np.testing.assert_allclose(
            got, np.asarray(jres.trace[key])[:n_it + 1], err_msg=key,
            equal_nan=True, **tol)
    if same_evals:
        assert res.fun_evals == int(jres.fun_evals)
        np.testing.assert_array_equal(
            res.trace["fevals"], np.asarray(jres.trace["fevals"])[:n_it + 1])
    np.testing.assert_allclose(res.x.numpy(), np.asarray(jres.x),
                               equal_nan=True, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(res.f, float(jres.f), equal_nan=True, **TRACE)


@pytest.mark.parametrize("name", list(SMOOTH))
def test_same_run_as_jax_on_smooth_problems(name):
    make, x0, opts = SMOOTH[name]
    jres = jminimize(jwrap(make(jnp)), jnp.asarray(x0), **opts)
    res = minimize(twrap(make(torch)), torch.from_numpy(x0), **opts)
    assert_same_run(res, jres)
    # with no score_fn, best == last
    np.testing.assert_array_equal(res.x_best.numpy(), res.x.numpy())
    assert res.best_score == -res.f


@pytest.mark.parametrize("name", list(EXPLICIT))
def test_same_run_as_jax_on_nonfinite_objectives(name):
    make, x0, opts = EXPLICIT[name]
    jres = jminimize(make(jnp, jnp.all), jnp.asarray(x0), **opts)
    res = minimize(make(torch, torch.all), torch.from_numpy(x0), **opts)
    # exp-overflow: f = exp(50 x) - x passes through 1 + 1e-15, where the
    # last bit of the two libraries' exp decides how many trials a failing
    # search spends; the iterations still agree, the evaluation count is
    # only close
    assert_same_run(res, jres, same_evals=name != "exp-overflow")
    assert abs(res.fun_evals - int(jres.fun_evals)) <= 2


def test_the_problems_reach_their_optima():
    """The absolute checks of tests/test_lbfgs.py, on the port alone."""
    run = lambda name: minimize(            # noqa: E731
        twrap(SMOOTH[name][0](torch)), torch.from_numpy(SMOOTH[name][1]),
        **SMOOTH[name][2])
    res = run("quadratic")
    np.testing.assert_allclose(res.x.numpy(), [1.0, -0.2, 0.03], atol=1e-6)
    assert res.status in (lbfgs.STATUS_OPTIMAL, lbfgs.STATUS_STEP_TOO_SMALL)
    res = run("rosenbrock-10d")
    np.testing.assert_allclose(res.x.numpy(), np.ones(10), atol=1e-4)
    assert res.f < 1e-9
    assert np.all(np.diff(res.trace["f"]) <= 1e-10)
    np.testing.assert_allclose(run("nan-region").x.numpy(), [1.9], atol=1e-4)
    assert run("max-iter").status == lbfgs.STATUS_MAX_ITER
    res = run("already-optimal")
    assert (res.status, res.iterations, res.fun_evals) == (
        lbfgs.STATUS_OPTIMAL, 0, 1)
    make, x0, opts = EXPLICIT["nonfinite-wall"]
    res = minimize(make(torch, torch.all), torch.from_numpy(x0), **opts)
    np.testing.assert_allclose(float(res.x[0]), 0.01, atol=1e-6)
    make, x0, opts = EXPLICIT["nan-at-x0"]
    res = minimize(make(torch, torch.all), torch.from_numpy(x0), **opts)
    assert (res.status, res.iterations) == (lbfgs.STATUS_LS_FAILED, 0)


def test_status_codes_are_gpz_tpus():
    for name in ("RUNNING", "OPTIMAL", "STEP_TOO_SMALL", "MAX_ITER",
                 "EARLY_STOP", "LS_FAILED", "NO_DESCENT", "PLATEAU"):
        assert getattr(lbfgs, "STATUS_" + name) == getattr(
            jlbfgs, "STATUS_" + name)


@pytest.mark.parametrize("max_attempts", [2, 5, None])
def test_early_stopping_by_score(max_attempts):
    """Score that degrades on the way to the optimum triggers early stop and
    best-x tracking (ref callBack.m:26-34), as in gpz_tpu."""
    def make(xp):
        c = xp.asarray(np.array([1.0, 10.0, 100.0, 1000.0]))
        fun = (jwrap if xp is jnp else twrap)(
            lambda x: (c * (x - 3.0) ** 2).sum())

        def score_fn(x, aux):
            s = -((x - 1.0) ** 2).sum()
            return s, {"s": s, "twice": 2.0 * s}

        return fun, score_fn

    opts = dict(max_iter=100, max_attempts=max_attempts)
    jfun, jscore = make(jnp)
    jres = jminimize(jfun, jnp.zeros(4), score_fn=jscore, **opts)
    fun, score = make(torch)
    rows = []
    res = minimize(fun, torch.zeros(4, dtype=torch.float64), score_fn=score,
                   iter_callback=lambda *row: rows.append(row), **opts)
    assert_same_run(res, jres)
    if max_attempts == 2:
        assert res.status == lbfgs.STATUS_EARLY_STOP
    np.testing.assert_allclose(res.x_best.numpy(), np.asarray(jres.x_best),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.best_score, float(jres.best_score),
                               **TRACE)
    n_it = res.iterations
    for key in ("s", "twice"):
        np.testing.assert_allclose(
            res.trace["extras"][key],
            np.asarray(jres.trace["extras"][key])[:n_it + 1], **TRACE)
    # the callback saw one row per iteration, iteration 0 included
    assert [r[0] for r in rows] == list(range(n_it + 1))
    np.testing.assert_array_equal([r[1] for r in rows], res.trace["f"])
    best = -np.inf
    for (_, _, _, _, s, improved, extras) in rows:
        assert improved == (s >= best) and extras["twice"] == 2.0 * s
        best = max(best, s)


def test_minimize_keeps_x_best0_when_no_improvement():
    # the score can never beat the provided floor, so the provided x_best0
    # must come back untouched (tests/test_continuation.py)
    def fun(x):
        return 0.5 * (x**2).sum(), x, ()

    def score_fn(x, aux):
        return -(x**2).sum() - 100.0, {}

    x0 = np.full(4, 2.0)
    prev = np.arange(4.0) + 7.0
    jres = jminimize(fun, jnp.asarray(x0),
                     score_fn=lambda x, aux: (score_fn(x, aux)[0], ()),
                     max_iter=10, init_best_score=jnp.asarray(-1.0),
                     x_best0=jnp.asarray(prev))
    res = minimize(fun, torch.from_numpy(x0), score_fn=score_fn, max_iter=10,
                   init_best_score=-1.0, x_best0=torch.from_numpy(prev))
    assert_same_run(res, jres)
    np.testing.assert_array_equal(res.x_best.numpy(), prev)
    assert res.best_score == -1.0 == float(jres.best_score)
    assert res.f < 1e-3
