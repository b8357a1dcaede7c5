"""gpz_tpu_torch's host optimizers and gradient checks against gpz_tpu's.

The solvers (`minimize_any` with every entry of METHODS, `minimize_host`,
`armijo_backtrack`, `conj_grad`, `numerical_hvp`) are NumPy code on the host
in both packages, driving the same native kernels: on the same callable the
port must give x, f, iterations, evaluations, status and trace equal to
gpz_tpu's to the bit.

The derivative checks evaluate the callable on tensors (port) and JAX arrays
(gpz_tpu), whose exp and reductions may round differently in the last place
(2e-15 at f ~ 10); a forward difference divides that by 1e-6, so
`numerical_gradient` is held to 2e-8 absolute, ten such units (measured
3.6e-9 on the CPU, forward; central differences halve it).
`check_gradient` must also pass on nlog_ml of a small VC model, whose
gradient comes from autograd through the plain twin of the design-matrix
kernel pair.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch
import jax.numpy as jnp

from gpz_tpu import optim as jopt
from gpz_tpu.data import synthetic_sdss

import gpz_tpu_torch
from gpz_tpu_torch import datautils as tdu
from gpz_tpu_torch import optim as topt
from gpz_tpu_torch.model import _make_dataset
from gpz_tpu_torch.objective import nlog_ml

NUMERICAL = dict(rtol=0, atol=2e-8)


def rosenbrock(x):
    f = 100 * (x[1] - x[0] ** 2) ** 2 + (1 - x[0]) ** 2
    g = np.array([
        -400 * x[0] * (x[1] - x[0] ** 2) - 2 * (1 - x[0]),
        200 * (x[1] - x[0] ** 2),
    ])
    H = np.array([
        [1200 * x[0] ** 2 - 400 * x[1] + 2, -400 * x[0]],
        [-400 * x[0], 200.0],
    ])
    return f, g, H


def make_quadratic():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((6, 6))
    A = A @ A.T + 0.5 * np.eye(6)
    b = rng.standard_normal(6)

    def quad(x):
        return 0.5 * x @ A @ x - b @ x, A @ x - b, A

    return quad, np.zeros(6)


def with_hessian(fun, method):
    """The Newton family reads H from a third output; the others get
    (f, g)."""
    if method in ("newton", "mnewton", "tensor"):
        return fun
    return lambda x: fun(x)[:2]


def assert_same_result(got, want):
    np.testing.assert_array_equal(got.x, want.x)
    assert got.f == want.f
    assert (got.iterations, got.fun_evals, got.status) == (
        want.iterations, want.fun_evals, want.status)
    assert got.trace == want.trace


@pytest.mark.parametrize("problem", ["rosenbrock", "quadratic"])
@pytest.mark.parametrize("method", jopt.METHODS)
def test_every_method_equals_gpz_tpu(method, problem):
    if problem == "rosenbrock":
        fun, x0 = rosenbrock, np.array([-1.2, 1.0])
    else:
        fun, x0 = make_quadratic()
    fun = with_hessian(fun, method)
    kw = dict(method=method, max_iter=150, history=7)
    got = topt.minimize_any(fun, x0, **kw)
    want = jopt.minimize_any(fun, x0, **kw)
    assert_same_result(got, want)
    assert got.iterations > 0 and got.f < fun(x0)[0]


HOST_CASES = {
    "rosenbrock-8": dict(history=100, max_iter=500),
    "rosenbrock-8-history-3": dict(history=3, max_iter=60),
    "callback-stop": dict(history=5, max_iter=50,
                          callback=lambda x, f, g, it: it == 6),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_minimize_host_equals_gpz_tpu(case):
    def rosen(x):
        f = np.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
        g = np.zeros_like(x)
        g[:-1] = -400 * x[:-1] * (x[1:] - x[:-1] ** 2) - 2 * (1 - x[:-1])
        g[1:] += 200 * (x[1:] - x[:-1] ** 2)
        return f, g

    x0 = np.linspace(-1.0, 0.5, 8)
    got = topt.minimize_host(rosen, x0, **HOST_CASES[case])
    want = jopt.minimize_host(rosen, x0, **HOST_CASES[case])
    assert_same_result(got, want)
    if case == "callback-stop":
        assert got.status == "callback_stop" and got.iterations == 7


@pytest.mark.parametrize("helper", ["armijo", "armijo-nonfinite",
                                    "conj_grad", "conj_grad-negative",
                                    "numerical_hvp"])
def test_search_and_newton_helpers_equal_gpz_tpu(helper):
    x0 = np.array([-1.2, 1.0])
    f0, g0, _ = rosenbrock(x0)
    fg = with_hessian(rosenbrock, "lbfgs")
    if helper == "armijo":
        args = (fg, x0, f0, g0, -g0, 1.0, 1e-4, 25, 1e-9)
    elif helper == "armijo-nonfinite":
        def fg(x):
            return (np.inf if x[0] > 0.5 else float(x @ x)), 2 * x
        x0 = np.array([0.4, 0.0])
        args = (fg, x0, 0.16, 2 * x0, np.array([1.0, 0.0]), 1.0, 1e-4, 25,
                1e-9)
    elif helper == "conj_grad":
        rng = np.random.default_rng(1)
        A = rng.standard_normal((8, 8))
        A = A @ A.T + np.eye(8)
        args = (lambda v: A @ v, rng.standard_normal(8), 1e-10, 100)
    elif helper == "conj_grad-negative":
        A = np.diag([-1.0, 1.0])
        args = (lambda v: A @ v, np.array([1.0, 0.0]), 1e-10, 100)
    else:
        args = (fg, np.array([0.3, -0.7]), np.array([0.5, 1.0]))
    name = helper.split("-")[0]
    if name == "armijo":
        name = "armijo_backtrack"
    got = getattr(topt, name)(*args)
    want = getattr(jopt, name)(*args)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_array_equal(g, w)


def smooth_torch(x):
    return (x ** 4).sum() / 4 + x[0] * x[1] + (x ** 2).sum() - torch.exp(
        0.3 * x).sum()


def smooth_jax(x):
    return (x ** 4).sum() / 4 + x[0] * x[1] + (x ** 2).sum() - jnp.exp(
        0.3 * x).sum()


@pytest.mark.parametrize("order", [1, 2])
def test_numerical_gradient_equals_gpz_tpu(order):
    x = np.linspace(-1.3, 1.7, 6)
    got = topt.numerical_gradient(smooth_torch, torch.from_numpy(x),
                                  order=order)
    want = jopt.numerical_gradient(smooth_jax, x, order=order)
    np.testing.assert_allclose(got, want, **NUMERICAL)


@pytest.mark.parametrize("rtol", [1e-4, 1e-14])
def test_check_gradient_equals_gpz_tpu(rtol):
    """The default tolerance passes; a tolerance below what central
    differences resolve fails, in both packages."""
    x = np.linspace(-1.3, 1.7, 6)
    ok, err = topt.check_gradient(smooth_torch, torch.from_numpy(x),
                                  rtol=rtol, atol=0.0)
    jok, jerr = jopt.check_gradient(smooth_jax, x, rtol=rtol, atol=0.0)
    assert ok == jok == (rtol == 1e-4)
    np.testing.assert_allclose(err, jerr, **NUMERICAL)


def test_check_gradient_passes_on_nlog_ml():
    """autograd through nlog_ml (VC, m=6, psi, CPU: the plain twins of the
    kernel pair) against central differences, in every parameter."""
    mags, errs, z = synthetic_sdss(120, filters=5, seed=2)
    model = gpz_tpu_torch.init(mags, z, "VC", 6, psi=errs ** 2, seed=3,
                               dtype="float64", device="cpu")
    Xn = (mags - model.muX[None, :]) / model.sdX[None, :]
    Yc = z[:, None] - model.muY[None, :]
    psi_c = tdu.fix_psi(errs ** 2, len(z), model.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(len(z)),
                         np.ones(len(z), bool), torch.float64, "cpu")
    flat0, unravel = model.last.params.flatten()

    def f(flat):
        return nlog_ml(unravel(flat), data, model.cfg, complete=True)[0]

    ok, err = topt.check_gradient(f, flat0)
    assert ok, err
    assert err < 1e-7
