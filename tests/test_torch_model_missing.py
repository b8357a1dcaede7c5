"""init -> train -> predict on rows with missing values, gpz_tpu_torch against
gpz_tpu in float64 on the CPU: seeded small equivalents of
tests/test_model_2d.py (VD, NaNs, a fully missing column at prediction) and
tests/test_model_sinc.py (input noise, cost weights), for the diagonal and
the full-covariance family, and sample_weights.

Tolerances, as in tests/test_torch_train.py: init is host NumPy in both
packages (parameters equal bit for bit; the posterior goes through the two
packages' solves, 1e-9). The optimizers start from identical points and must
take the same branches (equal evaluation counts); over 8 iterations rounding
differences between XLA's and PyTorch's reductions grow with the curvature
history: f trace 1e-7 relative, trained parameters 1e-5, predictions 1e-4.
gpz_tpu's mixture scans run in float64 here (GPZ_MIX_DTYPE), as the port's do.
"""

import dataclasses

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu

import gpz_tpu_torch
from gpz_tpu_torch import datautils as tdu
from gpz_tpu_torch.objective import Posterior

from test_torch_train import (
    POSTERIOR, PREDICTED, TRACE, TRAINED, assert_same_pset,
)

N, D, M, ITERS = 60, 3, 5, 8
METHODS = ("GL", "VL", "GD", "VD", "GC", "VC")


def problem(full_psi, seed=0):
    """60 rows in 3 dims, a third of them with one or two NaNs; 40 train, 20
    validate; heteroscedastic targets; per-row input noise."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2.0, 2.0, (N, D))
    Y = np.sinc(X[:, 0]) + 0.3 * X[:, 1] + (0.05 + 0.05 * np.abs(X[:, 2])
                                            ) * rng.standard_normal(N)
    drop = rng.random((N, D)) < 0.15
    drop[drop.all(axis=1), 0] = False
    X[drop] = np.nan
    if full_psi:
        A = rng.standard_normal((N, D, D)) * 0.1
        psi = A @ np.swapaxes(A, 1, 2) + 0.01 * np.eye(D)
    else:
        psi = 0.01 + 0.03 * rng.random((N, D))
    tr = np.zeros(N, bool)
    tr[:40] = True
    return X, Y, psi, tr, ~tr


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("method", METHODS)
def test_init_with_nans_equals_jax_init(method, with_psi):
    X, Y, psi, tr, _ = problem(method in ("GC", "VC"))
    kw = dict(training=tr, seed=3, dtype="float64",
              psi=psi if with_psi else None,
              omega=tdu.get_omega(Y, "balanced"))
    jm = gpz_tpu.init(X, Y, method, M, **kw)
    tm = gpz_tpu_torch.init(X, Y, method, M, device="cpu", **kw)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    for f in ("muX", "sdX", "muY"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    assert_same_pset(tm.last, jm.last, dict(rtol=0, atol=0), POSTERIOR)
    assert tm.last.params.gamma.shape == jm.cfg.gamma_shape


@pytest.fixture(scope="module", params=["VD", "VC"])
def trained(request):
    """(problem, JAX models, port models) for one method: init, 8 iterations
    with validation and balanced cost weights, rows with NaNs throughout."""
    method = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("GPZ_MIX_DTYPE", "float64")
    X, Y, psi, tr, va = problem(method == "VC", seed=1)
    omega = tdu.get_omega(Y, "balanced")
    kw = dict(training=tr, validation=va, psi=psi, omega=omega,
              verbose=False, max_attempts=50)
    ikw = dict(psi=psi, training=tr, omega=omega, seed=1, dtype="float64")
    j0 = gpz_tpu.init(X, Y, method, M, **ikw)
    j1 = gpz_tpu.train(j0, X, Y, max_iter=ITERS, **kw)
    t0 = gpz_tpu_torch.init(X, Y, method, M, device="cpu", **ikw)
    t1 = gpz_tpu_torch.train(t0, X, Y, max_iter=ITERS, **kw)
    # rows to predict: the validation rows, a row with nothing observed, and
    # (as tests/test_model_2d.py does) a copy with column 1 fully missing
    Xp = X[va].copy()
    Xp[3] = np.nan
    Xc = Xp.copy()
    Xc[:, 1] = np.nan
    preds = {name: (gpz_tpu.predict(x, j1, psi=psi[va]),
                    gpz_tpu_torch.predict(x, t1, psi=psi[va]))
             for name, x in (("rows", Xp), ("column", Xc))}
    yield (X, Y, psi, tr, va), (j0, j1), (t0, t1), preds
    mp.undo()


def test_train_with_nans_takes_jaxs_trajectory(trained):
    _, (_, j1), (_, t1), _ = trained
    jfit, fit = j1.fit_info, t1.fit_info
    n_it = jfit["iterations"]
    assert n_it == ITERS
    for key in ("iterations", "fun_evals", "status"):
        assert fit[key] == jfit[key], key
    jtrace, trace = jfit["trace"], fit["trace"]
    np.testing.assert_array_equal(
        trace["fevals"], np.asarray(jtrace["fevals"])[:n_it + 1])
    for key in ("f", "score"):
        np.testing.assert_allclose(
            trace[key], np.asarray(jtrace[key])[:n_it + 1], err_msg=key,
            **TRACE)
    for key, want in jtrace["extras"].items():
        np.testing.assert_allclose(
            trace["extras"][key], np.asarray(want)[:n_it + 1], err_msg=key,
            **TRACE)
    assert np.all(np.diff(trace["f"]) <= 0)
    assert trace["f"][-1] < trace["f"][0]


def test_trained_parameter_sets_with_nans_agree(trained):
    _, (_, j1), (_, t1), _ = trained
    assert_same_pset(t1.last, j1.last, TRAINED, PREDICTED)
    assert_same_pset(t1.best, j1.best, TRAINED, PREDICTED)
    np.testing.assert_allclose(t1.best.score, j1.best.score, **TRACE)


@pytest.mark.parametrize("which", ["rows", "column"])
def test_predict_with_nans_agrees(trained, which):
    jp, tp = trained[3][which]
    for key in ("mu", "sigma", "nu", "beta_i", "gamma", "phi"):
        got = getattr(tp, key)
        assert got.shape == np.asarray(getattr(jp, key)).shape
        assert np.isfinite(got).all(), key
        np.testing.assert_allclose(got, np.asarray(getattr(jp, key)),
                                   err_msg=key, **PREDICTED)
    assert (tp.sigma > 0).all() and (tp.nu >= 0).all()
    assert (tp.gamma >= 0).all()


def test_a_missing_column_widens_the_variance(trained):
    """Marginalizing a whole input away cannot make the model surer on
    average (tests/test_model_2d.py's check)."""
    _, tp_rows = trained[3]["rows"]
    _, tp_col = trained[3]["column"]
    assert tp_col.sigma.mean() > tp_rows.sigma.mean()


@pytest.mark.parametrize("which_set", ["best", "last"])
def test_sample_weights_draws_equal_jaxs(trained, which_set):
    """The same posterior arrays and the same seed give the same draws, bit
    for bit: one NumPy computation in both packages."""
    _, (_, j1), (_, t1), _ = trained
    jset = getattr(j1, which_set)
    post = Posterior(**{f: torch.from_numpy(np.array(getattr(jset.post, f)))
                        for f in ("w", "iSigma_w", "logdet")})
    same = dataclasses.replace(t1, **{which_set: dataclasses.replace(
        getattr(t1, which_set), post=post)})
    want = gpz_tpu.sample_weights(j1, 7, which_set=which_set, seed=5)
    got = gpz_tpu_torch.sample_weights(same, 7, which_set=which_set, seed=5)
    assert got.shape == (M, 1, 7)
    np.testing.assert_array_equal(got, want)
    # and with the port's own posterior: the same draws to its tolerance
    own = gpz_tpu_torch.sample_weights(t1, 7, which_set=which_set, seed=5)
    np.testing.assert_allclose(own, want, rtol=1e-3, atol=1e-5)
    assert not np.array_equal(
        got, gpz_tpu_torch.sample_weights(same, 7, which_set=which_set,
                                          seed=6))
