"""The training slice as a whole, gpz_tpu_torch against gpz_tpu in float64 on
the CPU: init -> train -> (continued) train -> predict on a seeded photo-z
problem (400 training rows, m=8, VC, full psi, validation).

Tolerances. init is NumPy on the host in both packages: parameters are equal
bit for bit, the posterior goes through the two packages' solves (1e-9). The
two optimizers then start from identical points and must take the same
branches (same evaluation counts); along 15 iterations rounding differences
between XLA's and PyTorch's reductions grow with the curvature history, so
the f trace is held to 1e-7 relative (measured 7e-11), the trained parameters
to 1e-5 (measured 4e-8) and the predictions, which amplify parameter
differences through exp(lnPHI) and the (m x m) inverse, to 1e-4 (measured
1e-7).
"""

import dataclasses

import numpy as np
import pytest
import torch

import gpz_tpu
from gpz_tpu import datautils as jdu
from gpz_tpu.data import synthetic_sdss

import gpz_tpu_torch
from gpz_tpu_torch import datautils as tdu
from gpz_tpu_torch.data import synthetic_sdss as port_synthetic_sdss
from gpz_tpu_torch.model import _make_dataset
from gpz_tpu_torch.objective import nlog_ml
from gpz_tpu_torch.ops import vc_phi
from gpz_tpu_torch.params import FIELDS

from make_torch_port_golden import (
    CHECKPOINT, OBJECTIVE_ROWS, TRAIN_TOL, load_golden_train, objective_rows,
    train_problem,
)

POSTERIOR = dict(rtol=1e-9, atol=1e-12)
TRACE = dict(rtol=1e-7, atol=1e-9)
TRAINED = dict(rtol=1e-5, atol=1e-7)
PREDICTED = dict(rtol=1e-4, atol=1e-7)

N, M, ITERS = 600, 8, 15


def problem():
    mags, errs, z = synthetic_sdss(N, filters=5, seed=1)
    tr = np.zeros(N, bool)
    va = np.zeros(N, bool)
    tr[:400] = True
    va[400:500] = True
    return mags, z, errs ** 2, tr, va


def assert_same_pset(pset, jpset, params_tol, post_tol):
    for f in FIELDS:
        a, b = getattr(pset.params, f), getattr(jpset.params, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f,
                                       **params_tol)
    for f in ("w", "iSigma_w", "logdet"):
        np.testing.assert_allclose(getattr(pset.post, f).numpy(),
                                   np.asarray(getattr(jpset.post, f)),
                                   err_msg=f, **post_tol)
    np.testing.assert_allclose(pset.priors.numpy(), np.asarray(jpset.priors),
                               **post_tol)


INIT_CASES = {
    "VC-psi": dict(method="VC", psi=True),
    "GC-nopsi": dict(method="GC", psi=False),
    "VC-homoscedastic-weighted": dict(method="VC", psi=True,
                                      heteroscedastic=False, omega=True),
    "GC-unnormalized": dict(method="GC", psi=True, normalize=False),
}


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_init_equals_jax_init(name):
    opts = dict(INIT_CASES[name])
    X, Y, psi, tr, _ = problem()
    kw = dict(training=tr, seed=3, dtype="float64",
              psi=psi if opts.pop("psi") else None)
    if opts.pop("omega", False):
        kw["omega"] = tdu.get_omega(Y, "normalized")
    method = opts.pop("method")
    jm = gpz_tpu.init(X, Y, method, M, **kw, **opts)
    tm = gpz_tpu_torch.init(X, Y, method, M, device="cpu", **kw, **opts)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    for f in ("muX", "sdX", "muY"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    exact = dict(rtol=0, atol=0)
    assert_same_pset(tm.last, jm.last, exact, POSTERIOR)
    assert_same_pset(tm.best, jm.best, exact, POSTERIOR)
    assert tm.best.score == jm.best.score == -np.inf
    assert tm.last.params.gamma.shape == jm.cfg.gamma_shape


def test_init_helpers_equal_jax():
    X = np.random.default_rng(0).standard_normal((50, 4))
    X[::7, 1] = np.nan
    X[3::9, 3] = np.nan
    got, want = tdu.pca_whiten_np(X), jdu.pca_whiten_np(X)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdu.fill_linear_np(X, got[0], got[1]),
                                  jdu.fill_linear_np(X, want[0], want[1]))


@pytest.fixture(scope="module")
def trained():
    """(problem, JAX models, port models): init, 15 iterations, then a
    continuation of 5 more, in both packages."""
    X, Y, psi, tr, va = problem()
    kw = dict(training=tr, validation=va, psi=psi, verbose=False,
              max_attempts=50)
    j0 = gpz_tpu.init(X, Y, "VC", M, psi=psi, training=tr, seed=1,
                      dtype="float64")
    j1 = gpz_tpu.train(j0, X, Y, max_iter=ITERS, **kw)
    j2 = gpz_tpu.train(j1, X, Y, max_iter=5, **kw)
    t0 = gpz_tpu_torch.init(X, Y, "VC", M, psi=psi, training=tr, seed=1,
                            dtype="float64", device="cpu")
    t1 = gpz_tpu_torch.train(t0, X, Y, max_iter=ITERS, **kw)
    t2 = gpz_tpu_torch.train(t1, X, Y, max_iter=5, **kw)
    return (X, Y, psi, tr, va), (j0, j1, j2), (t0, t1, t2)


@pytest.mark.parametrize("run", [1, 2], ids=["fresh", "continued"])
def test_train_takes_jaxs_trajectory(trained, run):
    _, jms, tms = trained
    jfit, fit = jms[run].fit_info, tms[run].fit_info
    n_it = jfit["iterations"]
    assert n_it == (ITERS, 5)[run - 1]
    for key in ("iterations", "fun_evals", "status"):
        assert fit[key] == jfit[key], key
    np.testing.assert_allclose(fit["final_nlml"], jfit["final_nlml"], **TRACE)
    assert fit["seconds"] > 0
    jtrace, trace = jfit["trace"], fit["trace"]
    np.testing.assert_array_equal(
        trace["fevals"], np.asarray(jtrace["fevals"])[:n_it + 1])
    for key in ("f", "score"):
        assert trace[key].shape == (n_it + 1,)
        np.testing.assert_allclose(
            trace[key], np.asarray(jtrace[key])[:n_it + 1], err_msg=key,
            **TRACE)
    assert sorted(trace["extras"]) == sorted(jtrace["extras"])
    for key, want in jtrace["extras"].items():
        np.testing.assert_allclose(
            trace["extras"][key], np.asarray(want)[:n_it + 1], err_msg=key,
            **TRACE)
    assert np.all(np.diff(trace["f"]) <= 0)


@pytest.mark.parametrize("run", [1, 2], ids=["fresh", "continued"])
def test_trained_parameter_sets_agree(trained, run):
    _, jms, tms = trained
    jm, tm = jms[run], tms[run]
    assert_same_pset(tm.last, jm.last, TRAINED, PREDICTED)
    assert_same_pset(tm.best, jm.best, TRAINED, PREDICTED)
    np.testing.assert_allclose(tm.best.score, jm.best.score, **TRACE)
    assert tm.last.score == jm.last.score == -np.inf


def test_continuation_keeps_best_unless_beaten(trained):
    (X, Y, psi, tr, va), _, (_, t1, t2) = trained
    assert t2.best.score >= t1.best.score
    # corrupted validation targets: the old best can never be beaten, so its
    # parameters and score must survive the run (tests/test_continuation.py)
    Y_bad = Y.copy()
    Y_bad[va] += 100.0 * np.sign(np.arange(va.sum()) % 2 - 0.5)
    t3 = gpz_tpu_torch.train(t1, X, Y_bad, training=tr, validation=va,
                             psi=psi, max_iter=5, verbose=False)
    assert t3.best.score == t1.best.score
    for f in FIELDS:
        torch.testing.assert_close(getattr(t3.best.params, f),
                                   getattr(t1.best.params, f), rtol=0, atol=0)
    # the run itself still moved `last`
    assert not torch.equal(t3.last.params.P, t1.last.params.P)


def test_predict_with_the_trained_model_agrees(trained):
    (X, _, psi, tr, va), (_, j1, _), (_, t1, _) = trained
    test = ~(tr | va)
    for which in ("best", "last"):
        jp = gpz_tpu.predict(X[test], j1, psi=psi[test], which_set=which)
        tp = gpz_tpu_torch.predict(X[test], t1, psi=psi[test],
                                   which_set=which)
        for key in ("mu", "sigma", "nu", "beta_i", "gamma"):
            np.testing.assert_allclose(getattr(tp, key),
                                       np.asarray(getattr(jp, key)),
                                       err_msg=f"{which}.{key}", **PREDICTED)


def test_float32_model_trains_in_float64_and_is_stored_in_float32():
    X, Y, psi, tr, va = problem()
    m32 = gpz_tpu_torch.init(X, Y, "VC", M, psi=psi, training=tr, seed=1,
                             device="cpu")
    assert m32.cfg.dtype == "float32"
    assert m32.last.params.P.dtype == torch.float32
    out = gpz_tpu_torch.train(m32, X, Y, training=tr, validation=va, psi=psi,
                              max_iter=3, verbose=False)
    assert out.cfg.dtype == "float32"
    for pset in (out.last, out.best):
        tensors = [getattr(pset.params, f) for f in FIELDS] + [
            pset.post.w, pset.post.iSigma_w, pset.post.logdet, pset.priors]
        assert all(t.dtype == torch.float32 and t.is_contiguous()
                   for t in tensors)
    trace = out.fit_info["trace"]
    assert trace["f"].dtype == np.float64
    assert trace["f"][-1] < trace["f"][0]
    pred = gpz_tpu_torch.predict(X[va], out, psi=psi[va])
    assert np.isfinite(pred.mu).all() and (pred.sigma > 0).all()


def test_train_without_validation_and_verbose_table(capsys):
    X, Y, psi, tr, _ = problem()
    model = gpz_tpu_torch.init(X, Y, "GC", 4, training=tr, seed=2,
                               dtype="float64", device="cpu")
    out = gpz_tpu_torch.train(model, X, Y, training=tr, max_iter=3)
    lines = capsys.readouterr().out.splitlines()
    # live rows (header + 4 rows) then the post-hoc table and its summary
    assert lines[0].split() == ["Iter", "logML/n", "Time"]
    assert [ln.split()[0] for ln in lines[1:5]] == ["0", "1", "2", "3"]
    assert lines[5].split() == ["Iter", "logML/n"]
    assert lines[-1].strip().startswith("[3 iters,")
    # no score_fn: best mirrors last, and last carries the score
    torch.testing.assert_close(out.best.params.P, out.last.params.P,
                               rtol=0, atol=0)
    assert out.last.score == out.best.score == -out.fit_info["final_nlml"]


@pytest.mark.parametrize("case", ["diagonal-family", "missing-values"])
def test_training_refuses_what_is_not_ported(case):
    X, Y, _, tr, _ = problem()
    method = "VC"
    if case == "diagonal-family":
        method = "VD"
    else:
        X = X.copy()
        X[5, 2] = np.nan
    with pytest.raises(NotImplementedError, match="not ported"):
        gpz_tpu_torch.init(X, Y, method, M, training=tr, device="cpu")


def test_objective_matches_the_training_golden_file(monkeypatch):
    """What chip_smoke.py checks on the GPU, on the CPU: init on the
    80,000-row training problem reproduces gpz_tpu's parameters, and nlog_ml
    with its gradient on the first 4,096 training rows is within TRAIN_TOL of
    JAX's values at the init point and at the trained checkpoint. At the
    trained point the gradient also moves, within the same tolerance, when
    only the row blocks of the plain sums are cut differently: that is what
    float64 resolves there (see TRAIN_TOL)."""
    gold = load_golden_train()
    X, Y, psi, tr, _ = train_problem(port_synthetic_sdss)
    model = gpz_tpu_torch.init(X, Y, "VC", 100, psi=psi, training=tr, seed=1,
                               dtype="float64", device="cpu")
    flat0, unravel = model.last.params.flatten()
    np.testing.assert_allclose(flat0.numpy(), gold["init.flat"], rtol=0,
                               atol=TRAIN_TOL["init.flat"])
    trained = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu").astype(
        "float64")
    rows = objective_rows(tr)

    def value_and_grad(mdl, flat):
        Xn = (X - mdl.muX[None, :]) / mdl.sdX[None, :]
        Yc = Y[:, None] - mdl.muY[None, :]
        psi_c = tdu.fix_psi(psi, len(Y), mdl.sdX, True)
        data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), rows,
                             torch.float64, "cpu")
        assert data.n == OBJECTIVE_ROWS
        flat = flat.clone().requires_grad_(True)
        nlml, _ = nlog_ml(unravel(flat), data, mdl.cfg, complete=True)
        return float(nlml.detach()), torch.autograd.grad(nlml, flat)[0].numpy()

    points = {"init": (model, torch.from_numpy(gold["init.flat"])),
              "trained": (trained, trained.best.params.flatten()[0])}
    for name, (mdl, flat) in points.items():
        f, g = value_and_grad(mdl, flat)
        (frt, fat), (grt, gat) = TRAIN_TOL[f"{name}.nlml"], TRAIN_TOL[
            f"{name}.grad"]
        np.testing.assert_allclose(f, gold[f"{name}.nlml"], rtol=frt,
                                   atol=fat, err_msg=name)
        np.testing.assert_allclose(g, gold[f"{name}.grad"], rtol=grt,
                                   atol=gat, err_msg=name)
    monkeypatch.setattr(vc_phi, "PHI_BLOCK_ROWS", 1000)
    f2, g2 = value_and_grad(*points["trained"])
    np.testing.assert_allclose(f2, f, rtol=frt, atol=fat)
    np.testing.assert_allclose(g2, g, rtol=grt, atol=gat)
    print(f"trained point: gradient vs JAX max_abs "
          f"{np.abs(g - gold['trained.grad']).max():.3e}, vs itself with "
          f"1000-row blocks {np.abs(g2 - g).max():.3e}, largest entry "
          f"{np.abs(g).max():.3e}")
