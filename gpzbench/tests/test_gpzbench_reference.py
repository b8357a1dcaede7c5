"""The plain reference agrees with gpz_tpu_torch on the CPU at a tiny size:
init, the objective's value and gradient, the optimizer's first steps,
the posterior and the served moments with and without missing bands."""

import dataclasses

import numpy as np
import pytest
import torch

import tiny
from gpzbench import data
from gpzbench.reference import gpz as ref, lbfgs as ref_lbfgs

SEED = 4_294_967_311
M = 12
f64 = torch.float64


@pytest.fixture(scope="module")
def problem():
    import gpz_tpu_torch as g

    cfg = dict(tiny.TINY_CFG, d=5)
    X, Y, psi, tr, va = data.training_problem(cfg, SEED)
    model0 = g.init(X, Y, "VC", M, heteroscedastic=True, training=tr,
                    psi=psi, seed=11, dtype="float64", device="cpu")
    return X, Y, psi, tr, va, model0


def test_init(problem):
    X, Y, psi, tr, _, model0 = problem
    p_ref, (muX, sdX, muY) = ref.init_vc(X, Y, psi, tr, M, 11, "cpu")
    got = model0.last.params.to_numpy()
    for leaf in ref.LEAVES:
        np.testing.assert_allclose(got[leaf], p_ref[leaf], rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_allclose(model0.muX, muX, rtol=1e-14)
    np.testing.assert_allclose(model0.sdX, sdX, rtol=1e-14)


def test_objective_and_first_steps(problem):
    import gpz_tpu_torch as g
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch import model as gm

    X, Y, psi, tr, va, model0 = problem
    _, stats = ref.init_vc(X, Y, psi, tr, M, 11, "cpu")
    prob = ref.Problem(X, Y, psi, tr, stats, "cpu")
    x0 = torch.as_tensor(ref.flatten(model0.last.params.to_numpy()),
                         dtype=f64)
    f, grad = ref.nlml_grad(x0, prob, M, 5, 1)
    flat, unravel = model0.last.params.flatten()
    Xn = (X - model0.muX) / model0.sdX
    psi_c = datautils.fix_psi(psi, len(X), model0.sdX, True)
    data_tr = gm._make_dataset(Xn, Y[:, None] - model0.muY, psi_c,
                               np.ones(len(X)), tr, f64, "cpu")
    cfg64 = dataclasses.replace(model0.cfg, dtype="float64")
    fp, gp, _ = gm._objective(unravel, data_tr, cfg64, True)(flat)
    assert abs(float(fp) - f) <= 1e-12 * abs(f)
    assert float((gp - grad).abs().max()) <= 1e-10 * float(grad.abs().max())
    xs, fs, _, _ = ref_lbfgs.minimize(
        lambda x: ref.nlml_grad(x, prob, M, 5, 1), x0, 3)
    fit = g.train(model0, X, Y, training=tr, validation=va, psi=psi,
                  max_iter=3, verbose=False)
    np.testing.assert_allclose(fit.fit_info["trace"]["f"], fs, rtol=1e-8)
    np.testing.assert_allclose(ref.flatten(fit.last.params.to_numpy()),
                               xs[-1].numpy(), rtol=1e-6, atol=1e-8)


def test_posterior_and_moments(problem):
    import gpz_tpu_torch as g

    X, Y, psi, tr, va, model0 = problem
    model = g.train(model0, X, Y, training=tr, validation=va, psi=psi,
                    max_iter=30, verbose=False)
    _, stats = ref.init_vc(X, Y, psi, tr, M, 11, "cpu")
    muX, sdX, muY = stats
    prob = ref.Problem(X, Y, psi, tr, stats, "cpu")
    best = {k: torch.as_tensor(v, dtype=f64)
            for k, v in model.best.params.to_numpy().items()}
    w, iSw, prior = ref.posterior(best, prob)
    np.testing.assert_allclose(w.numpy(), model.best.post.w.numpy(),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(prior.numpy(), model.best.priors.numpy(),
                               rtol=1e-6, atol=1e-12)
    Xc, psi_c = data.catalogue(
        {"d": 5}, 200, {"first": 0.25, "last": 0.10, "both": 0.05}, SEED)
    pred = g.predict(Xc, model, psi=psi_c)
    Psi = np.zeros((200, 5, 5))
    Psi[:, range(5), range(5)] = psi_c / sdX ** 2
    out = ref.predict(best, w, iSw, prior, muY,
                      torch.as_tensor((Xc - muX) / sdX),
                      torch.as_tensor(Psi))
    # every mixture is exact in the reference; the program's top-64
    # truncation keeps every one of 12 components
    for key in ("mu", "sigma", "beta_i"):
        np.testing.assert_allclose(getattr(pred, key), out[key],
                                   rtol=1e-7)
    for key in ("nu", "gamma"):
        np.testing.assert_allclose(getattr(pred, key), out[key], rtol=1e-6,
                                   atol=1e-10)
