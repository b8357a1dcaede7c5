"""gpz_tpu_torch.inference.api against gpz_tpu.inference.api in float64 on the
CPU: the target sample_posterior samples (posterior_target) against the one
gpz_tpu builds, predictive_draws on the same samples, and sample_posterior
end to end. Tolerances as in tests/test_torch_inference.py.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest

import gpz_tpu
from gpz_tpu import objective as jobj
from gpz_tpu import inference as jinf
from gpz_tpu.inference import mcmc as jmcmc

import gpz_tpu_torch
from gpz_tpu_torch import inference as tinf

from test_torch_inference import (
    F64, VALUE, assert_grad_close, points, torch_value_and_grad,
)


TARGET_CASES = {
    # complete rows, psi (n, d) taken as full, omega and training rows
    "VC-psi-complete": ("VC", False),
    # NaN rows: the masked pass
    "VD-psi-missing": ("VD", True),
}


@pytest.mark.parametrize("case", list(TARGET_CASES))
def test_posterior_target_against_gpz_tpu(case):
    """The target sample_posterior samples (posterior_target) against the
    one gpz_tpu's sample_posterior builds (gpz_tpu/inference/api.py:46-74,
    put together here from the same parts): the normalization, psi, omega
    and the training rows, the complete-rows test, n_eff and the
    hyperprior's centre, in value and gradient at 3 points."""
    from gpz_tpu import datautils as jdu
    from gpz_tpu.model import _make_dataset

    method, missing = TARGET_CASES[case]
    rng = np.random.default_rng(23)
    n, d = 40, 2
    X = rng.standard_normal((n, d))
    Y = np.sin(X[:, 0]) + 0.2 * X[:, 1] + 0.1 * rng.standard_normal(n)
    psi = 0.05 + 0.02 * rng.random((n, d))
    if missing:
        X[rng.random(n) < 0.2, 1] = np.nan
    tr = rng.random(n) < 0.75
    omega = 0.5 + rng.random(n)
    kw = dict(psi=psi, training=tr, heteroscedastic=True, seed=0,
              dtype="float64")
    jm = gpz_tpu.init(X, Y, method, 4, **kw)
    tm = gpz_tpu_torch.init(X, Y, method, 4, device="cpu", **kw)

    logp, flat, unravel, data, complete = tinf.api.posterior_target(
        tm, X, Y, omega=omega, training=tr, psi=psi, prior_scale=2.0)
    jflat, junravel = ravel_pytree(jm.best.params)
    jd = _make_dataset((X - jm.muX[None]) / jm.sdX[None],
                       Y[:, None] - jm.muY[None],
                       jdu.fix_psi(psi, n, jm.sdX, jm.cfg.full_cov), omega,
                       tr, jnp.float64)
    jcomplete = bool(np.all(jd.mask))
    jlogp = jmcmc.gpz_log_posterior(
        lambda x: jobj.nlog_ml(junravel(x), jd, jm.cfg,
                               complete=jcomplete)[0],
        n_eff=float(int(np.sum(tr))), k=jm.cfg.k, prior_mean=jflat,
        prior_scale=2.0)
    assert complete == jcomplete == (not missing)
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), rtol=1e-12)
    X3 = points(jflat, scale=0.02, seed=24)
    jf, jg = jax.jit(jax.vmap(jax.value_and_grad(jlogp)))(
        jnp.asarray(X3))
    f, g = torch_value_and_grad(logp, X3)
    np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
    assert_grad_close(g, jg)


def small_models(method="VL", m=5):
    """The same model in both packages: init from one seed, float64."""
    rng = np.random.default_rng(20)
    X = rng.standard_normal((60, 2))
    Y = np.sin(2 * X[:, 0]) + 0.3 * X[:, 1] + 0.1 * rng.standard_normal(60)
    jm = gpz_tpu.init(X, Y, method, m, heteroscedastic=True, seed=0,
                      dtype="float64")
    tm = gpz_tpu_torch.init(X, Y, method, m, heteroscedastic=True, seed=0,
                            dtype="float64", device="cpu")
    return X, Y, jm, tm


def test_predictive_draws_on_the_same_samples():
    from gpz_tpu.model import _make_dataset

    X, Y, jm, tm = small_models()
    _, tinfo = tinf.sample_posterior(tm, X, Y, num_warmup=2, num_samples=4,
                                     num_chains=2)
    flat, junravel = ravel_pytree(jm.best.params)
    np.testing.assert_allclose(tm.best.params.flatten()[0].numpy(),
                               np.asarray(flat), rtol=1e-12)
    Xn = (X - jm.muX[None]) / jm.sdX[None]
    Yc = Y[:, None] - jm.muY[None]
    jinfo = {"unravel": junravel, "complete": True,
             "data": _make_dataset(Xn, Yc, None, np.ones(len(Y)),
                                   np.ones(len(Y), bool), jnp.float64)}
    samples = points(flat, b=4, scale=0.02, seed=21).reshape(2, 2, -1)
    Xs = np.linspace(-2, 2, 15)[:, None] * [1.0, -0.5]
    jmus, jmean, jstd = jinf.predictive_draws(jm, jnp.asarray(samples), jinfo,
                                              Xs, thin=1)
    mus, mean, std = tinf.predictive_draws(tm, samples, tinfo, Xs, thin=1)
    assert mus.shape == (4, 15, 1)
    for got, want in ((mus, jmus), (mean, jmean), (std, jstd)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9,
                                   atol=1e-12)


def test_sample_posterior_api():
    """End to end as tests/test_inference.py::test_sample_posterior_api:
    train a small model, sample the hyperparameter posterior, produce
    posterior-predictive draws."""
    rng = np.random.default_rng(0)
    n = 200
    X = rng.standard_normal((n, 1))
    Y = np.sin(2 * X[:, 0]) + 0.1 * rng.standard_normal(n)
    tr = np.ones(n, bool)
    model = gpz_tpu_torch.init(X, Y, "VL", 5, heteroscedastic=False,
                               training=tr, seed=0, dtype="float64",
                               device="cpu")
    model = gpz_tpu_torch.train(model, X, Y, training=tr, max_iter=40,
                                verbose=False)
    samples, info = tinf.sample_posterior(
        model, X, Y, training=tr, num_warmup=40, num_samples=40,
        num_chains=2, seed=0)
    assert samples.shape[:2] == (2, 40) and samples.dtype == F64
    assert float(info["accept_rate"].mean()) > 0.4
    assert info["rhat"].shape == (samples.shape[-1],)
    Xs = np.linspace(-2, 2, 20)[:, None]
    mus, mean_mu, std_mu = tinf.predictive_draws(model, samples, info, Xs,
                                                 thin=10)
    assert mus.shape == (8, 20, 1) and mean_mu.shape == (20, 1)
    assert np.all(np.isfinite(mean_mu)) and np.all(std_mu >= 0)
    # the posterior-predictive mean tracks the MAP prediction
    map_mu = gpz_tpu_torch.predict(Xs, model).mu
    assert np.max(np.abs(mean_mu - map_mu)) < 1.0
    with pytest.raises(ValueError, match="sampler"):
        tinf.sample_posterior(model, X, Y, sampler="mala")
