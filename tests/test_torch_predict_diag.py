"""gpz_tpu_torch.predict.predict_moments_diag against gpz_tpu's, called
directly (not through gpz_tpu's jitted model.predict), on the CPU in
float64: the four diagonal methods in the four regimes clean / noisy /
missing / noisy+missing, and model.predict on rows of mixed patterns.

Tolerances: both sides run the same float64 chain on a well-conditioned random
model and differ in summation order only: 1e-10 relative, 1e-12 absolute (nu
and gamma are differences of sums of order 1).
"""

import importlib

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax.numpy as jnp
import pytest
import torch

import gpz_tpu
from gpz_tpu.config import ModelConfig as JaxConfig
from gpz_tpu.objective import Posterior as JaxPosterior
from gpz_tpu.params import GPzParams as JaxParams
from gpz_tpu.model import GPzModel as JaxModel, ParamSet as JaxParamSet

import gpz_tpu_torch
from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.model import GPzModel, ParamSet
from gpz_tpu_torch.objective import Posterior
from gpz_tpu_torch.params import GPzParams

jpredict = importlib.import_module("gpz_tpu.predict")
tpredict = importlib.import_module("gpz_tpu_torch.predict")

F64 = dict(rtol=1e-10, atol=1e-12)
M, D, N = 6, 3, 20
REGIMES = {
    "clean": (False, [True, True, True]),
    "noisy": (True, [True, True, True]),
    "missing": (False, [True, False, True]),
    "noisy-missing": (True, [False, True, False]),
}


def small_model(method, seed=0, k=1):
    """Arrays of a random diagonal-family model with uneven priors."""
    rng = np.random.default_rng(seed)
    cfg = dict(m=M, d=D, k=k, method=method, dtype="float64")
    arrays = {
        "P": rng.standard_normal((M, D)),
        "gamma": 0.5 + rng.random(JaxConfig(**cfg).gamma_shape),
        "ln_alpha": rng.standard_normal((M, k)),
        "b": rng.standard_normal(k) * 0.1 - 3.0,
        "v": rng.standard_normal((M, k)) * 0.1,
        "ln_tau": np.zeros((M, k)),
    }
    Q = rng.standard_normal((k, M, M))
    post = {"w": rng.standard_normal((M, k)),
            "iSigma_w": Q @ np.swapaxes(Q, 1, 2) / M + 0.1 * np.eye(M),
            "logdet": np.zeros(k)}
    priors = rng.dirichlet(np.ones(M))
    return arrays, post, priors, cfg


def both_sides(arrays, post, priors, cfg):
    jax_side = (JaxParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                JaxPosterior(**{k: jnp.asarray(v) for k, v in post.items()}),
                jnp.asarray(priors), JaxConfig(**cfg))
    port_side = (GPzParams.from_numpy(arrays, "cpu", torch.float64),
                 Posterior(**{k: torch.from_numpy(v)
                              for k, v in post.items()}),
                 torch.from_numpy(priors), ModelConfig(**cfg))
    return jax_side, port_side


def rows(seed, with_psi, pattern):
    rng = np.random.default_rng(seed)
    mask = np.asarray(pattern, bool)
    X = rng.standard_normal((N, D)) * mask[None, :]
    psi = (0.05 + 0.2 * rng.random((N, D))) if with_psi else np.zeros((N, D))
    return X, psi, mask


def assert_outputs(got, want, **tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or F64))


def run_both(model, X, psi, mask):
    (jp, jpost, jpri, jcfg), (tp, tpost, tpri, tcfg) = both_sides(*model)
    complete = bool(mask.all())
    want = jpredict.predict_moments_diag(
        jp, jpost, jpri, jcfg, jnp.asarray(X), jnp.asarray(mask),
        jnp.asarray(psi), complete)
    got = tpredict.predict_moments_diag(
        tp, tpost, tpri, tcfg, torch.from_numpy(X), torch.from_numpy(mask),
        torch.from_numpy(psi), complete)
    return got, want


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("method", ["GL", "VL", "GD", "VD"])
def test_predict_moments_diag_matches_jax(method, regime):
    with_psi, pattern = REGIMES[regime]
    got, want = run_both(small_model(method, 1), *rows(2, with_psi, pattern))
    assert got[0].shape == (N, 1) and got[4].shape == (N, M)
    assert_outputs(got, want)


def test_two_outputs_and_a_homoscedastic_model():
    arrays, post, priors, cfg = small_model("VD", 3, k=2)
    del arrays["v"], arrays["ln_tau"]
    cfg["heteroscedastic"] = False
    got, want = run_both((arrays, post, priors, cfg),
                         *rows(4, True, [True, False, True]))
    assert got[1].shape == (N, 2)
    assert_outputs(got, want)


@pytest.mark.parametrize("regime", ["noisy", "noisy-missing"])
def test_many_blocks_give_one_blocks_result(regime, monkeypatch):
    """budget=1500 f32 elements gives B=2 at n=20, m=6, d=3 in float64: three
    pair blocks, and with missing values three mixture chunks in each. The
    blocks add the same terms in another order."""
    with_psi, pattern = REGIMES[regime]
    model, data = small_model("VD", 5), rows(6, with_psi, pattern)
    one, want = run_both(model, *data)
    monkeypatch.setattr(tpredict, "PAIR_BUDGET", 1500)
    assert tpredict._block_size(N, M, D, itemsize=8) == 2
    many, _ = run_both(model, *data)
    assert_outputs(many, one, rtol=1e-12, atol=1e-14)
    # and JAX with the same blocks
    monkeypatch.setattr(jpredict, "PAIR_BUDGET", 1500)
    assert_outputs(many, run_both(model, *data)[1])


@pytest.mark.parametrize("complete", [True, False],
                         ids=["complete", "mixture"])
def test_no_noise_and_nothing_missing_is_predict_clean(complete):
    """psi == 0 and an all-True mask reduce the moment matching to the clean
    prediction, through the GMM-conditioning branch too (an empty unobserved
    block: every conditional density is 1, the responsibilities sum to 1).
    gamma and V ln S are differences of equal sums: 1e-12 absolute."""
    arrays, post, priors, cfg = small_model("VD", 7)
    _, (tp, tpost, tpri, tcfg) = both_sides(arrays, post, priors, cfg)
    X, psi, mask = rows(8, False, [True, True, True])
    Xt = torch.from_numpy(X)
    mu, nu, beta_i, gamma, PHI = tpredict.predict_moments_diag(
        tp, tpost, tpri, tcfg, Xt, torch.from_numpy(mask),
        torch.from_numpy(psi), complete)
    cmu, cnu, cbeta, cgamma, cPHI = tpredict.predict_clean(
        tp, tpost, tcfg, Xt, torch.ones_like(Xt, dtype=torch.bool))
    tol = dict(rtol=1e-10, atol=1e-12)
    torch.testing.assert_close(PHI, cPHI, **tol)
    torch.testing.assert_close(mu, cmu, **tol)
    torch.testing.assert_close(nu, cnu, **tol)
    torch.testing.assert_close(beta_i, cbeta, **tol)
    torch.testing.assert_close(gamma, cgamma, **tol)


def as_models(arrays, post, priors, cfg, muX, sdX, muY):
    """The same arrays as a gpz_tpu model and as a port model."""
    (jp, jpost, jpri, jcfg), (tp, tpost, tpri, tcfg) = both_sides(
        arrays, post, priors, cfg)
    jset = JaxParamSet(params=jp, post=jpost, priors=jpri)
    tset = ParamSet(params=tp, post=tpost, priors=tpri)
    return (JaxModel(cfg=jcfg, muX=muX, sdX=sdX, muY=muY, last=jset,
                     best=jset),
            GPzModel(cfg=tcfg, muX=muX, sdX=sdX, muY=muY, last=tset,
                     best=tset))


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
def test_model_predict_groups_patterns_like_jax(with_psi):
    """model.predict on rows of five patterns, a row with nothing observed
    among them: same grouping, same outputs, every row filled."""
    rng = np.random.default_rng(9)
    jm, tm = as_models(*small_model("VD", 10), muX=rng.standard_normal(D),
                       sdX=0.5 + rng.random(D), muY=np.array([0.3]))
    X = rng.standard_normal((30, D)) * 1.5
    X[::3, 1] = np.nan
    X[1::4, 0] = np.nan
    X[5::7, 2] = np.nan
    X[7] = np.nan
    psi = 0.05 + 0.1 * rng.random((30, D)) if with_psi else None
    want = gpz_tpu.predict(X, jm, psi=psi)
    got = gpz_tpu_torch.predict(X, tm, psi=psi)
    for key in ("mu", "sigma", "nu", "beta_i", "gamma", "phi"):
        np.testing.assert_allclose(getattr(got, key),
                                   np.asarray(getattr(want, key)),
                                   err_msg=key, **F64)
    assert np.isfinite(got.sigma).all() and (got.sigma > 0).all()
