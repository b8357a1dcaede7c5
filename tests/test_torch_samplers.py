"""gpz_tpu_torch.inference's samplers alone, on the targets of
tests/test_inference.py, test_nuts.py and test_collective_adapt.py (the
cases that run in one process), seeded so that each run draws the same
chains. NUTS on the anisotropic scales and the banana is in
tests/test_torch_nuts_samplers.py.

Sizes are smaller than gpz_tpu's, and each tolerance is stated against the
exact moments: a bound of about four Monte-Carlo standard errors of the
estimate at these sizes (sd / sqrt(effective draws), the effective draws a
fraction of the draws for correlated chains), so a correct sampler passes
for any seed and a wrong mass matrix, step size or acceptance rule does not.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu_torch
from gpz_tpu_torch import inference as tinf
from gpz_tpu_torch.inference import mcmc as tmcmc
from gpz_tpu_torch.objective import nlog_ml_batched
from gpz_tpu_torch.optim import minimize

F64 = torch.float64

# correlated 3-d Gaussian (tests/test_inference.py, test_nuts.py)
COV = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 0.5]])
MEAN = np.array([1.0, -2.0, 0.5])
# anisotropic diagonal Gaussian: a 400x spread of scales
SCALES = np.array([0.05, 1.0, 20.0])


def gaussian(asarray):
    """logp of the correlated Gaussian for arrays made by `asarray`
    (torch.tensor or jax.numpy.asarray): a batch (C, 3) or one point."""
    mu, prec = asarray(MEAN), asarray(np.linalg.inv(COV))
    return lambda x: -0.5 * (((x - mu) @ prec) * (x - mu)).sum(-1)


def anisotropic(asarray):
    sd = asarray(SCALES)
    return lambda x: -0.5 * ((x / sd) ** 2).sum(-1)


def banana(asarray):
    """x0 ~ N(0, 4), x1 | x0 ~ N(0.3 x0^2, 1): E[x1] = 1.2, sd = [2.0,
    ~1.97] (tests/test_nuts.py)."""
    return lambda x: -0.5 * (x[..., 0] ** 2 / 4.0
                             + (x[..., 1] - 0.3 * x[..., 0] ** 2) ** 2)


def run(sampler, logp, dim, seed, **kw):
    gen = torch.Generator().manual_seed(seed)
    samples, info = getattr(tinf, sampler)(logp, torch.zeros(dim, dtype=F64),
                                           gen, **kw)
    assert samples.dtype == F64 and torch.isfinite(samples).all()
    return samples, info


@pytest.mark.parametrize("collective", [False, True],
                         ids=["per-chain", "collective"])
@pytest.mark.parametrize("sampler,kw", [
    ("hmc_sample", dict(num_leapfrog=12)),
    ("nuts_sample", dict(max_depth=6)),
], ids=["hmc", "nuts"])
def test_correlated_gaussian(sampler, kw, collective):
    """4 chains x 250 draws after 150 warmup: means within 0.3 (sd <= 1.41,
    ~400 effective draws: se ~0.07), covariances within 0.5 (se of a
    variance of 2 ~0.14), split-Rhat below 1.1."""
    samples, info = run(sampler, gaussian(torch.tensor), 3, seed=0,
                        num_warmup=150, num_samples=250, num_chains=4,
                        collective_adapt=collective, **kw)
    flat = samples.reshape(-1, 3).numpy()
    np.testing.assert_allclose(flat.mean(0), MEAN, atol=0.3)
    np.testing.assert_allclose(np.cov(flat.T), COV, atol=0.5)
    assert float(info["accept_rate"].mean()) > 0.6
    assert (tinf.split_rhat(samples) < 1.1).all()
    assert info["step_size"].shape == (() if collective else (4,))
    if sampler == "nuts_sample":
        assert float(info["mean_tree_depth"].mean()) > 1.5
        assert float(info["divergences"].sum()) == 0


def test_advi_recovers_diagonal_gaussian():
    """1,000 Adam steps of 8 draws at lr 5e-2: mean within 0.15 and scale
    within 25% (the fit ends on a noisy gradient of sd ~lr)."""
    mu, sd = torch.tensor([2.0, -1.0], dtype=F64), torch.tensor(
        [0.5, 1.5], dtype=F64)
    m, rho, elbos = tinf.advi_fit(
        lambda x: -0.5 * torch.sum((x - mu) ** 2 / sd**2, dim=-1),
        torch.zeros(2, dtype=F64), torch.Generator().manual_seed(1),
        num_steps=1000, lr=5e-2)
    np.testing.assert_allclose(m.numpy(), mu.numpy(), atol=0.15)
    np.testing.assert_allclose(rho.exp().numpy(), sd.numpy(), rtol=0.25)
    assert float(elbos[-100:].mean()) > float(elbos[:100].mean())


def test_hmc_on_gpz_posterior():
    """The posterior over GPz hyperparameters concentrates near the L-BFGS
    MAP (tests/test_inference.py::test_hmc_on_gpz_posterior): structured
    data, a homoscedastic VL model, a weak hyperprior; draws stay within
    0.5 nats per sample of the MAP."""
    rng = np.random.default_rng(0)
    n, d = 120, 2
    X = rng.standard_normal((n, d))
    Y = np.sin(X[:, 0]) + 0.5 * X[:, 1] + 0.2 * rng.standard_normal(n)
    model = gpz_tpu_torch.init(X, Y, "VL", 3, heteroscedastic=False,
                               normalize=False, seed=0, dtype="float64",
                               device="cpu")
    flat0, unravel = model.last.params.flatten()
    from gpz_tpu_torch.model import _make_dataset

    data = _make_dataset(X, Y[:, None], None, np.ones(n), np.ones(n, bool),
                         F64, "cpu")
    cfg = model.cfg

    def nlml(x):
        return nlog_ml_batched(x, unravel, data, cfg, True)

    def fun(x):
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            f = nlml(x[None])[0]
            g, = torch.autograd.grad(f, x)
        return f.detach(), g, ()

    res = minimize(fun, flat0, max_iter=150)
    logp = tinf.gpz_log_posterior(nlml, n_eff=float(n), k=1,
                                  prior_mean=res.x, prior_scale=2.0)
    samples, info = tinf.hmc_sample(
        logp, res.x, torch.Generator().manual_seed(2), num_warmup=80,
        num_samples=80, num_chains=2, num_leapfrog=8, init_jitter=0.001)
    nlmls = nlml(samples.reshape(-1, samples.shape[-1])[::10]).numpy()
    assert np.isfinite(nlmls).all()
    assert np.median(nlmls) < float(res.f) + 0.5
    assert float(info["accept_rate"].mean()) > 0.4


def test_carried_gradient_and_frozen_chains():
    """An HMC transition with trajectories of different lengths: a chain
    whose count is reached keeps its state bit for bit while the others go
    on, and the carried gradient is the gradient at the position
    returned."""
    logp = gaussian(torch.tensor)
    x = torch.tensor([[0.3, -1.0, 0.2], [1.0, -2.5, 0.4]], dtype=F64)
    lp, g = tmcmc._value_and_grad(logp, x)
    eps = torch.full((2,), 0.2, dtype=F64)
    z = torch.tensor([[0.5, -0.2, 0.1], [-0.3, 0.4, 0.9]], dtype=F64)
    u = torch.zeros(2, dtype=F64)            # accept whatever is finite
    ones = torch.ones(2, 3, dtype=F64)
    both = tmcmc._hmc_step(logp, x, lp, g, eps, ones, z, torch.tensor([1, 5]),
                           u)
    short = tmcmc._hmc_step(logp, x, lp, g, eps, ones, z, torch.tensor([1, 1]),
                            u)
    for a, b in zip(both, short):
        assert torch.equal(a[0], b[0]) and not torch.equal(a[1], b[1])
    assert torch.equal(both[2], tmcmc._value_and_grad(logp, both[0])[1])
    # a non-finite log-ratio rejects
    def bad(x):
        return torch.where(x[:, 0] > 0.5, torch.nan, 0.0) + logp(x)

    x2, lp2, _, ap = tmcmc._hmc_step(bad, x, lp, g, eps, ones, z,
                                     torch.tensor([3, 3]), u)
    assert float(ap[1]) == 0.0 and torch.equal(x2[1], x[1])
