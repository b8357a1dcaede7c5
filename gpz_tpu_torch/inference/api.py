"""User-facing posterior inference over a trained GPz model
(gpz_tpu.inference.api).

Wraps the batched HMC/NUTS machinery with the model's preprocessing:
    samples, info = sample_posterior(model, X, Y, training=tr, psi=psi)
    mus, mean_mu, std_mu = predictive_draws(model, samples, info, X_test)
giving hyperparameter posteriors (beyond the reference's MAP point estimate)
and posterior-predictive means with between-sample spread. Both run on the
device that holds the model's parameters, in float64 whatever cfg.dtype is,
as model.train does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gpz_tpu_torch import datautils
from gpz_tpu_torch import model as model_mod
from gpz_tpu_torch.objective import nlog_ml_batched, posterior
from gpz_tpu_torch.phi import design_matrix
from gpz_tpu_torch.inference.mcmc import (
    gpz_log_posterior, hmc_sample, split_rhat,
)
from gpz_tpu_torch.inference.nuts import nuts_sample


def sample_posterior(
    model,
    X,
    Y,
    *,
    omega=None,
    training=None,
    psi=None,
    num_warmup: int = 300,
    num_samples: int = 300,
    num_chains: int = 4,
    prior_scale: float = 3.0,
    seed: int = 0,
    sampler: str = "hmc",
    max_depth: int = 8,
):
    """HMC or NUTS over hyperparameters, from the trained MAP (model.best).

    Returns (samples (chains, draws, p), info) where info includes
    acceptance rates, step sizes, split-Rhat, and the unravel function to map
    flat draws back to GPzParams. `prior_scale` sets the weak Gaussian
    hyperprior around the MAP that keeps the posterior proper (see
    gpz_log_posterior). `seed` seeds a torch.Generator on the model's
    device; `max_depth` is NUTS's tree depth (gpz_tpu's default, 8, which
    its sample_posterior always uses).

    Every evaluation of the log posterior is one objective.nlog_ml_batched
    call for all chains: on complete rows with full psi, one launch of each
    design-matrix kernel at (n, num_chains * m) bases.
    """
    if sampler not in ("hmc", "nuts"):
        raise ValueError(f"sampler must be 'hmc' or 'nuts', got {sampler!r}")
    logp, flat_map, unravel, data, complete = posterior_target(
        model, X, Y, omega=omega, training=training, psi=psi,
        prior_scale=prior_scale)
    generator = torch.Generator(device=flat_map.device)
    generator.manual_seed(seed)
    run = dict(num_warmup=num_warmup, num_samples=num_samples,
               num_chains=num_chains)
    if sampler == "nuts":
        samples, info = nuts_sample(logp, flat_map, generator,
                                    max_depth=max_depth, **run)
    else:
        samples, info = hmc_sample(logp, flat_map, generator, **run)
    info = dict(info)
    info["rhat"] = split_rhat(samples)
    info["unravel"] = unravel
    info["data"] = data
    info["complete"] = complete
    return samples, info


def posterior_target(model, X, Y, *, omega=None, training=None, psi=None,
                     prior_scale: float = 3.0):
    """sample_posterior's target: (logp, flat_map, unravel, data,
    complete). logp maps a batch of flat parameter vectors (C, p) to their
    (C,) log posterior through one nlog_ml_batched call, on the model's
    preprocessing of (X, Y, psi) in float64 on its device; the hyperprior is
    centred on model.best's flat parameters, with n_eff the training rows."""
    cfg = dataclasses.replace(model.cfg, dtype="float64")
    device = model.best.params.P.device
    Xa = np.asarray(X, dtype=np.float64)
    Ya = np.asarray(Y, dtype=np.float64)
    if Ya.ndim == 1:
        Ya = Ya[:, None]
    n = Xa.shape[0]
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)
    Xn = (Xa - model.muX[None, :]) / model.sdX[None, :]
    Yc = Ya - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, n, model.sdX, cfg.full_cov)
    data = model_mod._make_dataset(Xn, Yc, psi_c, omega, training,
                                   torch.float64, device)
    complete = model_mod._complete(data)

    flat_map, unravel = model.best.params.astype(torch.float64).flatten()

    def nlml_flat(x):
        return nlog_ml_batched(x, unravel, data, cfg, complete)

    logp = gpz_log_posterior(
        nlml_flat,
        n_eff=float(int(np.sum(training))),
        k=cfg.k,
        prior_mean=flat_map,
        prior_scale=prior_scale,
    )
    return logp, flat_map, unravel, data, complete


def predictive_draws(
    model,
    samples,
    info,
    X_new,
    *,
    psi_new=None,
    thin: int = 10,
):
    """Posterior-predictive means over thinned hyperparameter draws.

    Returns (mus (S, n_new, k), mean_mu, std_mu) as host arrays: the
    epistemic spread of the predictive mean induced by hyperparameter
    uncertainty, information the MAP-only reference cannot provide. Each draw
    is one posterior solve on the training rows (info["data"]) and one
    design matrix of X_new, whose rows are taken as complete.
    """
    cfg = dataclasses.replace(model.cfg, dtype="float64")
    unravel = info["unravel"]
    data = info["data"]
    complete = info["complete"]
    device = data.X.device
    flat = torch.as_tensor(samples, dtype=torch.float64, device=device)
    flat = flat.reshape(-1, flat.shape[-1])[::thin]

    Xn = (np.asarray(X_new, dtype=np.float64) - model.muX[None, :]) / (
        model.sdX[None, :]
    )
    n_new = Xn.shape[0]
    psi_c = datautils.fix_psi(psi_new, n_new, model.sdX, cfg.full_cov)
    Xt = torch.as_tensor(Xn, dtype=torch.float64, device=device)
    mask = torch.ones(Xt.shape, dtype=torch.bool, device=device)
    psit = None if psi_c is None else torch.as_tensor(
        psi_c, dtype=torch.float64, device=device)

    def one(flat_theta):
        params = unravel(flat_theta)
        post = posterior(params, data, cfg, complete=complete)
        PHI, _, _ = design_matrix(params, cfg, Xt, mask, psit, complete=True)
        return PHI @ post.w

    with torch.no_grad():
        mus = torch.stack([one(f) for f in flat])
    mus = mus.cpu().numpy() + model.muY[None, None, :]
    return mus, mus.mean(axis=0), mus.std(axis=0)
