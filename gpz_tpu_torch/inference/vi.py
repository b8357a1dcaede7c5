"""Mean-field ADVI over GPz hyperparameters (gpz_tpu.inference.vi): the "VI"
half of the beyond-MAP posterior story.

q(theta) = N(mu, diag(exp(2 rho))); the ELBO is maximized with the
reparameterization gradient and Adam, on the same batched log posterior as
HMC: the num_mc Monte-Carlo draws of a step are one batch of the target,
which for the GPz posterior is one launch of each design-matrix kernel at
num_mc * m bases. Returns the variational parameters and a sampler.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# optax.adam's defaults, which gpz_tpu uses (eps_root is 0)
_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def advi_fit(
    logp_fn: Callable,
    x0: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    num_steps: int = 1000,
    num_mc: int = 8,
    lr: float = 1e-2,
    init_log_scale: float = -3.0,
    eps: Optional[torch.Tensor] = None,
):
    """Fit a mean-field Gaussian to exp(logp) by minimizing the negative
    ELBO, -(mean logp(mu + eps * exp(rho)) + sum(rho)), with Adam (optax's
    update, term for term). Returns (mu, log_scale, elbos (num_steps,)).

    The standard normal eps of step t is eps[t] (num_steps, num_mc, p) when
    given, else drawn from `generator`. Runs on x0's device.
    """
    p = x0.shape[0]
    params = [x0.detach().clone(),
              torch.full((p,), init_log_scale, dtype=x0.dtype,
                         device=x0.device)]
    moments = [[torch.zeros_like(t), torch.zeros_like(t)] for t in params]
    elbos = []
    for t in range(num_steps):
        e = eps[t] if eps is not None else torch.randn(
            (num_mc, p), dtype=x0.dtype, device=x0.device,
            generator=generator)
        with torch.enable_grad():
            mu, rho = (a.requires_grad_(True) for a in params)
            xs = mu[None, :] + e * torch.exp(rho)[None, :]
            # Gaussian entropy: sum(rho) + const
            loss = -(torch.mean(logp_fn(xs)) + torch.sum(rho))
            grads = torch.autograd.grad(loss, (mu, rho))
        elbos.append(-loss.detach())
        count = t + 1
        for i, g in enumerate(grads):
            m, v = moments[i]
            m = (1 - _B1) * g + _B1 * m
            v = (1 - _B2) * g**2 + _B2 * v
            moments[i] = [m, v]
            m_hat = m / (1 - _B1**count)
            v_hat = v / (1 - _B2**count)
            params[i] = params[i].detach() + (-lr) * (
                m_hat / (torch.sqrt(v_hat) + _EPS))
    return params[0], params[1], torch.stack(elbos)


def sample_q(mu: torch.Tensor, rho: torch.Tensor, generator: torch.Generator,
             num_samples: int) -> torch.Tensor:
    """Draw from the fitted mean-field posterior."""
    eps = torch.randn((num_samples, mu.shape[0]), dtype=mu.dtype,
                      device=mu.device, generator=generator)
    return mu[None, :] + eps * torch.exp(rho)[None, :]
