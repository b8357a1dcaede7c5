"""Hamiltonian Monte Carlo over GPz hyperparameters (gpz_tpu.inference.mcmc):
true posteriors beyond the reference's MAP point estimates.

A target is a function on a batch of chains, x (C, p) -> logp (C,),
differentiable by autograd: the port's form of gpz_tpu's vmapped scalar
function. The GPz target (`gpz_log_posterior` over
objective.nlog_ml_batched) evaluates C chains in one pass, with one launch
of each kernel of the design-matrix pair at (n, C * m) bases.

Design, as gpz_tpu's:
  * the target is the exact log marginal likelihood, un-normalized back to
    log p(y | theta), plus a weak Gaussian hyperprior
  * warmup adapts the step size by Nesterov dual averaging toward a target
    acceptance rate and a diagonal mass matrix by Welford variance estimation
    (two windows), per chain, or with `collective_adapt` one step size and
    one mass matrix shared by all chains from statistics pooled over them
  * the chains move in lockstep: each leapfrog step is one evaluation of the
    whole batch, and a chain that has finished its trajectory is frozen. A
    chain carries the value and gradient at its position, so each new
    position costs one evaluation (gpz_tpu's leapfrog takes the gradient
    twice per step at the same point, and the endpoint's logp once more)

Randomness comes from a torch.Generator on the chains' device (gpz_tpu's
`key`); each step function takes its random draws as arguments. Everything
runs on the device of x0. With `axis_name`, a torch.distributed process
group (gpz_tpu's mesh axis name), the collective warmup pools its statistics
over the chains of every rank of the group as well (parallel.make_mesh's
restart group, for example): each rank runs its own chains from its own
generator, and the ranks meet only at the pooled statistics, at the same
transitions on every rank.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist


def _check_axis(axis_name):
    if axis_name is not None and not isinstance(axis_name,
                                                dist.ProcessGroup):
        raise TypeError(
            f"axis_name takes a torch.distributed process group (for "
            f"example mesh.get_group(RESTART_AXIS) of "
            f"gpz_tpu_torch.parallel), got {axis_name!r}")


def _value_and_grad(logp_fn: Callable, x: torch.Tensor):
    """(logp (C,), grad (C, p)) of a target at x (C, p), by one backward
    pass of logp.sum(): each chain's own gradient, as the chains share
    nothing."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        logp = logp_fn(x)
        grad, = torch.autograd.grad(logp.sum(), x)
    return logp.detach(), grad


def gpz_log_posterior(
    nlml_fn: Callable,
    n_eff: float,
    k: int,
    prior_mean: Optional[torch.Tensor] = None,
    prior_scale: Optional[float] = None,
) -> Callable:
    """Turn the normalized nlogML (mean per sample-output) back into the
    un-normalized log posterior log p(y | theta) + log p(theta).

    nlml_fn maps a batch x (C, p) to (C,), as objective.nlog_ml_batched
    does; so does the result. A weak Gaussian hyperprior (prior_mean,
    prior_scale) is recommended: the marginal likelihood is flat in some
    hyperparameter directions (e.g. ln_tau as v -> 0), so the flat-prior
    posterior is improper and chains drift. Centering the hyperprior on the
    MAP with a generous scale keeps the posterior proper without materially
    moving its bulk.
    """

    def logp(x):
        out = -nlml_fn(x) * (n_eff * k)
        if prior_scale is not None:
            mean = 0.0 if prior_mean is None else prior_mean
            out = out - 0.5 * torch.sum((x - mean) ** 2, dim=-1) / (
                prior_scale**2)
        return out

    return logp


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_avg: torch.Tensor
    h_avg: torch.Tensor
    mu: torch.Tensor
    count: torch.Tensor


def _da_init(eps0: torch.Tensor) -> _DAState:
    return _DAState(
        log_eps=torch.log(eps0),
        log_eps_avg=torch.log(eps0),
        h_avg=torch.zeros_like(eps0),
        mu=torch.log(10.0 * eps0),
        count=torch.zeros_like(eps0),
    )


def _da_update(s: _DAState, accept_prob, target) -> _DAState:
    # Nesterov dual averaging (Hoffman & Gelman 2014, eqs. 6-7)
    t0, gamma, kappa = 10.0, 0.05, 0.75
    count = s.count + 1.0
    eta_h = 1.0 / (count + t0)
    h_avg = (1.0 - eta_h) * s.h_avg + eta_h * (target - accept_prob)
    log_eps = s.mu - torch.sqrt(count) / gamma * h_avg
    eta = count**-kappa
    log_eps_avg = eta * log_eps + (1.0 - eta) * s.log_eps_avg
    return _DAState(log_eps, log_eps_avg, h_avg, s.mu, count)


def _pool_scalar(a: torch.Tensor, axis_name=None) -> torch.Tensor:
    """Mean of a per-chain statistic over all chains (the leading axis), and
    over the ranks of the process group `axis_name` when given: the pooling
    of collective warmup adaptation (gpz_tpu's pmean). Every rank holds as
    many chains, so the mean of the ranks' means is the mean over all."""
    out = torch.mean(a, dim=0)
    if axis_name is not None:
        dist.all_reduce(out, group=axis_name)
        out = out / dist.get_world_size(axis_name)
    return out


def _run_chains(step, logp_fn, x_init, *, collective, num_warmup,
                num_samples, target_accept, eps0, axis_name=None):
    """Two warmup windows, then sampling, for all chains at once.

    step(x, logp, grad, eps (C,), inv_mass (C, p)) -> (x, logp, grad,
    accept_stat (C,), aux), aux a tuple of (C,) per-step values. With
    `collective` the step size and mass matrix are one for all chains,
    adapted from statistics pooled over them; otherwise each chain has its
    own; `axis_name` pools the collective statistics over its ranks too.
    Returns (samples (C, S, p), accept_rate (C,), eps_final, aux stacked
    over the draws, each (S, C)).
    """
    C, p = x_init.shape
    x = x_init
    logp, grad = _value_and_grad(logp_fn, x)
    shape = () if collective else (C,)
    da = _da_init(torch.full(shape, eps0, dtype=x.dtype, device=x.device))
    inv_mass = torch.ones(shape + (p,), dtype=x.dtype, device=x.device)
    pool = ((lambda a: _pool_scalar(a, axis_name)) if collective
            else (lambda a: a))
    half = num_warmup // 2

    def advance(x, logp, grad, eps, inv_mass):
        return step(x, logp, grad, eps.expand(C), inv_mass.expand(C, p))

    # --- window 1: step size, identity mass; per-chain Welford moments ---
    mean, m2 = torch.zeros_like(x), torch.zeros_like(x)
    for i in range(half):
        x, logp, grad, ap, _ = advance(x, logp, grad, torch.exp(da.log_eps),
                                       inv_mass)
        da = _da_update(da, pool(ap), target_accept)
        cnt = i + 1.0
        d0 = x - mean
        mean = mean + d0 / cnt
        m2 = m2 + d0 * (x - mean)
    var = pool(m2 / max(half - 1.0, 1.0))
    if collective:
        # pooled over chains AND iterations (law of total variance)
        mean_all = pool(mean)
        var = var + pool((mean - mean_all[None, :]) ** 2)
    # regularized diagonal mass (Stan's shrinkage toward unit)
    w = half / (half + 5.0)
    inv_mass = torch.clamp(w * var + (1 - w) * 1e-3, min=1e-10)

    # --- window 2: re-adapt the step size under the new metric ---
    da = _da_init(torch.exp(da.log_eps_avg))
    for _ in range(num_warmup - half):
        x, logp, grad, ap, _ = advance(x, logp, grad, torch.exp(da.log_eps),
                                       inv_mass)
        da = _da_update(da, pool(ap), target_accept)
    eps_final = torch.exp(da.log_eps_avg)

    # --- sampling ---
    samples, aps, auxs = [], [], []
    for _ in range(num_samples):
        x, logp, grad, ap, aux = advance(x, logp, grad, eps_final, inv_mass)
        samples.append(x)
        aps.append(ap)
        auxs.append(aux)
    aux = tuple(torch.stack(a) for a in zip(*auxs))
    return (torch.stack(samples, dim=1), torch.stack(aps).mean(0), eps_final,
            aux)


def collective_mcmc(step, logp_fn, x_init, *, num_warmup, num_samples,
                    target_accept, eps0, axis_name=None):
    """Chains-coupled MCMC: one SHARED dual-averaging step size and one
    SHARED diagonal mass matrix, adapted from acceptance/variance statistics
    pooled across every chain of the batch.

    step(x, logp, grad, eps (C,), inv_mass (C, p)) -> (x, logp, grad,
    accept_stat (C,), aux), aux a (possibly empty) tuple of (C,) per-step
    values; the step draws its own randomness.

    `axis_name`: a process group over whose ranks' chains the statistics
    are pooled as well (the same on every rank afterwards).

    Returns (samples (C, S, p), accept_rate (C,), eps_final (), aux_stats)
    with aux_stats a tuple of (C,)-shaped per-chain means of each aux value.
    """
    _check_axis(axis_name)
    samples, accept, eps_final, aux = _run_chains(
        step, logp_fn, x_init, collective=True, num_warmup=num_warmup,
        num_samples=num_samples, target_accept=target_accept, eps0=eps0,
        axis_name=axis_name)
    aux_stats = tuple(a.to(samples.dtype).mean(0) for a in aux)
    return samples, accept, eps_final, aux_stats


def _leapfrog(logp_fn, x, p, grad, eps, inv_mass):
    """One leapfrog step of every chain from x with momentum p and the
    carried gradient at x; eps (C,) is each chain's step (its sign the
    direction). Returns (x, p, grad, logp) at the new position: one
    evaluation of the target."""
    e = eps[:, None]
    p_half = p + 0.5 * e * grad
    x_new = x + e * inv_mass * p_half
    logp_new, grad_new = _value_and_grad(logp_fn, x_new)
    p_new = p_half + 0.5 * e * grad_new
    return x_new, p_new, grad_new, logp_new


def _hmc_step(logp_fn, x, logp, grad, eps, inv_mass, z, steps, u):
    """One HMC transition of every chain, in lockstep.

    x (C, p) with its logp (C,) and grad (C, p); eps (C,); inv_mass (C, p);
    the draws: z (C, p) standard normal, steps (C,) trajectory lengths in
    [1, num_leapfrog] (a jittered length breaks the periodicity that
    fixed-length HMC suffers on near-Gaussian targets), u (C,) uniform in
    [0, 1). Returns (x, logp, grad, accept_prob).

    The batch runs max(steps) leapfrog steps, reading the lengths on the
    host (the transition's one read), one evaluation per step; a chain whose
    count is reached keeps its state. A non-finite log-ratio rejects.
    """
    p0 = z / torch.sqrt(inv_mass)
    x1, p1, g1, l1 = x, p0, grad, logp
    lengths = steps.tolist()
    for i in range(max(lengths)):
        x_new, p_new, g_new, l_new = _leapfrog(logp_fn, x1, p1, g1, eps,
                                               inv_mass)
        if i < min(lengths):
            x1, p1, g1, l1 = x_new, p_new, g_new, l_new
            continue
        live = i < steps
        x1, p1, g1 = (torch.where(live[:, None], a, b) for a, b in (
            (x_new, x1), (p_new, p1), (g_new, g1)))
        l1 = torch.where(live, l_new, l1)
    ke0 = 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    ke1 = 0.5 * torch.sum(p1 * p1 * inv_mass, dim=-1)
    log_ratio = (l1 - ke1) - (logp - ke0)
    log_ratio = torch.where(torch.isfinite(log_ratio), log_ratio, -math.inf)
    accept_prob = torch.clamp(torch.exp(log_ratio), max=1.0)
    accept = u < accept_prob
    return (torch.where(accept[:, None], x1, x),
            torch.where(accept, l1, logp),
            torch.where(accept[:, None], g1, grad),
            accept_prob)


def hmc_sample(
    logp_fn: Callable,
    x0: torch.Tensor,
    generator: torch.Generator,
    *,
    num_warmup: int = 300,
    num_samples: int = 300,
    num_chains: int = 4,
    num_leapfrog: int = 16,
    target_accept: float = 0.8,
    init_jitter: float = 0.01,
    eps0: float = 0.01,
    collective_adapt: bool = False,
    axis_name=None,
):
    """Run `num_chains` HMC chains from jittered copies of x0 (p,), on x0's
    device, drawing from `generator` (on the same device).

    Returns (samples (chains, num_samples, p), info dict): accept_rate
    (chains,) and step_size, (chains,) or, with `collective_adapt=True`, one
    shared () step size: all chains then co-adapt ONE step size and ONE
    diagonal mass matrix from acceptance/variance statistics pooled across
    the chains, and with `axis_name` (a torch.distributed process group)
    across the chains of its ranks too.
    """
    _check_axis(axis_name)
    C, p = num_chains, x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device, generator=generator)
    x_init = x0[None, :] + init_jitter * torch.randn((C, p), **kw)

    def step(x, logp, grad, eps, inv_mass):
        z = torch.randn((C, p), **kw)
        steps = torch.randint(1, num_leapfrog + 1, (C,), device=x0.device,
                              generator=generator)
        u = torch.rand((C,), **kw)
        return (*_hmc_step(logp_fn, x, logp, grad, eps, inv_mass, z, steps,
                           u), ())

    samples, accept, eps_final, _ = _run_chains(
        step, logp_fn, x_init, collective=collective_adapt,
        num_warmup=num_warmup, num_samples=num_samples,
        target_accept=target_accept, eps0=eps0, axis_name=axis_name)
    return samples, {"accept_rate": accept, "step_size": eps_final}


def split_rhat(samples: torch.Tensor) -> torch.Tensor:
    """Split-R-hat convergence diagnostic per dimension.

    samples: (chains, draws, p) -> (p,). Values near 1 indicate convergence.
    """
    c, n, p = samples.shape
    half = n // 2
    halves = torch.cat([samples[:, :half, :], samples[:, half:2 * half, :]],
                       dim=0)                                 # (2c, half, p)
    chain_means = torch.mean(halves, dim=1)                   # (2c, p)
    chain_vars = torch.var(halves, dim=1, correction=1)       # (2c, p)
    W = torch.mean(chain_vars, dim=0)
    B = half * torch.var(chain_means, dim=0, correction=1)
    var_post = (half - 1) / half * W + B / half
    return torch.sqrt(var_post / W)
