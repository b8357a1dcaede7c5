"""The transitions of gpz_tpu_torch.inference against gpz_tpu's in float64 on
the CPU, given the draws JAX made: the momenta, trajectory lengths, direction
bits and uniforms of gpz_tpu's key schedule are replayed into the port's step
functions, which take their draws as arguments. One HMC transition on a small
VC posterior and ADVI steps on the banana given JAX's eps; the NUTS
transitions are in tests/test_torch_nuts_transitions.py.

Tolerances: each position chains a few gradients of float64 formulas summed
in different orders (tests/test_torch_inference.py: values to ~1e-13,
gradients to ~1e-11 of their largest entry); STEP leaves two orders of room.
Depths, divergences and every accept decision must agree exactly.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import torch

from gpz_tpu import inference as jinf
from gpz_tpu.inference import mcmc as jmcmc

from gpz_tpu_torch import inference as tinf
from gpz_tpu_torch.inference import mcmc as tmcmc
from gpz_tpu_torch.inference import vi as tvi

from test_torch_inference import BATCH_CASES, both_sides, points
from test_torch_samplers import banana

STEP = dict(rtol=1e-9, atol=1e-12)
F64 = torch.float64


def small_vc_target():
    """(jax logp, port logp, flat MAP-like point): the VC posterior of
    BATCH_CASES' first case with a hyperprior around its parameters."""
    params, data, cfg, complete = BATCH_CASES["VC-psi-het"]()
    (jnlml, jflat), (tnlml, tflat, _, _, _) = both_sides(params, data, cfg,
                                                        complete)
    jl = jmcmc.gpz_log_posterior(jnlml, n_eff=48.0, k=1, prior_mean=jflat,
                                 prior_scale=3.0)
    tl_ = tinf.gpz_log_posterior(tnlml, n_eff=48.0, k=1, prior_mean=tflat,
                                 prior_scale=3.0)
    return jl, tl_, np.asarray(jflat)


def hmc_draws(keys, p, n_steps):
    """_hmc_step's draws for each chain's key: z, steps, u."""
    z, steps, u = [], [], []
    for key in keys:
        k1, k2, k3 = jax.random.split(key, 3)
        z.append(np.asarray(jax.random.normal(k1, (p,), jnp.float64)))
        steps.append(int(jax.random.randint(k3, (), 1, n_steps + 1)))
        u.append(float(jax.random.uniform(k2)))
    return torch.tensor(np.stack(z)), torch.tensor(steps), torch.tensor(u)


def test_hmc_step_given_jax_draws():
    jl, tl_, flat = small_vc_target()
    C, L, eps = 3, 8, 0.02
    x0 = points(flat, b=C, scale=0.01, seed=17)
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    inv_mass = 1.0 + 0.5 * np.random.default_rng(18).random(flat.shape)
    # one program: the chains' starting logp and the transition
    jx, jlp, jap = jax.jit(jax.vmap(lambda k, x: jmcmc._hmc_step(
        jl, jax.grad(jl), k, x, jl(x), eps, jnp.asarray(inv_mass), L)))(
            keys, jnp.asarray(x0))
    logp, grad = tmcmc._value_and_grad(tl_, torch.tensor(x0))
    x, lp, g, ap = tmcmc._hmc_step(
        tl_, torch.tensor(x0), logp, grad, torch.full((C,), eps, dtype=F64),
        torch.tensor(inv_mass).expand(C, -1), *hmc_draws(keys, len(flat), L))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **STEP)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **STEP)
    np.testing.assert_allclose(ap.numpy(), np.asarray(jap), rtol=1e-8,
                               atol=1e-14)
    assert 0 < ap.min() and ap.max() <= 1
    # the carried gradient is the gradient at the returned position
    _, g_at = tmcmc._value_and_grad(tl_, x)
    assert torch.equal(g, g_at)


def test_advi_steps_given_jax_eps():
    """On the banana (the GPz posterior's ADVI steps are held to JAX on the
    card, chip_smoke.py phase 17): mu, rho and the ELBOs of 5 steps."""
    jl, tl_ = banana(jnp.asarray), banana(torch.tensor)
    flat = np.array([0.3, -0.2])
    steps, mc = 5, 4
    key = jax.random.PRNGKey(5)
    eps = np.stack([np.asarray(jax.random.normal(k, (mc, flat.shape[0]),
                                                 jnp.float64))
                    for k in jax.random.split(key, steps)])
    jmu, jrho, jel = jinf.advi_fit(jl, jnp.asarray(flat), key,
                                   num_steps=steps, num_mc=mc)
    mu, rho, el = tinf.advi_fit(tl_, torch.tensor(flat), num_steps=steps,
                                num_mc=mc, eps=torch.tensor(eps))
    for got, want in ((mu, jmu), (rho, jrho), (el, jel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STEP)
    q = tvi.sample_q(mu, rho, torch.Generator().manual_seed(0), 32)
    assert q.shape == (32, flat.shape[0])
