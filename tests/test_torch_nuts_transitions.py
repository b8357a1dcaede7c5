"""The NUTS transition of gpz_tpu_torch.inference against gpz_tpu's in
float64 on the CPU, given the draws JAX made (tests/test_torch_transitions.py
replays them the same way for HMC): the banana and the correlated Gaussian at
max_depth 3, and one divergent step. Tolerances as there; depths,
divergences and every merge decision must agree exactly.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.inference import nuts as jnuts

from gpz_tpu_torch.inference import mcmc as tmcmc
from gpz_tpu_torch.inference import nuts as tnuts

from test_torch_samplers import banana, gaussian
from test_torch_transitions import F64, STEP


def nuts_draws(keys, p, max_depth):
    """_nuts_step's draws for each chain's key, in the port's layout."""
    z, go_right, leaf_u, merge_u = [], [], [], []
    for key in keys:
        kp, key = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(kp, (p,), jnp.float64)))
        gr, lu, mu = [], [], []
        for d in range(max_depth):
            key, kd, ks = jax.random.split(key, 3)
            gr.append(bool(jax.random.bernoulli(kd)))
            for _ in range(2**d):
                ks, sub = jax.random.split(ks)
                lu.append(float(jax.random.uniform(sub)))
            key, ka = jax.random.split(key)
            mu.append(float(jax.random.uniform(ka)))
        go_right.append(gr)
        leaf_u.append(lu)
        merge_u.append(mu)
    return (torch.tensor(np.stack(z)), torch.tensor(go_right).T,
            torch.tensor(leaf_u, dtype=F64).T,
            torch.tensor(merge_u, dtype=F64).T)


TARGETS = {"banana": (banana, 2), "gaussian": (gaussian, 3)}
_NUTS_JIT = {}


def jax_nuts(name, depth=3):
    """jit(vmap(_nuts_step)) on a target, eps an argument: compiled once
    per target and reused across step sizes."""
    if name not in _NUTS_JIT:
        logp = TARGETS[name][0](jnp.asarray)
        _NUTS_JIT[name] = jax.jit(jax.vmap(
            lambda k, x, l, eps, im: jnuts._nuts_step(
                logp, jax.grad(logp), k, x, l, eps, im, depth),
            in_axes=(0, 0, 0, None, None)))
    return _NUTS_JIT[name]


@pytest.mark.parametrize("name,eps", [("banana", 0.45), ("gaussian", 0.35),
                                      ("banana", 9.0)],
                         ids=["banana", "gaussian", "banana-divergent"])
def test_nuts_step_given_jax_draws(name, eps):
    make, p = TARGETS[name]
    C, depth = 6, 3
    x0 = np.random.default_rng(19).standard_normal((C, p))
    inv_mass = np.linspace(0.7, 1.3, p)
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    jlp0 = jax.vmap(make(jnp.asarray))(jnp.asarray(x0))
    jx, jlp, jacc, jdepth, jdiv = jax_nuts(name)(
        keys, jnp.asarray(x0), jlp0, eps, jnp.asarray(inv_mass))
    tlogp = make(torch.tensor)
    lp0, g0 = tmcmc._value_and_grad(tlogp, torch.tensor(x0))
    x, lp, g, acc, dep, div = tnuts._nuts_step(
        tlogp, torch.tensor(x0), lp0, g0, torch.full((C,), eps, dtype=F64),
        torch.tensor(inv_mass).expand(C, -1), *nuts_draws(keys, p, depth),
        depth)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), **STEP)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), **STEP)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-9,
                               atol=1e-14)
    np.testing.assert_array_equal(dep.numpy(), np.asarray(jdepth))
    np.testing.assert_array_equal(div.numpy(), np.asarray(jdiv))
    _, g_at = tmcmc._value_and_grad(tlogp, x)
    torch.testing.assert_close(g, g_at, rtol=0, atol=0)
    if eps > 1:
        assert div.all()        # every chain diverged at this step size
    else:
        assert not div.any() and dep.max() >= 2
