"""gpz_tpu_torch.inference and objective.nlog_ml_batched against
gpz_tpu.inference in float64 on the CPU: the batched evaluation against
jax.vmap of nlog_ml and against single calls, the per-set jitter ladder,
gpz_log_posterior, dual averaging, split-Rhat, the pooled warmup statistics
and the parallel slice's axis_name. The api (sample_posterior's target,
predictive_draws, sample_posterior end to end) is in
tests/test_torch_inference_api.py, the transitions in
tests/test_torch_transitions.py and tests/test_torch_nuts_transitions.py.

Tolerances: the two packages compute the same float64 formulas in different
summation orders, so values agree to ~1e-13 relative and gradients (through
the m x m solve) to ~1e-11 of their largest entry; VALUE and GRAD leave two
orders of room.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest
import torch

from gpz_tpu import objective as jobj
from gpz_tpu import inference as jinf
from gpz_tpu.inference import mcmc as jmcmc

from gpz_tpu_torch import inference as tinf
from gpz_tpu_torch import linalg as tl
from gpz_tpu_torch import objective as tobj
from gpz_tpu_torch.inference import mcmc as tmcmc

from test_torch_objective import (
    jax_side, make_case, make_matrix_case, torch_side,
)

VALUE = dict(rtol=1e-10, atol=0.0)
GRAD_RTOL = 1e-10          # of the gradient's largest entry
F64 = torch.float64

# the batched evaluation: VC with psi (n, d, d) at n=48, m=6, d=3; VL
# homoscedastic without psi; VD with NaNs and psi (n, d) (n=25, m=4, d=3)
BATCH_CASES = {
    "VC-psi-het": lambda: (*make_case("VC", True, True, 1), True),
    "VL-nopsi-hom": lambda: (*make_matrix_case("VL", False, False, False)[:3],
                             True),
    "VD-psi-missing-het": lambda: (
        *make_matrix_case("VD", True, True, True)[:3], False),
}


_VC = {}


def vc_case():
    """BATCH_CASES' VC case in both packages with jit(vmap(value_and_grad))
    of JAX's nlml, compiled once for the tests that share it."""
    if not _VC:
        (jnlml, jflat), port = both_sides(*BATCH_CASES["VC-psi-het"]())
        _VC.update(jflat=jflat, port=port, jax_vg=jax.jit(jax.vmap(
            jax.value_and_grad(jnlml))), jnlml=jnlml)
    return _VC


def assert_grad_close(got, want, rtol=GRAD_RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def both_sides(params, data, cfg, complete):
    """((jax nlml_flat, flat), (port batched nlml, flat tensor, unravel))."""
    jp, jd, jcfg = jax_side(params, data, cfg)
    jflat, junravel = ravel_pytree(jp)
    tp, td, tcfg = torch_side(params, data, cfg)
    tflat, unravel = tp.flatten()

    def jnlml(x):
        return jobj.nlog_ml(junravel(x), jd, jcfg, complete=complete)[0]

    def tnlml(x):
        return tobj.nlog_ml_batched(x, unravel, td, tcfg, complete)

    return (jnlml, jflat), (tnlml, tflat, unravel, td, tcfg)


def points(flat, b=3, scale=0.05, seed=1):
    rng = np.random.default_rng(seed)
    return np.asarray(flat)[None] + scale * rng.standard_normal(
        (b, flat.shape[0]))


def torch_value_and_grad(fn, X):
    X = torch.as_tensor(X, dtype=F64).clone().requires_grad_(True)
    out = fn(X)
    grad, = torch.autograd.grad(out.sum(), X)
    return out.detach().numpy(), grad.numpy()


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_nlog_ml_batched_against_vmap_and_single_calls(case):
    params, data, cfg, complete = BATCH_CASES[case]()
    if case == "VC-psi-het":
        vc = vc_case()
        jflat, jax_vg = vc["jflat"], vc["jax_vg"]
        tnlml, tflat, unravel, td, tcfg = vc["port"]
    else:
        (jnlml, jflat), (tnlml, tflat, unravel, td, tcfg) = both_sides(
            params, data, cfg, complete)
        jax_vg = jax.jit(jax.vmap(jax.value_and_grad(jnlml)))
    X = points(jflat)
    jf, jg = jax_vg(jnp.asarray(X))
    f, g = torch_value_and_grad(tnlml, X)
    np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
    assert_grad_close(g, jg)
    for b in range(len(X)):
        one = torch.tensor(X[b]).requires_grad_(True)
        f1, _ = tobj.nlog_ml(unravel(one), td, tcfg, complete=complete)
        g1, = torch.autograd.grad(f1, one)
        np.testing.assert_allclose(f[b], f1.item(), rtol=1e-12)
        assert_grad_close(g[b], g1.numpy(), rtol=1e-12)


def test_each_set_climbs_its_own_jitter_ladder():
    """Set 1's Gamma has a zero column for basis 0, so its iSigma has a
    zero pivot and needs jitter; sets 0 and 2 factor at zero. The batch
    equals the three single calls, and JAX's per-chain vmap in value (and in
    gradient for the sets without jitter); one ladder shared by the whole
    batch would have jittered sets 0 and 2 too."""
    vc = vc_case()
    jflat, jnlml = vc["jflat"], vc["jnlml"]
    tnlml, tflat, unravel, td, tcfg = vc["port"]
    Xt = torch.tensor(points(jflat, scale=0.01, seed=12))
    unravel(Xt[1]).gamma[0, :, 0] = 0.0       # a view into Xt
    X = Xt.numpy()
    iSig = lambda x: (lambda G: G.transpose(-1, -2) @ G)(  # noqa: E731
        unravel(torch.tensor(x)).gamma)
    assert torch.isnan(tl._cholesky_or_nan(iSig(X[1]))).any()
    f, g = torch_value_and_grad(tnlml, X)
    assert np.isfinite(f).all() and np.isfinite(g).all()
    for b in range(3):
        f1, g1 = torch_value_and_grad(tnlml, X[b:b + 1])
        np.testing.assert_allclose(f[b], f1[0], rtol=1e-12)
        assert_grad_close(g[b], g1[0], rtol=1e-12)
    jf, jg = vc["jax_vg"](jnp.asarray(X))
    np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
    for b in (0, 2):
        assert_grad_close(g[b], jg[b])
    # gpz_tpu's gradient of a chain that took jitter is NaN, batched or
    # alone: its failed zero-jitter factor stays in the graph with a zero
    # cotangent, and the Cholesky VJP turns 0 * NaN into NaN. The port
    # differentiates the jittered factor only (the single call above).
    assert np.isnan(np.asarray(jg[1])).any()
    assert np.isnan(np.asarray(jax.jit(jax.grad(jnlml))(
        jnp.asarray(X[1])))).any()
    # the factor of a good set is its zero-jitter factor; a shared ladder
    # would have given it the bad set's level
    A = torch.stack([iSig(x) for x in X])
    per_set = tl.safe_cholesky(A, batch_dims=1)
    shared = tl.safe_cholesky(A)
    for b in (0, 2):
        assert torch.equal(per_set[b], tl._cholesky_or_nan(A[b]))
        assert not torch.equal(shared[b], per_set[b])
    assert torch.equal(per_set[1], tl.safe_cholesky(A[1]))


def test_solve_w_logdet_ladder_per_set():
    rng = np.random.default_rng(13)
    R = rng.standard_normal((3, 2, 5, 5))
    S = torch.tensor(R @ np.swapaxes(R, -1, -2) + 0.1 * np.eye(5))
    S[1, 0] = torch.tensor(np.outer(R[1, 0, 0], R[1, 0, 0]))  # rank one
    rhs = torch.tensor(rng.standard_normal((3, 5, 2)))
    w, logdet = tl.solve_w_logdet(S, rhs, batch_dims=1)
    for b in range(3):
        w1, ld1 = tl.solve_w_logdet(S[b], rhs[b])
        assert torch.equal(w[b], w1) and torch.equal(logdet[b], ld1)


def test_gpz_log_posterior():
    """On a cheap smooth stand-in for the nlml (nlog_ml_batched is held to
    nlog_ml above): the un-normalization and the hyperprior."""
    rng = np.random.default_rng(22)
    A, mean = rng.standard_normal((4, 4)), rng.standard_normal(4)
    X = rng.standard_normal((3, 4))

    def nlml(sin, A):
        return lambda x: sin(x).sum(-1) + 0.1 * ((x @ A) ** 2).sum(-1)

    for m, scale in ((None, None), (mean, 2.0)):
        jl = jmcmc.gpz_log_posterior(
            nlml(jnp.sin, jnp.asarray(A)), n_eff=48.0, k=2,
            prior_scale=scale, prior_mean=None if m is None else
            jnp.asarray(m))
        tl_ = tinf.gpz_log_posterior(
            nlml(torch.sin, torch.tensor(A)), n_eff=48.0, k=2,
            prior_scale=scale, prior_mean=None if m is None else
            torch.tensor(m))
        jf, jg = jax.jit(jax.vmap(jax.value_and_grad(jl)))(jnp.asarray(X))
        f, g = torch_value_and_grad(tl_, X)
        np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
        assert_grad_close(g, jg)


@pytest.mark.parametrize("shape", [(), (3,)], ids=["shared", "per-chain"])
def test_dual_averaging_sequence(shape):
    rng = np.random.default_rng(14)
    eps0 = 0.05 + 0.1 * rng.random(shape)
    accept = rng.random((40,) + shape)
    js = jmcmc._da_init(jnp.asarray(eps0))
    ts = tmcmc._da_init(torch.tensor(eps0))
    for a in accept:
        js = jmcmc._da_update(js, jnp.asarray(a), 0.8)
        ts = tmcmc._da_update(ts, torch.tensor(a), 0.8)
        for j, t in zip(js, ts):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **VALUE)


def test_split_rhat():
    rng = np.random.default_rng(15)
    S = (rng.standard_normal((4, 51, 3)) * [1.0, 2.0, 0.5]
         + rng.standard_normal((4, 1, 3)) * 0.3)
    np.testing.assert_allclose(tinf.split_rhat(torch.tensor(S)).numpy(),
                               np.asarray(jinf.split_rhat(jnp.asarray(S))),
                               **VALUE)


def test_collective_warmup_pools_step_size_and_mass():
    """collective_mcmc with a deterministic step whose moves and acceptance
    read eps and inv_mass: the samples, acceptance and final step size show
    the pooled dual averaging, the Welford moments and the pooled variance
    of window 1, the same in both packages."""

    # a contraction: rounding differences of the two packages' sums stay
    # at rounding, where a chaotic map would amplify them
    def jstep(key, x, logp, eps, inv_mass):
        x = 0.5 * x + 0.1 * eps * inv_mass * (1.0 - x * x) / (1.0 + x * x)
        return x, logp, 1.0 / (1.0 + eps * jnp.sum(x * x)), ()

    def tstep(x, logp, grad, eps, inv_mass):
        e = eps[:, None]
        x = 0.5 * x + 0.1 * e * inv_mass * (1.0 - x * x) / (1.0 + x * x)
        return x, logp, grad, 1.0 / (1.0 + eps * torch.sum(x * x, -1)), ()

    x0 = np.random.default_rng(16).standard_normal((4, 3))
    kw = dict(num_warmup=30, num_samples=12, target_accept=0.8, eps0=0.1)
    jres = jmcmc.collective_mcmc(jstep, lambda x: -jnp.sum(x**2),
                                 jnp.asarray(x0), jax.random.PRNGKey(0), **kw)
    tres = tmcmc.collective_mcmc(tstep, lambda x: -torch.sum(x**2, -1),
                                 torch.tensor(x0), **kw)
    for t, j in zip(tres[:3], jres[:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-10,
                                   atol=1e-13)


@pytest.mark.parametrize("call", ["hmc_sample", "nuts_sample",
                                  "collective_mcmc"])
def test_axis_name_raises(call):
    logp = lambda x: -torch.sum(x**2, -1)  # noqa: E731
    x0 = torch.zeros(2, dtype=F64)
    with pytest.raises(NotImplementedError, match="parallel slice"):
        if call == "collective_mcmc":
            tmcmc.collective_mcmc(None, logp, x0[None], num_warmup=2,
                                  num_samples=2, target_accept=0.8, eps0=0.1,
                                  axis_name="restart")
        else:
            getattr(tinf, call)(logp, x0, torch.Generator(), num_warmup=2,
                                num_samples=2, collective_adapt=True,
                                axis_name="restart")
