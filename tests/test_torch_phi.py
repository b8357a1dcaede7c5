"""gpz_tpu_torch.phi.log_phi against gpz_tpu.phi.log_phi and against the
loopy float64 oracle reference_impl.ref_log_phi, on the CPU in float64: the
six methods x {psi, no psi} x {missing, complete}, values and gradients.

Tolerances. Both packages evaluate the same float64 formulas on
well-conditioned (d x d) systems; only summation orders differ (XLA's
reductions against PyTorch's einsum), so values agree to 1e-12 and gradients,
sums of n such terms, to 1e-10. The oracle loops over rows with LAPACK
solves: 1e-8 / 1e-10, the bound tests/test_phi.py holds JAX to.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.config import ModelConfig as JaxConfig
from gpz_tpu.params import GPzParams as JaxParams
from gpz_tpu import phi as jphi

from gpz_tpu_torch import phi as tphi
from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams

from reference_impl import ref_log_phi

METHODS = ["GL", "VL", "GD", "VD", "GC", "VC"]
VALUE = dict(rtol=1e-12, atol=1e-12)
GRAD = dict(rtol=1e-10, atol=1e-11)
ORACLE = dict(rtol=1e-8, atol=1e-10)
N, D, M = 17, 3, 5


def make_case(method, with_psi, with_missing, seed=0, n=N, d=D, m=M):
    """(param arrays, X with NaNs, psi) as tests/test_phi.py draws them."""
    rng = np.random.default_rng(seed)
    cfg = dict(m=m, d=d, k=1, method=method, dtype="float64")
    shape = JaxConfig(**cfg).gamma_shape
    full = method in ("GC", "VC")
    if full:
        g = rng.standard_normal(shape) * 0.1
        idx = np.arange(d)
        g[..., idx, idx] += 1.0 + rng.random(shape[:-2] + (d,))
    else:
        g = 0.5 + rng.random(shape)
    arrays = {
        "P": rng.standard_normal((m, d)), "gamma": g,
        "ln_alpha": rng.standard_normal((m, 1)),
        "b": rng.standard_normal(1),
    }
    X = rng.standard_normal((n, d))
    if with_missing:
        drop = rng.random((n, d)) < 0.3
        drop[drop.all(axis=1), 0] = False
        X[drop] = np.nan
    psi = None
    if with_psi and full:
        A = rng.standard_normal((n, d, d)) * 0.3
        psi = A @ np.swapaxes(A, 1, 2) + 0.1 * np.eye(d)
    elif with_psi:
        psi = 0.1 + rng.random((n, d))
    return arrays, cfg, X, psi


def port_log_phi(arrays, cfg, X, psi, complete, grad=False):
    mask = ~np.isnan(X)
    tp = GPzParams.from_numpy(arrays, "cpu", torch.float64)
    if grad:
        tp.P.requires_grad_(True)
        tp.gamma.requires_grad_(True)
    out = tphi.log_phi(
        tp, ModelConfig(**cfg), torch.from_numpy(np.where(mask, X, 0.0)),
        torch.from_numpy(mask), None if psi is None else torch.from_numpy(psi),
        complete=complete)
    return tp, out


def jax_log_phi(arrays, cfg, X, psi, complete):
    mask = ~np.isnan(X)

    def fn(P, gamma):
        jp = JaxParams(P=P, gamma=gamma, ln_alpha=jnp.asarray(
            arrays["ln_alpha"]), b=jnp.asarray(arrays["b"]))
        return jphi.log_phi(
            jp, JaxConfig(**cfg), jnp.asarray(np.where(mask, X, 0.0)),
            jnp.asarray(mask), None if psi is None else jnp.asarray(psi),
            complete=complete)

    return fn


@pytest.mark.parametrize("with_missing", [False, True],
                         ids=["complete", "missing"])
@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("method", METHODS)
def test_log_phi_matches_jax_and_the_oracle(method, with_psi, with_missing):
    arrays, cfg, X, psi = make_case(method, with_psi, with_missing)
    complete = not with_missing
    tp, (ln_phi, ln_n) = port_log_phi(arrays, cfg, X, psi, complete,
                                      grad=True)
    fn = jax_log_phi(arrays, cfg, X, psi, complete)
    P, gamma = jnp.asarray(arrays["P"]), jnp.asarray(arrays["gamma"])
    want_phi, want_n = fn(P, gamma)
    assert ln_phi.shape == ln_n.shape == (N, M)
    np.testing.assert_allclose(ln_phi.detach().numpy(), np.asarray(want_phi),
                               **VALUE)
    np.testing.assert_allclose(ln_n.detach().numpy(), np.asarray(want_n),
                               **VALUE)
    exp_phi, exp_n = ref_log_phi(X, psi, arrays["P"], arrays["gamma"], method)
    np.testing.assert_allclose(ln_phi.detach().numpy(), exp_phi, **ORACLE)
    np.testing.assert_allclose(ln_n.detach().numpy(), exp_n, **ORACLE)
    # the gradient of one seeded scalar of both outputs
    rng = np.random.default_rng(1)
    c1, c2 = rng.standard_normal((2, N, M))
    loss = (ln_phi * torch.from_numpy(c1)).sum() + (
        ln_n * torch.from_numpy(c2)).sum()
    gP, gG = torch.autograd.grad(loss, (tp.P, tp.gamma))
    jP, jG = jax.grad(
        lambda P, g: jnp.sum(fn(P, g)[0] * c1) + jnp.sum(fn(P, g)[1] * c2),
        argnums=(0, 1))(P, gamma)
    assert gG.shape == tuple(JaxConfig(**cfg).gamma_shape)
    np.testing.assert_allclose(gP.numpy(), np.asarray(jP), **GRAD)
    np.testing.assert_allclose(gG.numpy(), np.asarray(jG), **GRAD)


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("method", ["VD", "GC", "VC"])
def test_masked_and_complete_paths_agree_on_complete_rows(method, with_psi):
    """complete=True (the kernel's function or |Gamma Delta|^2) and
    complete=False (the masked pass) compute the same thing when nothing is
    missing: different algebra, so 1e-10."""
    arrays, cfg, X, psi = make_case(method, with_psi, False, seed=2)
    _, a = port_log_phi(arrays, cfg, X, psi, True)
    _, b = port_log_phi(arrays, cfg, X, psi, False)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
def test_row_blocks_give_the_single_blocks_values_and_gradient(
        with_psi, monkeypatch):
    """n=17 in blocks of 5 (the last one ragged), each recomputed in the
    backward: per-row values are the same arithmetic (equal), the gradient
    sums the rows in another order (1e-12)."""
    arrays, cfg, X, psi = make_case("VC", with_psi, True, seed=3)
    c = torch.from_numpy(np.random.default_rng(4).standard_normal((N, M)))

    def run():
        tp, (ln_phi, ln_n) = port_log_phi(arrays, cfg, X, psi, False,
                                          grad=True)
        g = torch.autograd.grad((ln_phi * c).sum() + ln_n.sum(),
                                (tp.P, tp.gamma))
        return ln_phi.detach(), ln_n.detach(), g

    one = run()
    monkeypatch.setattr(tphi, "PHI_BLOCK_ROWS", 5)
    many = run()
    torch.testing.assert_close(many[0], one[0], rtol=0, atol=0)
    torch.testing.assert_close(many[1], one[1], rtol=0, atol=0)
    for a, b in zip(many[2], one[2]):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("method", ["VD", "VC"])
def test_a_row_with_nothing_observed_is_what_jax_gives(method):
    """n_obs = 0: the masked embedding is the identity, the quadratic form and
    both logdets are 0, and lnPHI is the marginalization constant alone."""
    arrays, cfg, X, psi = make_case(method, True, True, seed=5)
    X[3, :] = np.nan
    _, (ln_phi, ln_n) = port_log_phi(arrays, cfg, X, psi, False)
    want_phi, want_n = jax_log_phi(arrays, cfg, X, psi, False)(
        jnp.asarray(arrays["P"]), jnp.asarray(arrays["gamma"]))
    np.testing.assert_allclose(ln_phi.numpy(), np.asarray(want_phi), **VALUE)
    np.testing.assert_allclose(ln_n.numpy(), np.asarray(want_n), **VALUE)
    np.testing.assert_allclose(ln_phi[3].numpy(), -0.5 * D * np.log(2.0),
                               rtol=1e-15)
    np.testing.assert_allclose(ln_n[3].numpy(), 0.0, atol=1e-15)
