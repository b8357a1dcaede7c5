"""The scale configuration's objective (BASELINE.json configs[4]: VC,
m=1000, d=5, heteroscedastic, psi (n, d, d)) in gpz_tpu_torch against
gpz_tpu in float64 on the CPU, at the widths the card runs and a few
hundred rows: nlog_ml and its gradient, and the release of the (n, m)
tensors that training does not read (lnN in the objective, lnPHI and lnN
in the prior's fixed point).

Tolerances: nlog_ml and its gradient are the same float64 formulas with
different summation orders, test_torch_objective's VALUE and GRAD (measured
at m=1000: 1.3e-15 relative, and 8.4e-15 of the gradient's largest entry,
0.44). Releasing a tensor changes no operation: value, gradient and prior
are bit-identical to an evaluation that holds it.
"""

import weakref

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
from jax.flatten_util import ravel_pytree
import pytest
import torch

import gpz_tpu
from gpz_tpu import datautils as jdu
from gpz_tpu.model import _make_dataset as j_make_dataset
from gpz_tpu.objective import nlog_ml as j_nlog_ml

import gpz_tpu_torch
from gpz_tpu_torch import datautils, objective
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.model import _make_dataset
from gpz_tpu_torch.prior import get_prior

from test_torch_objective import GRAD, VALUE

M = 1000
OBJECTIVE_ROWS = 512


def problem(n):
    """(X, Y, psi) of the first n rows of synthetic_sdss(seed=3), the scale
    configuration's generator, psi = errs**2."""
    mags, errs, z = synthetic_sdss(n=n, filters=5, seed=3)
    return mags, z, errs ** 2


def port_data(model, X, Y, psi, n):
    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[:, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)
    rows = np.zeros(len(Y), bool)
    rows[:n] = True
    return _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), rows, torch.float64,
                         "cpu")


def value_and_grad(flat, unravel, data, cfg):
    flat = flat.detach().clone().requires_grad_(True)
    nlml, _ = objective.nlog_ml(unravel(flat), data, cfg, complete=True)
    grad, = torch.autograd.grad(nlml, flat)
    return nlml.detach(), grad


@pytest.fixture(scope="module")
def init_point():
    """The port's model at init on OBJECTIVE_ROWS rows, with its data."""
    X, Y, psi = problem(OBJECTIVE_ROWS)
    model = gpz_tpu_torch.init(X, Y, "VC", M, heteroscedastic=True, psi=psi,
                               seed=1, dtype="float64", device="cpu")
    return model, (X, Y, psi), port_data(model, X, Y, psi, OBJECTIVE_ROWS)


def test_nlog_ml_at_m1000_matches_jax(init_point):
    model, (X, Y, psi), data = init_point
    flat, unravel = model.last.params.flatten()
    f, g = value_and_grad(flat, unravel, data, model.cfg)

    jm = gpz_tpu.init(X, Y, "VC", M, heteroscedastic=True, psi=psi, seed=1,
                      dtype="float64")
    Xn = (X - jm.muX[None, :]) / jm.sdX[None, :]
    jd = j_make_dataset(Xn, Y[:, None] - jm.muY[None, :],
                        jdu.fix_psi(psi, len(Y), jm.sdX, True),
                        np.ones(len(Y)), np.ones(len(Y), bool), np.float64)
    (jf, _), jg = jax.jit(jax.value_and_grad(
        lambda p: j_nlog_ml(p, jd, jm.cfg, complete=True),
        has_aux=True))(jm.last.params)
    np.testing.assert_allclose(float(f), float(jf), **VALUE)
    np.testing.assert_allclose(g.numpy(), np.asarray(ravel_pytree(jg)[0]),
                               rtol=GRAD["rtol"],
                               atol=GRAD["atol"] * float(g.abs().max()))


@pytest.mark.parametrize("m", [8, M])
def test_lnN_is_released_before_the_gram_with_the_same_bits(m, monkeypatch,
                                                            init_point):
    """nlog_ml drops lnN (an (n, m) tensor the objective never reads) before
    its Gram: the tensor is gone when _gram_reductions starts, and value and
    gradient are bit-identical to an evaluation that holds it to the end,
    as the objective did before."""
    n = 256
    _, (X, Y, psi), _ = init_point
    model = gpz_tpu_torch.init(X, Y, "VC", m, heteroscedastic=True, psi=psi,
                               seed=1, dtype="float64", device="cpu")
    data = port_data(model, X, Y, psi, n)
    flat, unravel = model.last.params.flatten()
    real_dm = objective.design_matrix
    real_gram = objective._gram_reductions
    seen, held, alive = [], [], []

    def watched(*a, **kw):
        out = real_dm(*a, **kw)
        seen.append(weakref.ref(out[1]))
        return out

    def holding(*a, **kw):
        out = real_dm(*a, **kw)
        held.append(out[1])
        return out

    def gram(*a, **kw):
        alive.append(seen[-1]() is not None)
        return real_gram(*a, **kw)

    monkeypatch.setattr(objective, "_gram_reductions", gram)
    monkeypatch.setattr(objective, "design_matrix", watched)
    f, g = value_and_grad(flat, unravel, data, model.cfg)
    assert alive == [False]
    monkeypatch.setattr(objective, "design_matrix", holding)
    f_held, g_held = value_and_grad(flat, unravel, data, model.cfg)
    assert len(held) == 1 and held[0].shape == (n, m)
    assert torch.equal(f, f_held) and torch.equal(g, g_held)


def test_get_prior_equals_the_expression_that_holds_lnPHI(init_point):
    """get_prior releases lnPHI and lnN once the responsibilities exist; its
    fixed point is bit-identical to the loop over tensors that keep them."""
    from gpz_tpu_torch.phi import log_phi

    model, _, data = init_point
    params, cfg = model.last.params, model.cfg
    got = get_prior(params, data, cfg, complete=True)
    _, ln_n = log_phi(params, cfg, data.X, data.mask, data.psi, True)
    N = torch.exp(ln_n - ln_n.max(dim=1, keepdim=True).values)
    prior = torch.full((cfg.m,), 1.0 / cfg.m, dtype=torch.float64)
    for _ in range(100):
        w = N * prior[None, :]
        w = w / w.sum(dim=1, keepdim=True)
        new = w.mean(dim=0)
        delta = float(torch.linalg.norm(prior - new)
                      / torch.linalg.norm(prior + new))
        prior = new
        if delta < 1e-10:
            break
    assert torch.equal(got, prior)
