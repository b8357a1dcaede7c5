"""gpz_tpu_torch.objective, prior and params.flatten against gpz_tpu in
float64 on the CPU: small seeded problems of the full-covariance family on
complete rows, with non-uniform omega.

Tolerances: both packages compute the same float64 formulas with different
summation orders (XLA's reductions against PyTorch's), so values agree to
~1e-13 relative; the gradient passes through the (m x m) solve, whose
conditioning amplifies rounding, hence 1e-8 relative (measured 2e-11 at
most on these cases).
"""

import dataclasses
import itertools

import numpy as np
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest
import torch

import gpz_tpu
from gpz_tpu import objective as jobj
from gpz_tpu.dataset import Dataset as JDataset
from gpz_tpu.params import GPzParams as JParams
from gpz_tpu.prior import get_prior as jget_prior

from gpz_tpu_torch import objective as tobj
from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.dataset import Dataset
from gpz_tpu_torch.params import FIELDS, GPzParams
from gpz_tpu_torch.prior import get_prior

VALUE = dict(rtol=1e-10, atol=1e-12)
GRAD = dict(rtol=1e-8, atol=1e-10)

N, D, M = 48, 3, 6
CASES = list(itertools.product(("GC", "VC"), (True, False), (True, False),
                               (1, 2)))
IDS = [f"{m}-{'psi' if p else 'nopsi'}-{'het' if h else 'hom'}-k{k}"
       for m, p, h, k in CASES]


def make_case(method, with_psi, het, k, seed=0, n=N):
    """(param arrays, data arrays, cfg kwargs) from one numpy generator."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, D))
    Y = np.sin(X[:, :1] + np.arange(k)[None, :]) + 0.1 * rng.standard_normal(
        (n, k))
    omega = rng.uniform(0.5, 1.5, n)
    psi = None
    if with_psi:
        A = rng.standard_normal((n, D, D)) * 0.2
        psi = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)
    gm = 1 if method == "GC" else M
    params = {
        "P": rng.standard_normal((M, D)),
        "gamma": np.eye(D)[None] * 0.8
        + 0.1 * rng.standard_normal((gm, D, D)),
        "ln_alpha": 0.3 * rng.standard_normal((M, k)),
        "b": np.log(0.05) + 0.1 * rng.standard_normal(k),
    }
    if het:
        params["v"] = 0.1 * rng.standard_normal((M, k))
        params["ln_tau"] = 0.2 * rng.standard_normal((M, k))
    data = {"X": X, "mask": np.ones((n, D), bool), "omega": omega, "Y": Y,
            "psi": psi}
    cfg = dict(m=M, d=D, k=k, method=method, heteroscedastic=het,
               dtype="float64")
    return params, data, cfg


def jax_side(params, data, cfg):
    jp = JParams(**{f: jnp.asarray(v) for f, v in params.items()})
    jd = JDataset(**{f: None if v is None else jnp.asarray(v)
                     for f, v in data.items()})
    return jp, jd, gpz_tpu.ModelConfig(**cfg)


def torch_side(params, data, cfg):
    tp = GPzParams.from_numpy(params, "cpu", torch.float64)
    td = Dataset(**{f: None if v is None else torch.from_numpy(v)
                    for f, v in data.items()})
    return tp, td, ModelConfig(**cfg)


def torch_value_and_grad(tp, td, tcfg):
    flat, unravel = tp.flatten()
    flat = flat.clone().requires_grad_(True)
    nlml, aux = tobj.nlog_ml(unravel(flat), td, tcfg, complete=True)
    grad, = torch.autograd.grad(nlml, flat)
    return nlml.detach().numpy(), grad.numpy(), aux


@pytest.mark.parametrize("method,with_psi,het,k", CASES, ids=IDS)
def test_nlog_ml_value_and_gradient(method, with_psi, het, k):
    case = make_case(method, with_psi, het, k)
    jp, jd, jcfg = jax_side(*case)
    (jf, jaux), jg = jax.value_and_grad(
        lambda p: jobj.nlog_ml(p, jd, jcfg, complete=True), has_aux=True)(jp)
    f, g, aux = torch_value_and_grad(*torch_side(*case))
    np.testing.assert_allclose(f, np.asarray(jf), **VALUE)
    np.testing.assert_allclose(g, np.asarray(ravel_pytree(jg)[0]), **GRAD)
    np.testing.assert_allclose(aux.w.numpy(), np.asarray(jaux.w), **GRAD)
    np.testing.assert_allclose(aux.train_rmse.numpy(),
                               np.asarray(jaux.train_rmse), **VALUE)
    np.testing.assert_allclose(aux.train_ll.numpy(),
                               np.asarray(jaux.train_ll), **VALUE)


@pytest.mark.parametrize("method,with_psi,het,k", CASES[::3], ids=IDS[::3])
def test_posterior_holdout_and_prior(method, with_psi, het, k):
    case = make_case(method, with_psi, het, k, seed=1)
    jp, jd, jcfg = jax_side(*case)
    tp, td, tcfg = torch_side(*case)
    jpost = jobj.posterior(jp, jd, jcfg, complete=True)
    post = tobj.posterior(tp, td, tcfg, complete=True)
    for name in ("w", "iSigma_w", "logdet"):
        np.testing.assert_allclose(getattr(post, name).numpy(),
                                   np.asarray(getattr(jpost, name)), **GRAD)
    # validation metrics on other rows with the training weights
    vcase = make_case(method, with_psi, het, k, seed=2, n=20)
    _, jdv, _ = jax_side(*vcase)
    _, tdv, _ = torch_side(*vcase)
    jr, jl = jobj.holdout_metrics(jp, jpost.w, jdv, jcfg, complete=True)
    r, l = tobj.holdout_metrics(tp, post.w, tdv, tcfg, complete=True)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **GRAD)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), **GRAD)
    # n_eff as given
    r2, _ = tobj.holdout_metrics(tp, post.w, tdv, tcfg, n_eff=10.0,
                                 complete=True)
    jr2, _ = jobj.holdout_metrics(jp, jpost.w, jdv, jcfg,
                                  n_eff=jnp.asarray(10.0), complete=True)
    np.testing.assert_allclose(r2.numpy(), np.asarray(jr2), **GRAD)
    np.testing.assert_allclose(
        get_prior(tp, td, tcfg, complete=True).numpy(),
        np.asarray(jget_prior(jp, jd, jcfg, complete=True)),
        rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("het", [True, False], ids=["het", "hom"])
@pytest.mark.parametrize("method", ["GC", "VC"])
def test_flatten_order_is_ravel_pytrees(method, het):
    params, _, _ = make_case(method, False, het, 2, seed=3)
    jflat, junravel = ravel_pytree(
        JParams(**{f: jnp.asarray(v) for f, v in params.items()}))
    tp = GPzParams.from_numpy(params, "cpu", torch.float64)
    flat, unravel = tp.flatten()
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    # a JAX flat vector unravels to the same parameters here
    vec = np.random.default_rng(4).standard_normal(flat.shape[0])
    back, jback = unravel(torch.from_numpy(vec)), junravel(jnp.asarray(vec))
    for f in FIELDS:
        a, b = getattr(back, f), getattr(jback, f)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        unravel(torch.zeros(flat.shape[0] + 1, dtype=torch.float64))


def test_gc_gradient_sums_over_the_broadcast_bases():
    case = make_case("GC", True, True, 1, seed=5)
    tp, td, tcfg = torch_side(*case)
    gamma = tp.gamma.clone().requires_grad_(True)
    nlml, _ = tobj.nlog_ml(dataclasses.replace(tp, gamma=gamma), td, tcfg,
                           complete=True)
    g_shared, = torch.autograd.grad(nlml, gamma)
    # the same model as VC with every basis holding a copy of gamma
    wide = tp.gamma.expand(M, D, D).clone().requires_grad_(True)
    vcfg = dataclasses.replace(tcfg, method="VC")
    nlml_v, _ = tobj.nlog_ml(dataclasses.replace(tp, gamma=wide), td, vcfg,
                             complete=True)
    g_wide, = torch.autograd.grad(nlml_v, wide)
    assert g_shared.shape == (1, D, D)
    torch.testing.assert_close(nlml, nlml_v, rtol=1e-13, atol=0)
    torch.testing.assert_close(g_shared[0], g_wide.sum(0), rtol=1e-10,
                               atol=1e-13)


@pytest.mark.parametrize("solve_dtype,want", [("auto", torch.float64),
                                              ("float64", torch.float64),
                                              ("float32", torch.float32)])
def test_solve_dtype_of_a_float32_model(solve_dtype, want):
    params, data, cfg = make_case("VC", True, True, 1, seed=6)
    tp = GPzParams.from_numpy(params, "cpu", torch.float32)
    td = Dataset(**{f: None if v is None else torch.from_numpy(v).to(
        torch.bool if f == "mask" else torch.float32)
        for f, v in data.items()})
    tcfg = ModelConfig(**{**cfg, "dtype": "float32",
                          "solve_dtype": solve_dtype})
    nlml, aux = tobj.nlog_ml(tp, td, tcfg, complete=True)
    assert nlml.dtype == want and aux.w.dtype == want
    f64, _ = tobj.nlog_ml(*torch_side(params, data, cfg), complete=True)
    # float32 design matrix: ~1e-6 relative on a value of order 1
    np.testing.assert_allclose(nlml.double().numpy(), f64.numpy(), rtol=1e-3)
    assert tobj.posterior(tp, td, tcfg, complete=True).w.dtype == torch.float32


def test_reducer_sees_every_sum_over_samples():
    case = make_case("VC", True, True, 2, seed=7)
    tp, td, tcfg = torch_side(*case)
    seen = []

    def reducer(x):
        seen.append(tuple(x.shape))
        return x

    f, _ = tobj.nlog_ml(tp, td, tcfg, complete=True, reducer=reducer)
    f0, _ = tobj.nlog_ml(tp, td, tcfg, complete=True)
    assert float(f) == float(f0)
    # Gram, rhs, sum ob*y^2, sum omega*ln_beta, sum omega, and two metrics
    assert seen == [(2, M, M), (M, 2), (2,), (2,), (), (), ()]


def test_zero_weight_rows_contribute_nothing():
    params, data, cfg = make_case("VC", True, True, 1, seed=8)
    tp, td, tcfg = torch_side(params, data, cfg)
    f, _, _ = torch_value_and_grad(tp, td, tcfg)
    # append rows with omega == 0 and wild values
    rng = np.random.default_rng(9)
    pad = {
        "X": rng.standard_normal((5, D)) * 3, "mask": np.ones((5, D), bool),
        "omega": np.zeros(5), "Y": rng.standard_normal((5, 1)) * 50,
        "psi": np.broadcast_to(np.eye(D), (5, D, D)),
    }
    wide = {f_: np.concatenate([data[f_], pad[f_]]) for f_ in data}
    _, tdw, _ = torch_side(params, wide, cfg)
    nlml, _ = tobj.nlog_ml(tp, tdw, tcfg, n_eff=float(N), complete=True)
    np.testing.assert_allclose(nlml.numpy(), f, rtol=1e-12)
