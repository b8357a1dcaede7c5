"""gpz_tpu_torch's prediction path against gpz_tpu's, on the CPU: the design
matrix and moment functions on a small random VC model, and the public
predict() on the trained photo-z checkpoint and its JAX golden file."""

import importlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import gpz_tpu
from gpz_tpu import phi as jphi
from gpz_tpu.config import ModelConfig as JaxConfig
from gpz_tpu.objective import Posterior as JaxPosterior
from gpz_tpu.params import GPzParams as JaxParams

import gpz_tpu_torch
from gpz_tpu_torch import datautils
from gpz_tpu_torch import phi as tphi
from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.objective import Posterior
from gpz_tpu_torch.params import GPzParams

from make_torch_port_golden import (
    CHECKPOINT, DTYPES, GOLDEN_TOL, OUTPUTS, golden_rows, jax_predictions,
    load_golden,
)

# the modules, not the packages' `predict` functions of the same name
jpredict = importlib.import_module("gpz_tpu.predict")
tpredict = importlib.import_module("gpz_tpu_torch.predict")

# a well-conditioned random model: float64 agrees to rounding
F64 = dict(rtol=1e-10, atol=1e-12)
M, D, K, N = 6, 3, 1, 20


def small_model(seed=0):
    rng = np.random.default_rng(seed)
    arrays = {
        "P": rng.standard_normal((M, D)),
        "gamma": np.eye(D) * rng.uniform(0.5, 1.5, (M, 1, 1))
        + 0.1 * rng.standard_normal((M, D, D)),
        "ln_alpha": rng.standard_normal((M, K)),
        "b": rng.standard_normal(K) * 0.1 - 3.0,
        "v": rng.standard_normal((M, K)) * 0.1,
        "ln_tau": np.zeros((M, K)),
    }
    Q = rng.standard_normal((K, M, M))
    post = {"w": rng.standard_normal((M, K)),
            "iSigma_w": Q @ np.swapaxes(Q, 1, 2) / M + 0.1 * np.eye(M),
            "logdet": np.zeros(K)}
    priors = np.full(M, 1.0 / M)
    X = rng.standard_normal((N, D))
    A = rng.standard_normal((N, D, D)) * 0.2
    psi = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)
    kw = dict(m=M, d=D, k=K, method="VC", dtype="float64")
    jax_side = (JaxParams(**{k: jnp.asarray(v) for k, v in arrays.items()}),
                JaxPosterior(**{k: jnp.asarray(v) for k, v in post.items()}),
                jnp.asarray(priors), JaxConfig(**kw))
    port_side = (GPzParams.from_numpy(arrays, "cpu", torch.float64),
                 Posterior(**{k: torch.from_numpy(v)
                              for k, v in post.items()}),
                 torch.from_numpy(priors), ModelConfig(**kw))
    return jax_side, port_side, X, psi


def assert_outputs(got, want, **tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   **(tol or F64))


@pytest.mark.parametrize("with_psi", [False, True], ids=["no-psi", "psi"])
def test_design_matrix_matches_jax(with_psi):
    (jp, _, _, jcfg), (tp, _, _, tcfg), X, psi = small_model(1)
    mask = np.ones_like(X, bool)
    want = jphi.design_matrix(jp, jcfg, jnp.asarray(X), jnp.asarray(mask),
                              jnp.asarray(psi) if with_psi else None,
                              complete=True)
    got = tphi.design_matrix(tp, tcfg, torch.from_numpy(X),
                             torch.from_numpy(mask),
                             torch.from_numpy(psi) if with_psi else None,
                             complete=True)
    assert_outputs(got, want)


def test_predict_clean_matches_jax():
    (jp, jpost, _, jcfg), (tp, tpost, _, tcfg), X, _ = small_model(2)
    mask = np.ones_like(X, bool)
    want = jpredict.predict_clean(jp, jpost, jcfg, jnp.asarray(X),
                                  jnp.asarray(mask))
    got = tpredict.predict_clean(tp, tpost, tcfg, torch.from_numpy(X),
                                 torch.from_numpy(mask))
    assert_outputs(got, want)


@pytest.mark.parametrize("budget", [0, 9000], ids=["one-block", "two-blocks"])
def test_predict_moments_full_matches_jax(budget, monkeypatch):
    """budget=9000 gives B=4 at n=20, m=6: two pair blocks, one padded."""
    if budget:
        monkeypatch.setattr(jpredict, "PAIR_BUDGET", budget)
        monkeypatch.setattr(tpredict, "PAIR_BUDGET", budget)
        assert tpredict._block_size(N, M, D * D, itemsize=8) == 4
    (jp, jpost, jpri, jcfg), (tp, tpost, tpri, tcfg), X, psi = small_model(3)
    mask = np.ones(D, bool)
    want = jpredict.predict_moments_full(
        jp, jpost, jpri, jcfg, jnp.asarray(X), jnp.asarray(mask),
        jnp.asarray(psi), complete=True)
    got = tpredict.predict_moments_full(
        tp, tpost, tpri, tcfg, torch.from_numpy(X), torch.from_numpy(mask),
        torch.from_numpy(psi), complete=True)
    assert_outputs(got, want)


# --- the trained photo-z checkpoint (VC, m=100, d=5) ---

@pytest.fixture(scope="module")
def jax_preds():
    return jax_predictions()[1]


@pytest.fixture(scope="module")
def port_preds():
    _, X, psi, _ = golden_rows(synthetic_sdss, datautils.split)
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu")
    out = {}
    for dt in DTYPES:
        pred = gpz_tpu_torch.predict(X, model.astype(dt), psi=psi)
        out[dt] = {k: getattr(pred, k) for k in OUTPUTS}
    return out


def assert_within(got, want, dt):
    for k in OUTPUTS:
        rtol, atol = GOLDEN_TOL[dt][k]
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=f"{dt} {k}")


@pytest.mark.parametrize("dt", DTYPES)
def test_checkpoint_predict_matches_jax(dt, jax_preds, port_preds):
    assert_within(port_preds[dt], jax_preds[dt], dt)


@pytest.mark.parametrize("dt", DTYPES)
def test_golden_file_is_what_jax_computes(dt, jax_preds):
    golden = load_golden()
    idx, *_ = golden_rows(gpz_tpu.data.synthetic_sdss,
                          gpz_tpu.datautils.split)
    np.testing.assert_array_equal(golden["rows"], idx)
    # the same JAX computation, so a tenth of the port's allowance: room for
    # another CPU's rounding, none for a change in what JAX computes
    for k in OUTPUTS:
        rtol, atol = GOLDEN_TOL[dt][k]
        np.testing.assert_allclose(jax_preds[dt][k], golden[dt][k],
                                   rtol=rtol / 10, atol=atol / 10, err_msg=k)


@pytest.mark.parametrize("dt", DTYPES)
def test_port_matches_golden_file(dt, port_preds):
    assert_within(port_preds[dt], load_golden()[dt], dt)


@pytest.mark.parametrize("with_psi", [False, True], ids=["no-psi", "psi"])
def test_missing_data_is_not_ported(with_psi):
    _, X, psi, _ = golden_rows(synthetic_sdss, datautils.split)
    X = X[:5].copy()
    X[2, 1] = np.nan
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu")
    with pytest.raises(NotImplementedError, match="missing data"):
        gpz_tpu_torch.predict(X, model, psi=psi[:5] if with_psi else None)


def test_diagonal_family_is_not_ported():
    _, (tp, _, _, _), X, _ = small_model(4)
    cfg = ModelConfig(m=M, d=D, method="VD", dtype="float64")
    params = GPzParams(P=tp.P, gamma=torch.ones(M, D, dtype=torch.float64),
                       ln_alpha=tp.ln_alpha, b=tp.b)
    Xt = torch.from_numpy(X)
    with pytest.raises(NotImplementedError, match="diagonal family"):
        tphi.design_matrix(params, cfg, Xt, torch.ones_like(Xt, dtype=bool),
                           None, complete=True)
