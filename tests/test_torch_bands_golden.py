"""The nine-band configuration (VC, m=100, d=9, psi (n, 9, 9), float64) in
gpz_tpu_torch on the CPU against tests/data/torch_port_golden_bands.npz,
gpz_tpu's values for its 1,000-row sub-problem: init, nlog_ml and its
gradient, the f trace of the first iterations and the predictions of
complete rows, within BANDS_TOL (make_torch_port_golden.py states it).

The golden rows with NaNs sum the mixture of up to 100 components over 10**4
pairs a row (every one of them escalates at this point), about 4 us a pair
on one CPU thread through the plain twin, so they are held on the card
(chip_smoke.py phase 21), with the full-size run.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu_torch
from gpz_tpu_torch import datautils
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.model import _make_dataset
from gpz_tpu_torch.objective import nlog_ml

from make_torch_port_golden import (
    BANDS, BANDS_COMPLETE_ROWS, BANDS_SUB, BANDS_TOL, BANDS_TRACE_ITERS, M,
    MAX_ATTEMPTS, OUTPUTS, bands_problem, load_golden_bands,
)


@pytest.fixture(scope="module")
def golden():
    return load_golden_bands()


@pytest.fixture(scope="module")
def sub_problem():
    X, Y, psi, _, _, served, _ = bands_problem(synthetic_sdss)
    sub = slice(0, BANDS_SUB)
    model = gpz_tpu_torch.init(X[sub], Y[sub], "VC", M, heteroscedastic=True,
                               psi=psi[sub], seed=1, dtype="float64",
                               device="cpu")
    return X, Y, psi, served, model


def test_bands_init_matches_golden(sub_problem, golden):
    *_, model = sub_problem
    assert model.cfg.d == BANDS and model.cfg.full_cov
    flat = model.last.params.flatten()[0].numpy()
    assert np.max(np.abs(flat - golden["sub.init.flat"])) <= BANDS_TOL[
        "sub.init.flat"]


def test_bands_objective_matches_golden(sub_problem, golden):
    X, Y, psi, _, model = sub_problem
    sub = slice(0, BANDS_SUB)
    Xn = (X[sub] - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[sub, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi[sub], BANDS_SUB, model.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(BANDS_SUB),
                         np.ones(BANDS_SUB, bool), torch.float64, "cpu")
    flat, unravel = model.last.params.flatten()
    flat = flat.clone().requires_grad_(True)
    nlml, _ = nlog_ml(unravel(flat), data, model.cfg, complete=True)
    grad, = torch.autograd.grad(nlml, flat)
    rtol, atol = BANDS_TOL["init.nlml"]
    np.testing.assert_allclose(float(nlml.detach()), golden["init.nlml"],
                               rtol=rtol, atol=atol)
    rtol, atol = BANDS_TOL["init.grad"]
    np.testing.assert_allclose(grad.numpy(), golden["init.grad"], rtol=rtol,
                               atol=atol)


def test_bands_complete_rows_match_golden(sub_problem, golden):
    X, _, psi, served, model = sub_problem
    rows = served[:BANDS_COMPLETE_ROWS]
    pred = gpz_tpu_torch.predict(X[rows], model, psi=psi[rows])
    for k in OUTPUTS:
        rtol, atol = BANDS_TOL["complete"][k]
        np.testing.assert_allclose(getattr(pred, k), golden[f"complete.{k}"],
                                   rtol=rtol, atol=atol, err_msg=k)


def test_bands_first_iterations_match_golden(sub_problem, golden):
    X, Y, psi, _, model = sub_problem
    sub = slice(0, BANDS_SUB)
    fit = gpz_tpu_torch.train(model, X[sub], Y[sub], psi=psi[sub],
                              max_iter=BANDS_TRACE_ITERS,
                              max_attempts=MAX_ATTEMPTS,
                              verbose=False).fit_info
    k = len(golden["trace.f"])
    assert fit["iterations"] + 1 == k
    np.testing.assert_array_equal(fit["trace"]["fevals"][:k],
                                  golden["trace.fevals"])
    rtol, atol = BANDS_TOL["trace.f"]
    np.testing.assert_allclose(fit["trace"]["f"][:k], golden["trace.f"],
                               rtol=rtol, atol=atol)
