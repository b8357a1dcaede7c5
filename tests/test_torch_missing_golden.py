"""What chip_smoke.py checks on the GPU against
tests/data/torch_port_golden_missing.npz, on the CPU: the paths with missing
values at the photo-z problem's full width (m=100, d=5), within MISSING_TOL
of gpz_tpu's values, cut for the CPU's sake: 16 of the 64 serving rows (4 of
each pattern), the masked objective on 4,096 rows, and of the VD run on
70,000 rows the init point and the objective there (f at iteration 0)."""

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
    CHECKPOINT, MISSING_PATTERNS, MISSING_ROWS, MISSING_TOL, OBJECTIVE_ROWS,
    OUTPUTS, inject_missing, load_golden_missing, missing_serve_rows,
    missing_train_problem, objective_rows,
)


@pytest.fixture(scope="module")
def gold():
    return load_golden_missing()


def test_injection_is_seeded_and_in_the_stated_shares():
    X = np.arange(2000.0 * 5).reshape(2000, 5)
    a, b = inject_missing(X), inject_missing(X)
    np.testing.assert_array_equal(a, b)
    nan = np.isnan(a)
    assert not nan[:, 1:4].any()
    u, z = nan[:, 0], nan[:, 4]
    assert ((u & ~z).sum(), (z & ~u).sum(), (u & z).sum()) == (500, 200, 100)
    np.testing.assert_array_equal(a[~nan], X[~nan])


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_serving_rows_match_the_golden_file(dt, gold):
    idx, X, psi, _, picks = missing_serve_rows(synthetic_sdss,
                                               datautils.split)
    np.testing.assert_array_equal(gold["rows"], idx[picks])
    per = MISSING_ROWS // len(MISSING_PATTERNS)
    for g, bands in enumerate(MISSING_PATTERNS):
        nan = np.isnan(X[picks[g * per:(g + 1) * per]])
        assert (nan.any(axis=0).nonzero()[0] == np.array(bands)).all()
        assert (nan.all(axis=0) == nan.any(axis=0)).all()
    sub = np.concatenate([np.arange(g * per, g * per + 4)
                          for g in range(len(MISSING_PATTERNS))])
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu").astype(dt)
    pred = gpz_tpu_torch.predict(X[picks[sub]], model, psi=psi[picks[sub]])
    for k in OUTPUTS:
        rtol, atol = MISSING_TOL[dt][k]
        np.testing.assert_allclose(getattr(pred, k), gold[f"{dt}.{k}"][sub],
                                   rtol=rtol, atol=atol, err_msg=f"{dt} {k}")


def test_masked_objective_and_vd_init_match_the_golden_file(gold):
    X, Y, psi, omega, tr, va = missing_train_problem(
        synthetic_sdss, datautils.get_omega)
    vc = gpz_tpu_torch.init(X, Y, "VC", 100, psi=psi, training=tr, seed=1,
                            dtype="float64", device="cpu")
    flat0, unravel = vc.last.params.flatten()
    np.testing.assert_allclose(flat0.numpy(), gold["init.flat"], rtol=0,
                               atol=MISSING_TOL["init.flat"])
    Xn = (X - vc.muX[None, :]) / vc.sdX[None, :]
    Yc = Y[:, None] - vc.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), vc.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), objective_rows(tr),
                         torch.float64, "cpu")
    assert data.n == OBJECTIVE_ROWS and not bool(data.mask.all())
    flat = torch.from_numpy(gold["init.flat"]).requires_grad_(True)
    nlml, _ = nlog_ml(unravel(flat), data, vc.cfg, complete=False)
    grad, = torch.autograd.grad(nlml, flat)
    (frt, fat), (grt, gat) = MISSING_TOL["init.nlml"], MISSING_TOL[
        "init.grad"]
    nlml = float(nlml.detach())
    np.testing.assert_allclose(nlml, gold["init.nlml"], rtol=frt, atol=fat)
    np.testing.assert_allclose(grad.numpy(), gold["init.grad"], rtol=grt,
                               atol=gat)
    print(f"masked objective: nlml vs JAX "
          f"{abs(nlml - float(gold['init.nlml'])):.3e}, gradient "
          f"max_abs {np.abs(grad.numpy() - gold['init.grad']).max():.3e}")

    vd = gpz_tpu_torch.init(X, Y, "VD", 100, psi=psi, omega=omega,
                            training=tr, seed=1, dtype="float64",
                            device="cpu")
    np.testing.assert_allclose(vd.last.params.flatten()[0].numpy(),
                               gold["vd.init.flat"], rtol=0,
                               atol=MISSING_TOL["vd.init.flat"])
    Xn = (X - vd.muX[None, :]) / vd.sdX[None, :]
    psi_d = datautils.fix_psi(psi, len(Y), vd.sdX, False)
    data = _make_dataset(Xn, Y[:, None] - vd.muY[None, :], psi_d, omega, tr,
                         torch.float64, "cpu")
    with torch.no_grad():
        f0, _ = nlog_ml(vd.last.params, data, vd.cfg, complete=False)
    rtol, atol = MISSING_TOL["vd.trace.f"]
    np.testing.assert_allclose(float(f0), gold["vd.trace.f"][0], rtol=rtol,
                               atol=atol)
