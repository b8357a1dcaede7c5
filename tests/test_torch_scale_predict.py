"""Prediction at the scale configuration's widths (VC, m=1000, d=5, psi
(n, d, d)) in gpz_tpu_torch against gpz_tpu in float64 on the CPU, and the
kernel wrappers' refusal of a call whose (n, m) output passes what one
launch takes.

The pair pass of a complete row at m=1000 runs 10**6 pairs as bases through
the design-matrix function, ~1.5 us a pair on one CPU thread through its
plain version, so the model is served 4 rows here; rows with NaNs (64 or
1,000 mixture components x 10**6 pairs a row) are held on the card only
(chip_smoke.py phase 20). Both packages serve one model, the port's init
saved and loaded by gpz_tpu. Tolerance: GOLDEN_TOL's float64 bounds, set
for a trained point (measured here: mu 7.6e-16 relative, sigma 1.3e-13,
nu 5.0e-15 absolute).
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu
from gpz_tpu.checkpoint import load_model

import gpz_tpu_torch
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.ops import vc_phi

from make_torch_port_golden import GOLDEN_TOL, OUTPUTS

M = 1000
TRAIN_ROWS = 512
SERVED = slice(2000, 2004)


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """(gpz_tpu's, the port's) predictions of 4 complete rows by one model:
    the port's init on TRAIN_ROWS rows of synthetic_sdss(seed=3), saved and
    loaded by gpz_tpu (format v1), so both serve the same parameters and
    posterior."""
    mags, errs, z = synthetic_sdss(n=SERVED.stop, filters=5, seed=3)
    psi = errs ** 2
    tr = slice(0, TRAIN_ROWS)
    tm = gpz_tpu_torch.init(mags[tr], z[tr], "VC", M, heteroscedastic=True,
                            psi=psi[tr], seed=1, dtype="float64",
                            device="cpu")
    path = str(tmp_path_factory.mktemp("scale") / "m1000.npz")
    gpz_tpu_torch.save_model(tm, path)
    jm = load_model(path)
    return (gpz_tpu.predict(mags[SERVED], jm, psi=psi[SERVED]),
            gpz_tpu_torch.predict(mags[SERVED], tm, psi=psi[SERVED]))


@pytest.mark.parametrize("output", OUTPUTS)
def test_predict_complete_rows_at_m1000_matches_jax(output, predictions):
    want, got = (getattr(p, output) for p in predictions)
    rtol, atol = GOLDEN_TOL["float64"][output]
    assert got.shape == want.shape == (SERVED.stop - SERVED.start, 1)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def meta_call(n, m, d=5):
    """vc_phi._check's arguments for n rows and m bases, as meta tensors
    (shapes without storage)."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.float64, device="meta")

    return t(n, d), t(n, d, d), t(m, d), t(m, d, d), t(m), t(n, m)


@pytest.mark.parametrize("n, m", [(2**21 + 1, 1024), (10**6, 2148),
                                  (2**31, 1)])
def test_a_call_past_2_31_pairs_raises(n, m):
    X, psi, P, Sigma, lds, g = meta_call(n, m)
    with pytest.raises(ValueError, match="pairs"):
        vc_phi._check(X, psi, P, Sigma, lds)
    with pytest.raises(ValueError, match="pairs"):
        vc_phi._check(X, psi, P, Sigma, g=g)


@pytest.mark.parametrize("n, m", [(10**6, 1000), (2**21 - 1, 1024),
                                  (2**31 - 1, 1)])
def test_a_call_up_to_2_31_pairs_passes_the_size_check(n, m):
    """The training shape of the scale configuration (10**9 pairs) and the
    largest count a C int holds pass the size check; the meta device is then
    refused as any device but the CPU's and CUDA's is."""
    X, psi, P, Sigma, lds, g = meta_call(n, m)
    with pytest.raises(ValueError, match="unsupported device"):
        vc_phi._check(X, psi, P, Sigma, lds, g)
