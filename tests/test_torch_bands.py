"""Wide-band surveys in gpz_tpu_torch on the CPU: the full-covariance family
past d = 8, where the port's kernel pair runs its wide variant on the card.

The plain twins (which CPU tensors run) against tests/test_ops.py's dense
reference and its autodiff at d in {9, 12, 16, 32}, and VC at d = 9 through
init -> train -> predict against gpz_tpu in float64, with psi (n, d), with a
correlated psi (n, d, d) and on rows with NaNs. gpz_tpu sends d > 6 to its
jnp path; the port sends every d to the kernels on the card (chip_smoke.py
phase 21 holds them to these twins there).

Tolerances: the twins as tests/test_torch_vc_phi.py holds them at d <= 8
(rtol 1e-8 / atol 1e-10 forward and 1e-7 / 1e-9 backward, rounding of
well-conditioned systems). End to end, tests/test_torch_train.py's: init is
host NumPy in both packages and its posterior goes through the two
packages' solves (1e-9); the optimizers take the same branches (equal
evaluation counts) and the f trace agrees to 1e-7 relative, the trained
parameters to 1e-5 and the predictions to 1e-4 (measured here: predictions
within 1e-9 relative).
"""

import functools

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

import gpz_tpu
from gpz_tpu.data import synthetic_sdss

import gpz_tpu_torch
from gpz_tpu_torch.ops import vc_phi

from make_torch_port_golden import OUTPUTS, inject_missing
from test_ops import make_inputs as jax_inputs, ref_lnphi
from test_torch_train import (
    POSTERIOR, PREDICTED, TRACE, TRAINED, assert_same_pset,
)

F64 = dict(rtol=1e-8, atol=1e-10)
BWD_F64 = dict(rtol=1e-7, atol=1e-9)
WIDE = (9, 12, 16, 32)

BANDS, M, ITERS = 9, 10, 3
ROWS, TRAIN_ROWS, SERVED = 300, 200, 100


def wide_case(d, n=24, m=7):
    """tests/test_ops.py::make_inputs at (n, d, m) from a numpy seed, and a
    cotangent (n, m)."""
    rng = np.random.default_rng(d)
    arrays = tuple(np.array(a) for a in jax_inputs(rng, n, d, m))
    return arrays, rng.standard_normal((n, m))


@functools.lru_cache(maxsize=None)
def reference(d):
    """(inputs, cotangent, lnPHI, dP, dSigma) of wide_case(d) by the dense
    reference and its autodiff (one jitted VJP per d)."""
    arrays, g = wide_case(d)
    X, psi, P, Sigma, logdet = map(jnp.asarray, arrays)

    @jax.jit
    def fwd_vjp(p, s, ct):
        out, vjp = jax.vjp(lambda p, s: ref_lnphi(X, psi, p, s, logdet), p, s)
        return (out, *vjp(ct))

    return (arrays, g, *map(np.asarray, fwd_vjp(P, Sigma, jnp.asarray(g))))


@pytest.mark.parametrize("d", WIDE)
def test_wide_plain_forward_matches_reference(d):
    arrays, _, want, _, _ = reference(d)
    got = vc_phi.vc_lnphi_complete(*map(torch.from_numpy, arrays)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F64)


@pytest.mark.parametrize("d", WIDE)
def test_wide_plain_backward_matches_reference_autodiff(d):
    arrays, g, _, *want = reference(d)
    dP, dS = vc_phi.vc_lnphi_bwd(*map(torch.from_numpy, arrays[:4]),
                                 torch.from_numpy(g))
    np.testing.assert_allclose(dP.numpy(), want[0], **BWD_F64)
    np.testing.assert_allclose(dS.numpy(), want[1], **BWD_F64)
    np.testing.assert_array_equal(dS.numpy(), dS.transpose(1, 2).numpy())


def band_problem(full_psi):
    """ROWS rows of nine bands (TRAIN_ROWS train, the rest validate), then
    SERVED more with NaNs injected; psi diag errs**2 as (n, d), or with the
    errors correlated between bands as (n, d, d)."""
    mags, errs, z = synthetic_sdss(n=ROWS + SERVED, filters=BANDS, seed=2)
    psi = errs ** 2
    if full_psi:
        lag = np.abs(np.subtract.outer(np.arange(BANDS), np.arange(BANDS)))
        psi = errs[:, :, None] * errs[:, None, :] * 0.5 ** lag
    tr = np.zeros(ROWS, bool)
    tr[:TRAIN_ROWS] = True
    Xp = inject_missing(mags[ROWS:])
    assert np.isnan(Xp).any(axis=1).sum() > 20
    return mags[:ROWS], z[:ROWS], psi, tr, Xp


@pytest.fixture(scope="module", params=["psi_nd", "psi_ndd"])
def nine_bands(request):
    """(JAX models, port models, predictions) of VC m=10 at d = 9: init,
    ITERS iterations with validation, then the served rows (some with NaNs)
    predicted by both, gpz_tpu's mixture scans in float64."""
    mp = pytest.MonkeyPatch()
    mp.setenv("GPZ_MIX_DTYPE", "float64")
    X, Y, psi, tr, Xp = band_problem(request.param == "psi_ndd")
    kw = dict(training=tr, validation=~tr, psi=psi[:ROWS], verbose=False,
              max_iter=ITERS, max_attempts=50)
    ikw = dict(training=tr, psi=psi[:ROWS], seed=1, dtype="float64")
    j0 = gpz_tpu.init(X, Y, "VC", M, **ikw)
    t0 = gpz_tpu_torch.init(X, Y, "VC", M, device="cpu", **ikw)
    j1 = gpz_tpu.train(j0, X, Y, **kw)
    t1 = gpz_tpu_torch.train(t0, X, Y, **kw)
    preds = (gpz_tpu.predict(Xp, j1, psi=psi[ROWS:]),
             gpz_tpu_torch.predict(Xp, t1, psi=psi[ROWS:]))
    yield (j0, j1), (t0, t1), preds
    mp.undo()


def test_nine_band_init_equals_jax(nine_bands):
    (j0, _), (t0, _), _ = nine_bands
    assert t0.cfg.d == BANDS and t0.cfg.full_cov
    assert_same_pset(t0.last, j0.last, dict(rtol=0, atol=0), POSTERIOR)


def test_nine_band_train_takes_jaxs_trajectory(nine_bands):
    (_, j1), (_, t1), _ = nine_bands
    jfit, fit = j1.fit_info, t1.fit_info
    assert fit["iterations"] == jfit["iterations"] == ITERS
    assert fit["fun_evals"] == jfit["fun_evals"]
    k = ITERS + 1
    np.testing.assert_array_equal(fit["trace"]["fevals"],
                                  np.asarray(jfit["trace"]["fevals"])[:k])
    np.testing.assert_allclose(fit["trace"]["f"],
                               np.asarray(jfit["trace"]["f"])[:k], **TRACE)
    assert_same_pset(t1.best, j1.best, TRAINED, TRAINED)


@pytest.mark.parametrize("rows", ["complete", "with_nans"])
def test_nine_band_predict_matches_jax(nine_bands, rows):
    _, _, (jp, tp) = nine_bands
    nan = np.isnan(inject_missing(np.zeros((SERVED, BANDS)))).any(axis=1)
    sel = nan if rows == "with_nans" else ~nan
    for k in OUTPUTS:
        got, want = getattr(tp, k)[sel], np.asarray(getattr(jp, k))[sel]
        assert np.isfinite(got).all(), k
        np.testing.assert_allclose(got, want, err_msg=k, **PREDICTED)
