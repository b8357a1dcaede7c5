"""The scale configuration's problem and init (BASELINE.json configs[4]:
VC, m=1000, d=5, heteroscedastic, psi (n, d, d)), gpz_tpu_torch against
gpz_tpu in float64 on the CPU.

make_torch_port_golden.scale_problem, the rows that chip_smoke.py phase 20
and the scale golden file share, drawn with gpz_tpu's synthetic_sdss and
with the port's copy: the same arrays bit for bit, split as configs[4]'s
per-card problem (1,000,000 training rows, 100,000 validation rows, 20,000
served complete, 1,000 of them served with NaNs). init at m=1000 on 3,000
rows: host NumPy in both packages, its parameters equal bit for bit (one
block of rows is gpz_tpu's expression); the length-scale heuristic in
several blocks of rows rounds each block's matrix product and sum, ~1e-16
relative (held to 1e-14).
"""

import importlib

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
from jax.flatten_util import ravel_pytree
import pytest

import gpz_tpu
from gpz_tpu import datautils as jdu
from gpz_tpu.data import synthetic_sdss as jax_synthetic_sdss

import gpz_tpu_torch
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.model import _mean_sq_dist

from make_torch_port_golden import (
    SCALE_MISSING, SCALE_NAN_PICKS, SCALE_SERVE, SCALE_TRAIN, SCALE_VALID,
    scale_nan_picks, scale_problem,
)

M = 1000
INIT_ROWS = 3000

model_mod = importlib.import_module("gpz_tpu_torch.model")


def problem(n):
    """(X, Y, psi) of the first n rows of synthetic_sdss(seed=3), the scale
    configuration's generator, psi = errs**2."""
    mags, errs, z = synthetic_sdss(n=n, filters=5, seed=3)
    return mags, z, errs ** 2


@pytest.fixture(scope="module")
def problems():
    return scale_problem(jax_synthetic_sdss), scale_problem(synthetic_sdss)


def test_both_packages_draw_the_same_rows(problems):
    (jX, jY, jpsi, jtr, jva, js, (jpos, jXm)), \
        (X, Y, psi, tr, va, s, (pos, Xm)) = problems
    for a, b in ((jX, X), (jY, Y), (jpsi, psi), (jtr, tr), (jva, va),
                 (js, s), (jpos, pos)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.isnan(jXm), np.isnan(Xm))
    np.testing.assert_array_equal(np.nan_to_num(jXm), np.nan_to_num(Xm))


def test_the_split_is_configs_4s(problems):
    X, Y, psi, tr, va, served, (pos, Xm) = problems[1]
    n = SCALE_TRAIN + SCALE_VALID + SCALE_SERVE
    assert X.shape == (n, 5) and Y.shape == (n,) and psi.shape == (n, 5)
    assert tr.sum() == SCALE_TRAIN and tr[:SCALE_TRAIN].all()
    assert va.sum() == SCALE_VALID and not (tr & va).any()
    np.testing.assert_array_equal(served, np.arange(n - SCALE_SERVE, n))
    assert not (tr[served] | va[served]).any()
    assert np.isfinite(X).all() and (psi > 0).all()
    assert Xm.shape == (SCALE_MISSING, 5) and len(pos) == SCALE_MISSING
    nan = np.isnan(Xm)
    assert nan.any(axis=1).all()
    np.testing.assert_array_equal(np.where(nan, 0.0, Xm),
                                  np.where(nan, 0.0, X[served[pos]]))


def test_the_golden_rows_with_nans_cover_each_pattern(problems):
    Xm = problems[1][6][1]
    picks = scale_nan_picks(Xm)
    lost = [tuple(np.where(np.isnan(Xm[i]))[0]) for i in picks]
    want = [bands for bands, count in SCALE_NAN_PICKS for _ in range(count)]
    assert lost == want


def test_init_at_m1000_equals_gpz_tpus_bit_for_bit():
    X, Y, psi = problem(INIT_ROWS)
    kw = dict(heteroscedastic=True, psi=psi, seed=1, dtype="float64")
    jm = gpz_tpu.init(X, Y, "VC", M, **kw)
    tm = gpz_tpu_torch.init(X, Y, "VC", M, device="cpu", **kw)
    assert model_mod.INIT_BLOCK_ROWS >= INIT_ROWS   # one block
    np.testing.assert_array_equal(
        tm.last.params.flatten()[0].numpy(),
        np.asarray(ravel_pytree(jm.last.params)[0]))
    # the posterior solves a 1000 x 1000 system of 3,000 rows in each
    # package's own order: held to its largest weight (measured 1.5e-12 of
    # 2.2e-2)
    w = np.asarray(jm.last.post.w)
    np.testing.assert_allclose(tm.last.post.w.numpy(), w, rtol=0,
                               atol=1e-8 * np.abs(w).max())


@pytest.mark.parametrize("block", [700, 3000, 65536])
def test_length_scale_distances_in_row_blocks(block, monkeypatch):
    """_mean_sq_dist over blocks of rows against gpz_tpu.init's one (n, m)
    expression: the same bits for one block, ~1e-16 relative for several."""
    X, _, _ = problem(INIT_ROWS)
    mu, cov, Ti = jdu.pca_whiten_np(X)
    Xl = jdu.fill_linear_np(X, mu, cov)
    P = (np.random.default_rng(1).random((M, 5)) - 0.5) @ Ti + mu[None, :]
    want = np.abs((Xl**2).sum(1)[:, None] + (P**2).sum(1)[None, :]
                  - 2.0 * Xl @ P.T).mean(axis=0)
    monkeypatch.setattr(model_mod, "INIT_BLOCK_ROWS", block)
    got = _mean_sq_dist(Xl, P)
    if block >= INIT_ROWS:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
