"""gpz_tpu_torch's checkpoint format, weight carry-across and NumPy copies
against gpz_tpu's, and its independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gpz_tpu
from gpz_tpu import checkpoint as jckpt
from gpz_tpu import datautils as jdu
from gpz_tpu import metrics as jmetrics
from gpz_tpu.data import photoz as jphotoz

import gpz_tpu_torch
from gpz_tpu_torch import datautils as tdu
from gpz_tpu_torch import metrics as tmetrics
from gpz_tpu_torch.data import photoz as tphotoz
from gpz_tpu_torch.params import GPzParams

from make_torch_port_golden import CHECKPOINT, ROOT

SETS = ("last", "best")


def jax_arrays(pset):
    """{name: array} of a gpz_tpu ParamSet, named as in the checkpoint."""
    arrays = {k: v for k, v in dataclasses.asdict(pset.params).items()
              if v is not None}
    arrays.update(w=pset.post.w, iSigma_w=pset.post.iSigma_w,
                  logdet=pset.post.logdet, priors=pset.priors)
    return {k: np.asarray(v) for k, v in arrays.items()}


def port_arrays(pset):
    arrays = pset.params.to_numpy()
    arrays.update(w=pset.post.w, iSigma_w=pset.post.iSigma_w,
                  logdet=pset.post.logdet, priors=pset.priors)
    return {k: np.asarray(v) for k, v in arrays.items()}


def assert_same_model(port_model, jax_model):
    assert dataclasses.asdict(port_model.cfg) == dataclasses.asdict(
        jax_model.cfg)
    for name in ("muX", "sdX", "muY"):
        np.testing.assert_array_equal(getattr(port_model, name),
                                      getattr(jax_model, name))
    for s in SETS:
        t, j = getattr(port_model, s), getattr(jax_model, s)
        assert t.score == j.score
        ta, ja = port_arrays(t), jax_arrays(j)
        assert sorted(ta) == sorted(ja)
        for k in ja:
            assert ta[k].dtype == ja[k].dtype, k
            np.testing.assert_array_equal(ta[k], ja[k], err_msg=f"{s}.{k}")


def test_load_model_gives_jax_arrays():
    assert_same_model(gpz_tpu_torch.load_model(CHECKPOINT),
                      jckpt.load_model(CHECKPOINT))


def test_save_model_round_trips_through_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    model = gpz_tpu_torch.load_model(CHECKPOINT)
    gpz_tpu_torch.save_model(model, path)
    assert_same_model(model, jckpt.load_model(path))
    # and back
    assert_same_model(gpz_tpu_torch.load_model(path), jckpt.load_model(path))


def test_from_numpy_carries_jax_weights():
    """Parameters carried across with from_numpy serve exactly what the
    loaded checkpoint serves, and to_numpy gives them back."""
    jmodel = jckpt.load_model(CHECKPOINT)
    model = gpz_tpu_torch.load_model(CHECKPOINT)
    arrays = {k: np.asarray(v)
              for k, v in dataclasses.asdict(jmodel.best.params).items()}
    params = GPzParams.from_numpy(arrays, "cpu", torch.float32)
    for k, v in params.to_numpy().items():
        np.testing.assert_array_equal(v, arrays[k])
    carried = dataclasses.replace(
        model, best=dataclasses.replace(model.best, params=params))
    rng = np.random.default_rng(0)
    X = model.muX + model.sdX * rng.standard_normal((40, 5))
    psi = np.full((40, 5), 0.01)
    a = gpz_tpu_torch.predict(X, model, psi=psi)
    b = gpz_tpu_torch.predict(X, carried, psi=psi)
    for k in ("mu", "sigma", "nu", "beta_i", "gamma", "phi"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("missing_frac", [0.0, 0.2])
def test_synthetic_sdss_is_gpz_tpus(missing_frac):
    got = tphotoz.synthetic_sdss(n=500, seed=3, missing_frac=missing_frac)
    want = jphotoz.synthetic_sdss(n=500, seed=3, missing_frac=missing_frac)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fractions", [(0.2, 0.2, 0.6), (100, 50, 25)],
                         ids=["fractions", "counts"])
def test_split_is_gpz_tpus(fractions):
    got = tdu.split(400, *fractions, np.random.default_rng(7))
    want = jdu.split(400, *fractions, np.random.default_rng(7))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("method", ["normal", "normalized", "balanced"])
def test_get_omega_is_gpz_tpus(method):
    z = np.random.default_rng(8).gamma(2.2, 0.13, size=300)
    np.testing.assert_array_equal(tdu.get_omega(z, method, 0.1),
                                  jdu.get_omega(z, method, 0.1))


@pytest.mark.parametrize("shape", [(30,), (30, 1), (30, 4), (30, 4, 4)],
                         ids=["scalar", "column", "diag", "full"])
@pytest.mark.parametrize("full_cov", [True, False], ids=["cov", "diag"])
def test_fix_psi_is_gpz_tpus(shape, full_cov):
    rng = np.random.default_rng(9)
    psi = rng.random(shape)
    sdX = rng.uniform(0.5, 2.0, 4)
    np.testing.assert_array_equal(tdu.fix_psi(psi, 30, sdX, full_cov),
                                  jdu.fix_psi(psi, 30, sdX, full_cov))


def test_normalization_stats_and_metrics_are_gpz_tpus():
    mags, _, z = tphotoz.synthetic_sdss(n=300, seed=4, missing_frac=0.1)
    for g, w in zip(tdu.normalization_stats(mags, z),
                    jdu.normalization_stats(mags, z)):
        np.testing.assert_array_equal(g, w)
    mu = z + np.random.default_rng(5).normal(0, 0.05, z.shape)
    sigma = np.full_like(z, 0.01)
    for fn in ("sq_error", "log_likelihood", "fr15", "fr05", "bias"):
        np.testing.assert_array_equal(
            tmetrics.cumulative_by_confidence(z, mu, sigma,
                                              getattr(tmetrics, fn)),
            jmetrics.cumulative_by_confidence(z, mu, sigma,
                                              getattr(jmetrics, fn)))


def test_import_leaves_jax_out():
    code = (
        "import sys, gpz_tpu_torch, gpz_tpu_torch.data, gpz_tpu_torch.ops, "
        "gpz_tpu_torch.metrics\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'gpz_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert gpz_tpu.__name__ == "gpz_tpu"  # the reference, imported here only
