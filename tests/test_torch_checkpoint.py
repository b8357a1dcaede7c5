"""gpz_tpu_torch's checkpoint format, weight carry-across and NumPy copies
against gpz_tpu's, and its independence from JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu
from gpz_tpu import checkpoint as jckpt
from gpz_tpu import datautils as jdu
from gpz_tpu import metrics as jmetrics
from gpz_tpu.data import photoz as jphotoz

import gpz_tpu_torch
from gpz_tpu_torch import cli
from gpz_tpu_torch import datautils as tdu
from gpz_tpu_torch import metrics as tmetrics
from gpz_tpu_torch.data import photoz as tphotoz
from gpz_tpu_torch.inference import sample_posterior
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
    assert_same_model(gpz_tpu_torch.load_model(CHECKPOINT, device="cpu"),
                      jckpt.load_model(CHECKPOINT))


def test_save_model_round_trips_through_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu")
    gpz_tpu_torch.save_model(model, path)
    assert_same_model(model, jckpt.load_model(path))
    # and back
    assert_same_model(gpz_tpu_torch.load_model(path, device="cpu"), jckpt.load_model(path))


@pytest.mark.parametrize("method", ["GL", "VL", "GD", "VD", "GC", "VC"])
def test_six_gamma_shapes_cross_both_ways(method, tmp_path, monkeypatch):
    """A model of each method, initialized on rows with NaNs by gpz_tpu, is
    saved by gpz_tpu and loaded here with equal arrays (gamma in its
    canonical shape, priors included), saved here and loaded by gpz_tpu, and
    from_numpy / to_numpy carry its parameters unchanged."""
    rng = np.random.default_rng(11)
    X = rng.standard_normal((30, 3))
    X[::5, 1] = np.nan
    Y = np.sin(X[:, 0]) + 0.1 * rng.standard_normal(30)
    jmodel = gpz_tpu.init(X, Y, method, 4, seed=2, dtype="float64")
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jckpt.save_model(jmodel, jpath)
    model = gpz_tpu_torch.load_model(jpath, device="cpu")
    assert_same_model(model, jmodel)
    assert tuple(model.last.params.gamma.shape) == jmodel.cfg.gamma_shape
    gpz_tpu_torch.save_model(model, tpath)
    assert_same_model(model, jckpt.load_model(tpath))
    arrays = {k: np.asarray(v) for k, v in dataclasses.asdict(
        jmodel.last.params).items()}
    params = GPzParams.from_numpy(arrays, "cpu", torch.float64)
    for k, v in params.to_numpy().items():
        np.testing.assert_array_equal(v, arrays[k])
    # both packages compute the same prediction from the same arrays (with
    # gpz_tpu's mixture scans in float64, as the port's are)
    monkeypatch.setenv("GPZ_MIX_DTYPE", "float64")
    want = gpz_tpu.predict(X, jmodel)
    got = gpz_tpu_torch.predict(X, model)
    np.testing.assert_allclose(got.mu, np.asarray(want.mu), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.sigma, np.asarray(want.sigma), rtol=1e-9,
                               atol=1e-12)


def test_train_with_checkpoints_segments_saves_and_resumes(tmp_path):
    """6 iterations in segments of 2: a checkpoint after every segment, the
    same number of iterations in all, and a second call resumes from the
    file instead of the model it is handed (gpz_tpu.checkpoint's
    semantics)."""
    rng = np.random.default_rng(12)
    X = rng.standard_normal((50, 2))
    X[::6, 0] = np.nan
    Y = np.sin(2 * X[:, 1]) + 0.1 * rng.standard_normal(50)
    path = str(tmp_path / "run.npz")
    model0 = gpz_tpu_torch.init(X, Y, "VD", 4, seed=1, dtype="float64",
                                device="cpu")
    seen = []
    real = gpz_tpu_torch.checkpoint.save_model

    def spy(model, p):
        seen.append(model.fit_info["iterations"])
        real(model, p)

    gpz_tpu_torch.checkpoint.save_model = spy
    try:
        out = gpz_tpu_torch.train_with_checkpoints(
            model0, X, Y, checkpoint_path=path, segment_iters=2, max_iter=6,
            verbose=False)
    finally:
        gpz_tpu_torch.checkpoint.save_model = real
    assert seen == [2, 2, 2] and os.path.exists(path)
    saved = gpz_tpu_torch.load_model(path, device="cpu")
    torch.testing.assert_close(saved.last.params.P, out.last.params.P,
                               rtol=0, atol=0)
    # the same segments by hand
    by_hand = model0
    for _ in range(3):
        by_hand = gpz_tpu_torch.train(by_hand, X, Y, max_iter=2,
                                      verbose=False)
    torch.testing.assert_close(by_hand.last.params.P, out.last.params.P,
                               rtol=0, atol=0)
    # resume: starts from the file, not from model0
    more = gpz_tpu_torch.train_with_checkpoints(
        model0, X, Y, checkpoint_path=path, segment_iters=5, max_iter=1,
        verbose=False)
    again = gpz_tpu_torch.train(saved, X, Y, max_iter=1, verbose=False)
    torch.testing.assert_close(more.last.params.P, again.last.params.P,
                               rtol=0, atol=0)
    fresh = gpz_tpu_torch.train_with_checkpoints(
        model0, X, Y, checkpoint_path=path, segment_iters=5, max_iter=1,
        resume=False, verbose=False)
    one = gpz_tpu_torch.train(model0, X, Y, max_iter=1, verbose=False)
    torch.testing.assert_close(fresh.last.params.P, one.last.params.P,
                               rtol=0, atol=0)


def test_predict_config_is_gpz_tpus():
    assert dataclasses.asdict(gpz_tpu_torch.PredictConfig()) == \
        dataclasses.asdict(gpz_tpu.config.PredictConfig())


def test_from_numpy_carries_jax_weights():
    """Parameters carried across with from_numpy serve exactly what the
    loaded checkpoint serves, and to_numpy gives them back."""
    jmodel = jckpt.load_model(CHECKPOINT)
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu")
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
        "gpz_tpu_torch.metrics, gpz_tpu_torch.cli, gpz_tpu_torch.ensemble, "
        "gpz_tpu_torch.native, gpz_tpu_torch.optim, gpz_tpu_torch.bench, "
        "gpz_tpu_torch.inference, gpz_tpu_torch.parallel, "
        "gpz_tpu_torch.bench_convergence, gpz_tpu_torch.demos.demo_sinc, "
        "gpz_tpu_torch.demos.demo_2d, gpz_tpu_torch.demos.demo_photoz\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'gpz_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert gpz_tpu.__name__ == "gpz_tpu"  # the reference, imported here only


def test_top_level_names_are_gpz_tpus_and_leave_jax_out():
    """Every name of gpz_tpu's __all__ is in gpz_tpu_torch's, as the port's
    own object (Dataset and the linalg, metrics and datautils modules among
    them), and importing them imports no JAX."""
    import gpz_tpu_torch

    assert set(gpz_tpu.__all__) <= set(gpz_tpu_torch.__all__)
    for name in gpz_tpu_torch.__all__:
        obj = getattr(gpz_tpu_torch, name)
        assert getattr(obj, "__module__", getattr(obj, "__name__", "")
                       ).startswith("gpz_tpu_torch"), name
    code = (
        "import sys\n"
        "from gpz_tpu_torch import Dataset, datautils, linalg, metrics\n"
        "from gpz_tpu_torch import *\n"
        "assert Dataset.__module__ == 'gpz_tpu_torch.dataset'\n"
        "bad = sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'gpz_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_default_to_the_gpu_and_never_to_the_cpu(tmp_path):
    """load_model, init, fit_ensemble and the CLI's train without a device
    go to the CUDA device, and sample_posterior runs where load_model put
    the model: on a machine without one they raise torch's error and return
    nothing that lives on the CPU."""
    if torch.cuda.is_available():
        model = gpz_tpu_torch.load_model(CHECKPOINT)
        assert model.best.params.P.device.type == "cuda"
        return
    rng = np.random.default_rng(0)
    X, Y = rng.standard_normal((40, 2)), rng.standard_normal(40)
    csv = tmp_path / "in.csv"
    np.savetxt(csv, np.column_stack([X, np.full_like(X, 0.1), Y]),
               delimiter=",")
    ckpt = tmp_path / "out.npz"
    for call in (lambda: gpz_tpu_torch.load_model(CHECKPOINT),
                 lambda: gpz_tpu_torch.init(X, Y, "VC", 4),
                 lambda: gpz_tpu_torch.fit_ensemble(X, Y, "VL", 4,
                                                    n_restarts=2, max_iter=1),
                 lambda: cli.main(["train", str(csv), "--out", str(ckpt),
                                   "--m", "4", "--max-iter", "1"]),
                 lambda: sample_posterior(gpz_tpu_torch.load_model(CHECKPOINT),
                                          X, Y, num_warmup=2, num_samples=2)):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            call()
    assert not ckpt.exists()
