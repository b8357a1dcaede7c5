"""Regenerate the golden files that hold gpz_tpu_torch against gpz_tpu where
JAX is absent (chip_smoke.py on the GPU).

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py [photoz] [train]

With no argument both files are written.

tests/data/torch_port_golden_photoz.npz holds gpz_tpu.predict's outputs (mu, sigma, nu, beta_i, gamma) for
the first 256 test rows of the photo-z parity data
(benchmarks/parity_numbers.py::photoz_data: synthetic_sdss(n=20000, seed=1),
psi = errs**2, 20/20/60 split drawn from default_rng(1)), served by the
trained VC m=100 checkpoint benchmarks/photoz_trained_m100.npz twice: at the
checkpoint's float32, and with every parameter cast to float64. gpz_tpu_torch
is held against it by chip_smoke.py, and tests/test_torch_predict.py checks
that JAX still reproduces it.

tests/data/torch_port_golden_train.npz holds the training path on the problem
of bench_convergence.py (synthetic_sdss(80000, filters=5, seed=1), psi =
errs**2, first 70,000 rows train, last 10,000 validate, VC m=100, float64,
seed 1), computed by gpz_tpu on the CPU:

  init.flat                 the flat parameter vector of gpz_tpu.init
  init.nlml, init.grad      nlog_ml and its flat gradient at that point, on
                            the first OBJECTIVE_ROWS training rows
  trained.nlml, trained.grad   the same at the trained checkpoint cast to
                            float64 (rows normalized by the checkpoint's stats)
  trace.f, trace.fevals, trace.valid_ll   gpz_tpu.train(max_iter=TRACE_ITERS,
                            max_attempts=50) on all 70,000 rows, iterations
                            0..TRACE_ITERS (a few minutes of CPU time)
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_golden_photoz.npz")
GOLDEN_TRAIN = os.path.join(HERE, "data", "torch_port_golden_train.npz")
CHECKPOINT = os.path.join(ROOT, "benchmarks", "photoz_trained_m100.npz")
SEED = 1
N = 20_000
ROWS = 256
OUTPUTS = ("mu", "sigma", "nu", "beta_i", "gamma")
DTYPES = ("float32", "float64")

#: how far gpz_tpu_torch may be from these outputs, {dtype: {output: (rtol,
#: atol)}}, on the CPU and on the GPU alike. float64: two correct float64
#: pipelines differ at this trained point by up to ~4e-9 relative in PHI
#: (cond(Sigma) ~ 5e7 amplifies rounding differences in Sigma and in the
#: quadratic forms), which gives mu and beta_i ~6e-9 relative; nu and gamma
#: are differences of sums of ~10 with values down to 1e-6, so they get
#: absolute bounds (measured up to 8e-11), and sigma = nu + beta_i + gamma
#: carries their absolute error. float32 (the checkpoint's dtype): the
#: contractions against w, v and iSigma_w run in float32, ~1e-7 absolute.
GOLDEN_TOL = {
    "float64": {"mu": (1e-8, 0.0), "beta_i": (1e-8, 0.0),
                "sigma": (1e-8, 1e-10), "nu": (0.0, 1e-10),
                "gamma": (0.0, 1e-10)},
    "float32": {"mu": (1e-5, 0.0), "beta_i": (1e-4, 0.0),
                "sigma": (1e-4, 5e-6), "nu": (0.0, 5e-6),
                "gamma": (0.0, 5e-6)},
}


def golden_rows(synthetic_sdss, split):
    """(row indices, X, psi, z) of the first ROWS test rows, drawn with the
    given package's copies of synthetic_sdss and split."""
    mags, errs, z = synthetic_sdss(n=N, seed=SEED)
    rng = np.random.default_rng(SEED)
    _, _, test = split(len(z), 0.2, 0.2, 0.6, rng)
    idx = np.where(test)[0][:ROWS]
    return idx, mags[idx], errs[idx] ** 2, z[idx]


def jax_predictions():
    """(row indices, {dtype: {output: (ROWS, 1) array}}) from
    gpz_tpu.predict."""
    sys.path.insert(0, ROOT)
    import gpz_tpu
    from gpz_tpu.checkpoint import load_model
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.model import ParamSet
    from gpz_tpu.objective import Posterior

    def cast(pset):
        f64 = lambda a: a.astype(np.float64)  # noqa: E731
        post = Posterior(w=f64(pset.post.w), iSigma_w=f64(pset.post.iSigma_w),
                         logdet=f64(pset.post.logdet))
        return ParamSet(params=pset.params.astype(np.float64), post=post,
                        priors=f64(pset.priors), score=pset.score)

    model = load_model(CHECKPOINT)
    models = {
        "float32": model,
        "float64": dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, dtype="float64"),
            last=cast(model.last), best=cast(model.best),
        ),
    }
    idx, X, psi, _ = golden_rows(synthetic_sdss, gpz_tpu.datautils.split)
    out = {}
    for dt, mdl in models.items():
        pred = gpz_tpu.predict(X, mdl, psi=psi)
        out[dt] = {k: np.asarray(getattr(pred, k)) for k in OUTPUTS}
    return idx, out


def load_golden() -> dict:
    """{dtype: {output: array}}, plus "rows" (the test-row indices)."""
    with np.load(GOLDEN) as z:
        out = {dt: {k: z[f"{dt}.{k}"] for k in OUTPUTS} for dt in DTYPES}
        out["rows"] = z["rows"]
    return out


# --- the training path (bench_convergence.py's problem) ---

N_TRAIN = 70_000
N_VALID = 10_000
M = 100
OBJECTIVE_ROWS = 4096
TRACE_ITERS = 5
MAX_ATTEMPTS = 50
POINTS = ("init", "trained")

#: how far gpz_tpu_torch may be from the training golden values, on the CPU
#: and on the GPU alike: (rtol, atol) per entry, an absolute bound for
#: init.flat. init is host NumPy in both packages (measured: equal). At the
#: init point the objective is well conditioned: value and gradient agree to
#: rounding (measured 8e-15 and 8e-14). At the trained point cond(Sigma) ~
#: 5e7: the value still agrees to 2e-11, but the gradient in gamma is a
#: cancelling sum chained through Sigma = (gamma' gamma)^-1, and float64
#: itself resolves it only to ~2e-6 absolute (max |gradient| 0.026): the
#: port against JAX differs by 1.8e-6, and the port against itself with the
#: row blocks of its sums cut differently by 1.4e-6; every other block of
#: the gradient agrees to 4e-11. The f trace of the first TRACE_ITERS
#: iterations stays in the well-conditioned regime (measured 1.1e-12 on an
#: H100 against JAX on the CPU).
TRAIN_TOL = {
    "init.flat": 1e-9,
    "init.nlml": (1e-10, 0.0), "init.grad": (1e-8, 1e-11),
    "trained.nlml": (1e-9, 0.0), "trained.grad": (1e-6, 2e-5),
    "trace.f": (1e-7, 0.0),
}


def train_problem(synthetic_sdss):
    """(X, Y, psi, training, validation) of bench_convergence.py, drawn with
    the given package's copy of synthetic_sdss."""
    mags, errs, z = synthetic_sdss(N_TRAIN + N_VALID, filters=5, seed=SEED)
    tr = np.zeros(len(z), bool)
    va = np.zeros(len(z), bool)
    tr[:N_TRAIN] = True
    va[N_TRAIN:] = True
    return mags, z, errs ** 2, tr, va


def objective_rows(training):
    """Boolean mask of the first OBJECTIVE_ROWS training rows."""
    rows = np.zeros(len(training), bool)
    rows[np.where(training)[0][:OBJECTIVE_ROWS]] = True
    return rows


def jax_training():
    """{name: array} of the training golden file, from gpz_tpu on the CPU."""
    sys.path.insert(0, ROOT)
    import jax
    from jax.flatten_util import ravel_pytree
    import gpz_tpu
    from gpz_tpu import datautils
    from gpz_tpu.checkpoint import load_model
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.model import _make_dataset
    from gpz_tpu.objective import nlog_ml

    X, Y, psi, tr, va = train_problem(synthetic_sdss)
    rows = objective_rows(tr)
    model = gpz_tpu.init(X, Y, "VC", M, heteroscedastic=True, training=tr,
                         psi=psi, seed=SEED, dtype="float64")
    trained = load_model(CHECKPOINT)
    points = {
        "init": (model, model.last.params),
        "trained": (
            dataclasses.replace(trained, cfg=dataclasses.replace(
                trained.cfg, dtype="float64")),
            trained.best.params.astype(np.float64),
        ),
    }
    out = {"init.flat": np.asarray(ravel_pytree(model.last.params)[0])}
    for name, (mdl, params) in points.items():
        Xn = (X - mdl.muX[None, :]) / mdl.sdX[None, :]
        Yc = Y[:, None] - mdl.muY[None, :]
        psi_c = datautils.fix_psi(psi, len(Y), mdl.sdX, mdl.cfg.full_cov)
        data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), rows,
                             np.float64)
        (f, _), g = jax.value_and_grad(
            lambda p: nlog_ml(p, data, mdl.cfg, complete=True),
            has_aux=True)(params)
        out[f"{name}.nlml"] = np.asarray(f)
        out[f"{name}.grad"] = np.asarray(ravel_pytree(g)[0])
    fit = gpz_tpu.train(model, X, Y, training=tr, validation=va, psi=psi,
                        max_iter=TRACE_ITERS, max_attempts=MAX_ATTEMPTS,
                        verbose=False).fit_info
    keep = slice(0, fit["iterations"] + 1)
    out["trace.f"] = np.asarray(fit["trace"]["f"])[keep]
    out["trace.fevals"] = np.asarray(fit["trace"]["fevals"])[keep]
    out["trace.valid_ll"] = np.asarray(
        fit["trace"]["extras"]["valid_ll"])[keep]
    return out


def load_golden_train() -> dict:
    with np.load(GOLDEN_TRAIN) as z:
        return {k: z[k] for k in z.files}


def main(which):
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    if "photoz" in which:
        idx, preds = jax_predictions()
        arrays = {f"{dt}.{k}": v for dt, p in preds.items()
                  for k, v in p.items()}
        np.savez_compressed(GOLDEN, rows=idx, seed=SEED, n=N, **arrays)
        print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")
    if "train" in which:
        np.savez_compressed(GOLDEN_TRAIN, seed=SEED, **jax_training())
        print(f"wrote {GOLDEN_TRAIN} ({os.path.getsize(GOLDEN_TRAIN)} "
              "bytes)")


if __name__ == "__main__":
    main(sys.argv[1:] or ["photoz", "train"])
