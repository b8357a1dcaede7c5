"""Regenerate the golden files that hold gpz_tpu_torch against gpz_tpu where
JAX is absent (chip_smoke.py on the GPU).

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py [photoz] [train] [missing] [inference] [demos] [scale] [bands]

With no argument all seven files are written. `... make_torch_port_golden.py
divergence [small|full]` writes nothing: it prints where demo_photoz's
training trajectories part (`photoz_divergence`).

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

tests/data/torch_port_golden_missing.npz holds the paths with missing values.
NaNs are injected by `inject_missing` (seed MISSING_SEED = 4: one permutation
of the rows; the first 25% lose band 0 (u), the next 10% band 4 (z), the next
5% both), regenerated by

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py missing

  rows, {float32,float64}.{mu,...}   gpz_tpu.predict's outputs, with its
                            mixture scans in float64 (GPZ_MIX_DTYPE), for
                            MISSING_ROWS of the first MISSING_SERVE_ROWS test
                            rows of the photo-z parity data after injection:
                            the first 16 rows of each of the four patterns
  init.flat, init.nlml, init.grad   gpz_tpu.init (VC m=100, float64, seed 1)
                            on the training problem after injection, and
                            nlog_ml with its gradient at that point on the
                            first OBJECTIVE_ROWS training rows
  vd.init.flat, vd.trace.f, vd.trace.fevals   VD m=100 with psi (n, d) and
                            get_omega(z, "balanced") weights on the same
                            rows: init, then gpz_tpu.train(max_iter=TRACE_ITERS)

tests/data/torch_port_golden_inference.npz holds posterior inference over the
hyperparameters of the trained checkpoint cast to float64, on its own 4,000
training rows of the photo-z parity data (`inference_problem`; omega =
get_omega(z, "normal", 0.1), prior_scale PRIOR_SCALE), from gpz_tpu on the
CPU in float64:

  flat                      the flat MAP (model.best's parameters)
  logp, grad                gpz_log_posterior and its gradient at the MAP and
                            at the JITTERED points of `jittered_points`, (4,)
                            and (4, p)
  hmc.*                     one _hmc_step (HMC_LEAPFROG steps at most,
                            STEP_EPS, unit mass) of 2 chains at the MAP from
                            the keys of INFERENCE_SEED: the draws JAX made
                            (z, steps, u) and its results (x, logp,
                            accept_prob)
  nuts.*                    one _nuts_step (NUTS_DEPTH, STEP_EPS, unit mass)
                            of 2 chains at the MAP from the keys of
                            INFERENCE_SEED + 1: the draws (z, go_right,
                            leaf_u, merge_u in the layout of
                            gpz_tpu_torch.inference.nuts._nuts_step) and the
                            results (x, logp, accept_stat, depth, diverged)
  advi.*                    advi_fit for ADVI_STEPS steps of ADVI_MC draws
                            from the MAP with the key of INFERENCE_SEED + 2:
                            the draws (eps) and the results (mu, rho, elbos)

INFERENCE_SEED is chosen so that no accept or take decision of the two
transitions lies within DECISION_MARGIN of its threshold (asserted when the
file is written), so that rounding differences of the order of the
tolerances cannot flip one.

tests/data/torch_port_golden_demos.npz holds what the three JAX demo scripts
(demos/demo_sinc.py, demo_2d.py, demo_photoz.py) print, each run as a
process with `--cpu --dtype float64` and the arguments of DEMO_SIZES: at
"small" (the CPU tests' sizes) and at "full" (the scripts' defaults; held
against the port on the GPU by chip_smoke.py). matplotlib is hidden from
the scripts, so demo_sinc.py writes no plot; GPZ_MIX_DTYPE is float64, the
port's mixture dtype. For each demo and size:

  <demo>.<size>.argv        the script's arguments
  <demo>.<size>.stdout      everything it printed
  <demo>.<size>.printed     its result numbers as printed (strings, in the
                            order of DEMO_NUMBERS[demo]; the band of a
                            comparison follows the printed digits)
  <demo>.<size>.values      the same as float64
  <demo>.<size>.seconds     the process's wall clock

tests/data/torch_port_golden_scale.npz holds the scale configuration
(BASELINE.json configs[4]'s per-card problem, `scale_problem`: VC, m=1000,
d=5, heteroscedastic, psi (n, d, d), float64) where the CPU can compute it:
its 20,000-row sub-problem, from gpz_tpu on the CPU with its mixture scans
in float64 (`jax_scale` lists the arrays; about nine minutes and 6 GB of
host memory, most of it the four rows with NaNs, whose guarded batches
escalate to the exact 1,000-component sum).

tests/data/torch_port_golden_bands.npz holds the nine-band configuration
(`bands_problem`: configs[2]'s widths at d = 9, VC, m=100, heteroscedastic,
psi = diag(errs**2) (n, 9, 9), float64, on synthetic_sdss(filters=9)) where
the CPU can compute it: its 1,000-row sub-problem, from gpz_tpu on the CPU
with its mixture scans in float64 (`jax_bands` lists the arrays).

(benchmarks/convergence_target.json keeps no trace of its run, so there is
no time_to_target of it to keep; tests/test_torch_bench_convergence.py holds
the port's time_to_target to bench_convergence.py's on seeded traces.)
"""

from __future__ import annotations

import dataclasses
import os
import re
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


# --- missing values: serving, the masked objective, a diagonal-family run ---

GOLDEN_MISSING = os.path.join(HERE, "data", "torch_port_golden_missing.npz")
MISSING_SEED = 4
MISSING_SERVE_ROWS = 6000
MISSING_ROWS = 64
#: bands lost by each of the four patterns, in the order of the golden rows
MISSING_PATTERNS = ((), (0,), (4,), (0, 4))

#: how far gpz_tpu_torch may be from the golden values of the paths with
#: missing values, on the CPU and on the GPU alike. Serving, (rtol, atol) per
#: output as in GOLDEN_TOL and for its reasons, three times as wide in
#: float64: the imputed rows X_hat, Psi_hat go through inv(iSigma_uu) at
#: cond(Sigma) ~ 5e7 before they reach the densities, and every output sums
#: 64 such densities. Measured on the CPU against these values: mu 5.7e-10
#: relative, sigma 4.4e-11, nu 1.8e-12 and gamma 4.1e-11 absolute in float64;
#: 2.3e-7 absolute at most in float32. The objective at the init point and
#: the first iterations of the VD run are well conditioned, as in TRAIN_TOL
#: (measured on the CPU: nlml 1.5e-14, gradient 1.2e-13).
MISSING_TOL = {
    "float64": {"mu": (3e-8, 0.0), "beta_i": (3e-8, 0.0),
                "sigma": (3e-8, 3e-10), "nu": (0.0, 3e-10),
                "gamma": (0.0, 3e-10)},
    "float32": GOLDEN_TOL["float32"],
    "init.flat": 1e-9,
    "init.nlml": (1e-10, 0.0), "init.grad": (1e-8, 1e-11),
    "vd.init.flat": 1e-9,
    "vd.trace.f": (1e-7, 0.0),
}


def inject_missing(X, seed=MISSING_SEED):
    """A copy of X (n, 5) with NaNs: of its rows, drawn by one permutation,
    25% lose band 0 (u), 10% lose band 4 (z) and 5% lose both."""
    n = len(X)
    order = np.random.default_rng(seed).permutation(n)
    a, b, c = int(round(0.25 * n)), int(round(0.10 * n)), int(round(0.05 * n))
    X = np.array(X, dtype=np.float64)
    X[order[:a], 0] = np.nan
    X[order[a:a + b], 4] = np.nan
    both = order[a + b:a + b + c]
    X[both, 0] = np.nan
    X[both, 4] = np.nan
    return X


def missing_serve_rows(synthetic_sdss, split):
    """(test-row indices, X with NaNs, psi, z) of the first
    MISSING_SERVE_ROWS test rows of the photo-z parity data, and the
    positions among them of the MISSING_ROWS golden rows: the first 16 of
    each pattern of MISSING_PATTERNS."""
    mags, errs, z = synthetic_sdss(n=N, seed=SEED)
    _, _, test = split(len(z), 0.2, 0.2, 0.6, np.random.default_rng(SEED))
    idx = np.where(test)[0][:MISSING_SERVE_ROWS]
    X = inject_missing(mags[idx])
    nan = np.isnan(X)
    per = MISSING_ROWS // len(MISSING_PATTERNS)
    picks = []
    for bands in MISSING_PATTERNS:
        want = np.zeros(X.shape[1], bool)
        want[list(bands)] = True
        picks.append(np.where((nan == want[None, :]).all(axis=1))[0][:per])
    return idx, X, errs[idx] ** 2, z[idx], np.concatenate(picks)


def missing_train_problem(synthetic_sdss, get_omega):
    """(X with NaNs, Y, psi, omega, training, validation): train_problem's
    rows after injection, with balanced cost weights."""
    X, Y, psi, tr, va = train_problem(synthetic_sdss)
    return inject_missing(X), Y, psi, get_omega(Y, "balanced"), tr, va


def jax_missing():
    """{name: array} of the missing-values golden file, from gpz_tpu on the
    CPU with its mixture scans in float64."""
    os.environ["GPZ_MIX_DTYPE"] = "float64"
    sys.path.insert(0, ROOT)
    import jax
    from jax.flatten_util import ravel_pytree
    import gpz_tpu
    from gpz_tpu import datautils
    from gpz_tpu.checkpoint import load_model
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.model import ParamSet, _make_dataset
    from gpz_tpu.objective import Posterior, nlog_ml

    def cast(pset):
        f64 = lambda a: a.astype(np.float64)  # noqa: E731
        post = Posterior(w=f64(pset.post.w), iSigma_w=f64(pset.post.iSigma_w),
                         logdet=f64(pset.post.logdet))
        return ParamSet(params=pset.params.astype(np.float64), post=post,
                        priors=f64(pset.priors), score=pset.score)

    # serving
    idx, Xs, psis, _, picks = missing_serve_rows(synthetic_sdss,
                                                 datautils.split)
    assert len(picks) == MISSING_ROWS
    model = load_model(CHECKPOINT)
    models = {
        "float32": model,
        "float64": dataclasses.replace(
            model, cfg=dataclasses.replace(model.cfg, dtype="float64"),
            last=cast(model.last), best=cast(model.best)),
    }
    out = {"rows": idx[picks], "picks": picks}
    for dt, mdl in models.items():
        pred = gpz_tpu.predict(Xs[picks], mdl, psi=psis[picks])
        for k in OUTPUTS:
            out[f"{dt}.{k}"] = np.asarray(getattr(pred, k))

    # the masked objective at the init point, VC
    X, Y, psi, omega, tr, va = missing_train_problem(synthetic_sdss,
                                                     datautils.get_omega)
    rows = objective_rows(tr)
    vc = gpz_tpu.init(X, Y, "VC", M, heteroscedastic=True, training=tr,
                      psi=psi, seed=SEED, dtype="float64")
    out["init.flat"] = np.asarray(ravel_pytree(vc.last.params)[0])
    Xn = (X - vc.muX[None, :]) / vc.sdX[None, :]
    Yc = Y[:, None] - vc.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), vc.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), rows, np.float64)
    (f, _), g = jax.value_and_grad(
        lambda p: nlog_ml(p, data, vc.cfg, complete=False),
        has_aux=True)(vc.last.params)
    out["init.nlml"] = np.asarray(f)
    out["init.grad"] = np.asarray(ravel_pytree(g)[0])

    # the diagonal family: VD with diagonal psi and balanced weights
    vd = gpz_tpu.init(X, Y, "VD", M, heteroscedastic=True, training=tr,
                      psi=psi, omega=omega, seed=SEED, dtype="float64")
    out["vd.init.flat"] = np.asarray(ravel_pytree(vd.last.params)[0])
    fit = gpz_tpu.train(vd, X, Y, training=tr, validation=va, psi=psi,
                        omega=omega, max_iter=TRACE_ITERS,
                        max_attempts=MAX_ATTEMPTS, verbose=False).fit_info
    keep = slice(0, fit["iterations"] + 1)
    out["vd.trace.f"] = np.asarray(fit["trace"]["f"])[keep]
    out["vd.trace.fevals"] = np.asarray(fit["trace"]["fevals"])[keep]
    return out


def load_golden_missing() -> dict:
    with np.load(GOLDEN_MISSING) as z:
        return {k: z[k] for k in z.files}


# --- posterior inference over the trained photo-z hyperparameters ---

GOLDEN_INFERENCE = os.path.join(HERE, "data",
                                "torch_port_golden_inference.npz")
INFERENCE_SEED = 5
PRIOR_SCALE = 3.0
JITTERED = 3
JITTER = 3e-3
STEP_EPS = 3e-3
HMC_LEAPFROG = 8
NUTS_DEPTH = 3
ADVI_STEPS = 3
ADVI_MC = 4
#: the least distance of a decision of the golden transitions from its
#: threshold, in log space (log u against a log-ratio or log-weight) and as
#: a cosine for the U-turn signs: over ten times the largest difference of
#: a log-ratio between the port and JAX (4e-4, measured on the CPU)
DECISION_MARGIN = 5e-3

#: how far gpz_tpu_torch may be from the inference golden values, (rtol,
#: atol), on the CPU and on the GPU alike. logp is n_eff = 4,000 times the
#: normalized nlml (~1e4 in all) at cond(Sigma) ~ 5e7: it agrees to ~4e-11
#: relative, and its gradient carries the float64 resolution of the
#: gradient in gamma (TRAIN_TOL's ~2e-6 on nlml) times n_eff, 2.4e-3 at
#: most (measured on the CPU, largest entry 122). A transition's momenta
#: take eps times those gradients in each of p = 3,301 coordinates, so the
#: kinetic energy, and with it the log acceptance ratio, differs by ~4e-4:
#: the accept probability by 2.8e-4 and NUTS's accept statistic (a mean of
#: min(1, exp(-dH)) over the leaves) by 3.9e-3; positions by 7.3e-8. Adam
#: divides each coordinate's gradient by its own scale, so where a
#: gradient is near zero its float64 noise moves the step: ADVI's mu by
#: 2.7e-5, rho by 6.8e-5, the ELBO by 9.1e-3 after 3 steps. Each bound
#: below is five to ten times the difference measured on the CPU.
INFERENCE_TOL = {
    "flat": (0.0, 0.0),
    "logp": (3e-10, 0.0), "grad": (1e-6, 2e-2),
    "hmc.x": (0.0, 1e-6), "hmc.logp": (1e-9, 0.0),
    "hmc.accept_prob": (0.0, 2e-3),
    "nuts.x": (0.0, 1e-6), "nuts.logp": (1e-9, 0.0),
    "nuts.accept_stat": (0.0, 2e-2),
    "advi.mu": (0.0, 3e-4), "advi.rho": (0.0, 7e-4),
    "advi.elbos": (0.0, 0.1),
}


def inference_problem(synthetic_sdss, split, get_omega):
    """(X, Y, psi, omega, training) of the photo-z parity data (phase 3's
    draw): 4,000 training rows of synthetic_sdss(N, seed=SEED)."""
    mags, errs, z = synthetic_sdss(n=N, seed=SEED)
    tr, _, _ = split(len(z), 0.2, 0.2, 0.6, np.random.default_rng(SEED))
    return mags, z, errs ** 2, get_omega(z, "normal", 0.1), tr


def jittered_points(flat):
    """(JITTERED, p) points around the flat MAP, from a numpy generator."""
    rng = np.random.default_rng(INFERENCE_SEED)
    return flat[None, :] + JITTER * rng.standard_normal((JITTERED,
                                                         flat.shape[0]))


def _nuts_margins(vg, x0, logp0, grad0, z, go_right, leaf_u, merge_u, depth):
    """Distances from their thresholds of the decisions of one unit-mass
    NUTS transition of JAX's `depth` doublings, replayed with vg = value and
    gradient of the log posterior: each leaf's and each merge's log u
    against its log-weight ratio, and the cosines of the U-turn checks."""
    out = []
    h0 = -logp0 + 0.5 * np.sum(z * z)
    ends = {True: (x0, z, grad0), False: (x0, z, grad0)}
    tree_log_w = 0.0
    for d in range(depth):
        right = bool(go_right[d])
        e = STEP_EPS if right else -STEP_EPS
        x, p, g = ends[right]
        log_w_sub, ckpt = -np.inf, {}
        for i in range(2**d):
            p_half = p + 0.5 * e * g
            x = x + e * p_half
            lp, g = (np.asarray(a) for a in vg(x))
            p = p_half + 0.5 * e * g
            log_w = h0 - (-lp + 0.5 * np.sum(p * p))
            new = np.logaddexp(log_w_sub, log_w)
            out.append(abs(np.log(leaf_u[2**d - 1 + i]) - (log_w - new)))
            log_w_sub = new
            for j in range(d + 1):
                if i % 2**j == 0:
                    ckpt[j] = (x, p)
                if j and (i + 1) % 2**j == 0:
                    dx = x - ckpt[j][0]
                    out += [abs(np.dot(dx, v)) / np.linalg.norm(dx)
                            / np.linalg.norm(v) for v in (ckpt[j][1], p)]
        out.append(abs(np.log(merge_u[d]) - (log_w_sub - tree_log_w)))
        tree_log_w = np.logaddexp(tree_log_w, log_w_sub)
        ends[right] = (x, p, g)
        dx = ends[True][0] - ends[False][0]
        out += [abs(np.dot(dx, end[1])) / np.linalg.norm(dx)
                / np.linalg.norm(end[1]) for end in ends.values()]
    return np.array(out)


def jax_inference():
    """{name: array} of the inference golden file, from gpz_tpu on the
    CPU in float64."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree
    from gpz_tpu import datautils
    from gpz_tpu.checkpoint import load_model
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.inference.mcmc import _hmc_step, gpz_log_posterior
    from gpz_tpu.inference.nuts import _nuts_step
    from gpz_tpu.inference.vi import advi_fit
    from gpz_tpu.model import _make_dataset
    from gpz_tpu.objective import nlog_ml

    model = load_model(CHECKPOINT)
    cfg = dataclasses.replace(model.cfg, dtype="float64")
    X, Y, psi, omega, tr = inference_problem(synthetic_sdss, datautils.split,
                                             datautils.get_omega)
    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[:, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, omega, tr, np.float64)
    flat, unravel = ravel_pytree(model.best.params.astype(np.float64))
    logp = gpz_log_posterior(
        lambda x: nlog_ml(unravel(x), data, cfg, complete=True)[0],
        n_eff=float(tr.sum()), k=1, prior_mean=flat, prior_scale=PRIOR_SCALE)
    grad_fn = jax.grad(logp)
    vg = jax.jit(jax.value_and_grad(logp))
    points = np.concatenate([np.asarray(flat)[None],
                             jittered_points(np.asarray(flat))])
    vals = [vg(jnp.asarray(x)) for x in points]
    out = {"flat": np.asarray(flat),
           "logp": np.array([float(v) for v, _ in vals]),
           "grad": np.stack([np.asarray(g) for _, g in vals])}
    chains = 2
    x0 = jnp.broadcast_to(flat, (chains, flat.shape[0]))
    l0 = jnp.full((chains,), vals[0][0])
    ones = jnp.ones_like(flat)

    # HMC: the draws of _hmc_step's key schedule, then the step itself
    keys = jax.random.split(jax.random.PRNGKey(INFERENCE_SEED), chains)
    z, steps, u = [], [], []
    for key in keys:
        k1, k2, k3 = jax.random.split(key, 3)
        z.append(jax.random.normal(k1, flat.shape, flat.dtype))
        steps.append(jax.random.randint(k3, (), 1, HMC_LEAPFROG + 1))
        u.append(jax.random.uniform(k2))
    x, lp, ap = jax.jit(jax.vmap(lambda k, xx, ll: _hmc_step(
        logp, grad_fn, k, xx, ll, STEP_EPS, ones, HMC_LEAPFROG)))(keys, x0,
                                                                   l0)
    out.update({"hmc.z": np.stack(z), "hmc.steps": np.array(steps),
                "hmc.u": np.array(u), "hmc.x": np.asarray(x),
                "hmc.logp": np.asarray(lp), "hmc.accept_prob": np.asarray(ap)})
    margin = np.abs(np.log(out["hmc.u"]) - np.log(out["hmc.accept_prob"]))
    assert margin.min() > DECISION_MARGIN, f"hmc: decision margin {margin}"

    # NUTS: the draws of _nuts_step's key schedule (every leaf's, as if no
    # chain stopped: a stopped chain's draws go unused), then the step
    keys = jax.random.split(jax.random.PRNGKey(INFERENCE_SEED + 1), chains)
    draws = {"z": [], "go_right": [], "leaf_u": [], "merge_u": []}
    for key in keys:
        kp, key = jax.random.split(key)
        draws["z"].append(jax.random.normal(kp, flat.shape, flat.dtype))
        go_right, leaf_u, merge_u = [], [], []
        for d in range(NUTS_DEPTH):
            key, kd, ks = jax.random.split(key, 3)
            go_right.append(jax.random.bernoulli(kd))
            for _ in range(2**d):
                ks, sub = jax.random.split(ks)
                leaf_u.append(jax.random.uniform(sub))
            key, ka = jax.random.split(key)
            merge_u.append(jax.random.uniform(ka))
        for name, v in (("go_right", go_right), ("leaf_u", leaf_u),
                        ("merge_u", merge_u)):
            draws[name].append(np.array(v))
    x, lp, acc, depth, div = jax.jit(jax.vmap(lambda k, xx, ll: _nuts_step(
        logp, grad_fn, k, xx, ll, STEP_EPS, ones, NUTS_DEPTH)))(keys, x0, l0)
    out["nuts.z"] = np.stack(draws["z"])
    # (depth or leaf, chain), the layout the port's _nuts_step takes
    for name in ("go_right", "leaf_u", "merge_u"):
        out[f"nuts.{name}"] = np.stack(draws[name], axis=1)
    out.update({"nuts.x": np.asarray(x), "nuts.logp": np.asarray(lp),
                "nuts.accept_stat": np.asarray(acc),
                "nuts.depth": np.asarray(depth),
                "nuts.diverged": np.asarray(div)})
    for c in range(chains):
        margin = _nuts_margins(
            vg, np.asarray(flat), float(vals[0][0]), np.asarray(vals[0][1]),
            out["nuts.z"][c], out["nuts.go_right"][:, c],
            out["nuts.leaf_u"][:, c], out["nuts.merge_u"][:, c],
            int(out["nuts.depth"][c]))
        assert margin.min() > DECISION_MARGIN, f"nuts: decision margin {margin}"

    # ADVI: advi_fit's per-step keys and draws, then the fit
    key = jax.random.PRNGKey(INFERENCE_SEED + 2)
    out["advi.eps"] = np.stack([
        np.asarray(jax.random.normal(k, (ADVI_MC, flat.shape[0]), flat.dtype))
        for k in jax.random.split(key, ADVI_STEPS)])
    mu, rho, elbos = advi_fit(logp, flat, key, num_steps=ADVI_STEPS,
                              num_mc=ADVI_MC)
    out.update({"advi.mu": np.asarray(mu), "advi.rho": np.asarray(rho),
                "advi.elbos": np.asarray(elbos)})
    return out


def load_golden_inference() -> dict:
    with np.load(GOLDEN_INFERENCE) as z:
        return {k: z[k] for k in z.files}


GOLDEN_DEMOS = os.path.join(HERE, "data", "torch_port_golden_demos.npz")
DEMOS = ("sinc", "2d", "photoz")
#: the numbers each demo prints after training, in print order
DEMO_NUMBERS = {
    "sinc": ("rmse", "mll", "spread_gap", "spread_support"),
    "2d": ("predicted_missing_y", "predicted_missing_x",
           "reference_missing_y", "reference_missing_x"),
    "photoz": ("rmse", "mll", "fr15", "fr05", "bias"),
}
#: every run's arguments beyond `--cpu --dtype float64`: "small" for the CPU
#: tests, "full" the scripts' own defaults. demo_photoz's small problem
#: (600 training rows, m=10) amplifies rounding ~1e4-fold per iteration from
#: iteration 7 on: gpz_tpu against itself with P scaled by (1 + 1e-15)
#: differs in f by 5e-10 at iteration 7, 6e-6 at 8 and 9e-4 at 15, and the
#: port against gpz_tpu by 4e-10, 5e-6 and 8e-4. Its small run stops at
#: iteration 7, where any two float64 pipelines still agree to ~1e-9
DEMO_SIZES = {
    "sinc": {"small": ("--n", "1000", "--m", "10", "--max-iter", "15"),
             "full": ()},
    "2d": {"small": ("--m", "8", "--max-iter", "15"), "full": ()},
    "photoz": {"small": ("--n", "3000", "--m", "10", "--max-iter", "7"),
               "full": ()},
}
DEMO_COMMON = ("--dtype", "float64")
_NUMBER = re.compile(r"-?\d+\.\d+")
# runs a demo script as __main__ with matplotlib hidden: demo_sinc.py then
# takes its ImportError branch and writes no plot beside itself
_RUN_SCRIPT = ("import runpy, sys; sys.modules['matplotlib'] = None; "
               "sys.argv = sys.argv[1:]; "
               "runpy.run_path(sys.argv[0], run_name='__main__')")


def result_lines(stdout: str) -> list:
    """The lines a demo prints after its training tables: everything after
    the last trace summary ("\t[N iters, M evals, status=S]")."""
    lines = stdout.splitlines()
    last = max((i for i, ln in enumerate(lines)
                if ln.startswith("\t[") and ln.endswith("]")), default=-1)
    return lines[last + 1:]


def printed_numbers(stdout: str) -> list:
    """The result numbers of a demo's output, as printed (strings)."""
    return [t for ln in result_lines(stdout) for t in _NUMBER.findall(ln)]


def line_layout(lines) -> list:
    """Lines with every printed number replaced by '#'."""
    return [_NUMBER.sub("#", ln) for ln in lines]


def printed_band(printed: str) -> float:
    """Two units of a printed number's last digit."""
    return 2.0 * 10.0 ** -len(printed.split(".")[1])


def _run_demo(demo, size):
    import subprocess
    import tempfile
    import time

    script = os.path.join(ROOT, "demos", f"demo_{demo}.py")
    argv = ("--cpu",) + DEMO_COMMON + DEMO_SIZES[demo][size]
    env = dict(os.environ, JAX_PLATFORMS="cpu", GPZ_MIX_DTYPE="float64")
    with tempfile.TemporaryDirectory() as cwd:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-c", _RUN_SCRIPT, script,
                              *argv], cwd=cwd, env=env, capture_output=True,
                             text=True, check=True)
        seconds = time.perf_counter() - t0
    printed = printed_numbers(res.stdout)
    assert len(printed) == len(DEMO_NUMBERS[demo]), (demo, size, printed)
    print(f"demo_{demo} {size} {' '.join(argv)}: {seconds:.1f} s, "
          f"{dict(zip(DEMO_NUMBERS[demo], printed))}", flush=True)
    p = f"{demo}.{size}"
    return {f"{p}.argv": np.array(argv), f"{p}.stdout": np.array(res.stdout),
            f"{p}.printed": np.array(printed),
            f"{p}.values": np.array([float(t) for t in printed]),
            f"{p}.seconds": np.array(seconds)}


def jax_demos():
    """Every demo at every size, run concurrently as processes."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(DEMOS) * 2) as pool:
        runs = [pool.submit(_run_demo, demo, size) for demo in DEMOS
                for size in ("small", "full")]
        return {k: v for r in runs for k, v in r.result().items()}


def photoz_divergence(size: str):
    """Print where demo_photoz's training trajectories part (`python
    tests/make_torch_port_golden.py divergence [small|full]`; writes
    nothing): gpz_tpu's trace against gpz_tpu's from P scaled by
    (1 + 1e-15), and against gpz_tpu_torch's on the CPU, all float64 on the
    demo's data at its DEMO_SIZES (rows, bases, iterations), the small size
    run on to 15 iterations, past the 7 its golden run stops at. The small
    size takes seconds, the full one about half an hour."""
    sys.path.insert(0, ROOT)
    import torch
    import gpz_tpu
    import gpz_tpu_torch
    from gpz_tpu import datautils
    from gpz_tpu.data import synthetic_sdss

    n, m, max_iter = {"small": (3000, 10, 15), "full": (60_000, 100, 500)}[
        size]
    mags, errs, z = synthetic_sdss(n=n, seed=SEED)
    omega = datautils.get_omega(z, "normal", 0.1)
    psi = errs**2
    tr, va, _ = datautils.split(n, 0.2, 0.2, 0.6,
                                np.random.default_rng(SEED))
    kw = dict(omega=omega, training=tr, heteroscedastic=True, psi=psi,
              seed=SEED, dtype="float64")
    tkw = dict(omega=omega, training=tr, validation=va, psi=psi,
               max_iter=max_iter, max_attempts=50, verbose=False)

    def trace(model):
        fit = model.fit_info
        return np.asarray(fit["trace"]["f"])[: fit["iterations"] + 1]

    m0 = gpz_tpu.init(mags, z, "VC", m, **kw)
    p0 = m0.last.params
    m1 = dataclasses.replace(m0, last=dataclasses.replace(
        m0.last, params=dataclasses.replace(p0, P=p0.P * (1 + 1e-15))))
    torch.set_num_threads(os.cpu_count() or 1)
    traces = {
        "gpz_tpu": trace(gpz_tpu.train(m0, mags, z, **tkw)),
        "gpz_tpu, P*(1+1e-15)": trace(gpz_tpu.train(m1, mags, z, **tkw)),
        "gpz_tpu_torch": trace(gpz_tpu_torch.train(gpz_tpu_torch.init(
            mags, z, "VC", m, device="cpu", **kw), mags, z, **tkw)),
    }
    ref = traces["gpz_tpu"]
    rtol = TRAIN_TOL["trace.f"][0]
    for name, f in traces.items():
        k = min(len(f), len(ref))
        rel = np.abs(f[:k] - ref[:k]) / np.abs(ref[:k])
        parts = np.nonzero(rel > rtol)[0]
        at = {i: float(abs(f[i] - ref[i])) for i in (5, 7, 8, 10, 15, 20)
              if i < k}
        print(f"photoz {size}: {name}: {len(f) - 1} iterations, best f "
              f"{f.min():.8f}; first iteration beyond {rtol:g} relative "
              f"of gpz_tpu's: {int(parts[0]) if len(parts) else None}; "
              "|f - gpz_tpu's| at "
              + ", ".join(f"{i}: {d:.1e}" for i, d in at.items()))


def load_golden_demos() -> dict:
    with np.load(GOLDEN_DEMOS) as z:
        return {k: z[k] for k in z.files}


# --- the scale configuration: BASELINE.json configs[4]'s per-card problem ---

GOLDEN_SCALE = os.path.join(HERE, "data", "torch_port_golden_scale.npz")
SCALE_SEED = 3
SCALE_TRAIN = 1_000_000
SCALE_VALID = 100_000
SCALE_SERVE = 20_000
SCALE_MISSING = 1_000
SCALE_M = 1000
SCALE_SUB = 20_000
SCALE_OBJECTIVE_ROWS = 8192
SCALE_TRACE_ITERS = 3
SCALE_COMPLETE_ROWS = 16
#: the golden rows with NaNs: this many of each pattern of lost bands, the
#: first of the missing request's rows with that pattern
SCALE_NAN_PICKS = (((0,), 2), ((4,), 1), ((0, 4), 1))

#: how far gpz_tpu_torch may be from the scale golden values, (rtol, atol),
#: on the CPU and on the GPU alike; an absolute bound for the flat
#: parameters. Measured on the CPU, the port against these values: the
#: sub-problem's init equal bit for bit (host NumPy in both packages); at
#: its init point (Sigma = gamma^-2 I, well conditioned) nlml 4.5e-14
#: relative and the gradient 1.4e-13 of its largest entry 0.46 (err/bound
#: 0.009 under TRAIN_TOL's init bounds); the f trace of its first
#: iterations 2.1e-11 relative with equal evaluation counts (TRAIN_TOL's
#: trace bound); the 16 complete rows mu 3.4e-12 relative, sigma 4.3e-13,
#: nu 3.1e-15 and gamma 1.7e-14 absolute (err/bound 3.4e-4 at most under
#: GOLDEN_TOL's float64 bounds, set for a trained point). The rows with NaNs
#: sum the exact 1,000-component mixture (every guarded batch escalates at
#: this point: top-64 coverage 0.17-0.22), which the port's plain path
#: cannot evaluate on the CPU in reasonable time (10**9 pairs a row), so
#: MISSING_TOL's float64 bounds, set for the same sums at m = 100, hold
#: them on the card. The full-size init's length scales, blocked over rows,
#: are held to gpz_tpu's unblocked expression within the flat bound (each
#: block's matrix product rounds ~1e-16 relative).
SCALE_TOL = {
    "sub.init.flat": 1e-9,
    "init.flat": 1e-9,
    "init.nlml": TRAIN_TOL["init.nlml"], "init.grad": TRAIN_TOL["init.grad"],
    "trace.f": TRAIN_TOL["trace.f"],
    "complete": GOLDEN_TOL["float64"],
    "missing": MISSING_TOL["float64"],
}


def scale_problem(synthetic_sdss):
    """configs[4]'s per-card problem, drawn with the given package's copy of
    synthetic_sdss: one draw of synthetic_sdss(1,120,000, filters=5, seed=3)
    and psi = errs**2. Returns (X, Y, psi, training, validation, served,
    missing): the first SCALE_TRAIN rows train, the next SCALE_VALID
    validate; `served` indexes the last SCALE_SERVE rows (served complete);
    `missing` is (positions among the served rows, X with NaNs) of the first
    SCALE_MISSING served rows that lose a band when inject_missing (seed
    MISSING_SEED) is applied to all of them."""
    n = SCALE_TRAIN + SCALE_VALID + SCALE_SERVE
    mags, errs, z = synthetic_sdss(n, filters=5, seed=SCALE_SEED)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    tr[:SCALE_TRAIN] = True
    va[SCALE_TRAIN:SCALE_TRAIN + SCALE_VALID] = True
    served = np.arange(n - SCALE_SERVE, n)
    Xs = inject_missing(mags[served])
    pos = np.where(np.isnan(Xs).any(axis=1))[0][:SCALE_MISSING]
    return mags, z, errs ** 2, tr, va, served, (pos, Xs[pos])


def scale_nan_picks(Xm):
    """Positions among the rows with NaNs Xm of the golden ones
    (SCALE_NAN_PICKS), in pattern order."""
    nan = np.isnan(Xm)
    picks = []
    for bands, count in SCALE_NAN_PICKS:
        want = np.zeros(Xm.shape[1], bool)
        want[list(bands)] = True
        picks.append(np.where((nan == want[None, :]).all(axis=1))[0][:count])
    return np.concatenate(picks)


def _jax_predict_unpadded(model, X, psi):
    """gpz_tpu.predict's outputs for rows with NaNs, each pattern group one
    batch with its coverage guard, as gpz_tpu.model.predict runs them but
    without padding a group to 16 rows (its bucket): an escalated row costs
    1,000 components x 10**6 pairs on the CPU. Returns ({output: (n, 1)},
    [(rows of the group, coverage, escalated)])."""
    import importlib

    import jax.numpy as jnp
    from gpz_tpu import datautils
    from gpz_tpu.model import _predict_functions

    # the module, not the package's `predict` function of the same name
    jpredict = importlib.import_module("gpz_tpu.predict")

    cfg = model.cfg
    pset = model.best
    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    psi_c = datautils.fix_psi(psi, len(X), model.sdX, True)
    mask = ~np.isnan(Xn)
    Xz = np.where(mask, Xn, 0.0)
    _, moments_fn = _predict_functions(cfg)
    out = {k: np.zeros((len(X), cfg.k)) for k in ("mu", "nu", "beta_i",
                                                   "gamma")}
    groups = []
    patterns, inverse = np.unique(mask, axis=0, return_inverse=True)
    for pi in range(patterns.shape[0]):
        rows = np.where(inverse == pi)[0]
        margs = (pset.params, pset.post, pset.priors, jnp.asarray(Xz[rows]),
                 jnp.asarray(patterns[pi].astype(np.float64)),
                 jnp.asarray(psi_c[rows]))
        *res, coverage = moments_fn(*margs, complete=False, mix_topl=None,
                                    return_coverage=True)
        escalated = float(coverage) < jpredict.MIX_COVERAGE_MIN
        if escalated:
            res = moments_fn(*margs, complete=False, mix_topl=cfg.m,
                             return_coverage=False)
        for key, val in zip(("mu", "nu", "beta_i", "gamma"), res):
            out[key][rows] = np.asarray(val)
        groups.append((rows, float(coverage), escalated))
    out["gamma"] = np.maximum(out["gamma"], 0.0)
    out["nu"] = np.maximum(out["nu"], 0.0)
    out["sigma"] = out["nu"] + out["beta_i"] + out["gamma"]
    out["mu"] = out["mu"] + model.muY[None, :]
    return out, groups


def jax_scale():
    """{name: array} of the scale golden file, from gpz_tpu on the CPU in
    float64 with its mixture scans in float64:

      sub.init.flat           gpz_tpu.init (VC, m=SCALE_M, heteroscedastic,
                              psi (n, d, d), seed 1) on the first SCALE_SUB
                              training rows alone: the sub-problem
      init.nlml, init.grad    nlog_ml and its flat gradient at that point on
                              the first SCALE_OBJECTIVE_ROWS training rows
      trace.f, trace.fevals   gpz_tpu.train(max_iter=SCALE_TRACE_ITERS) of
                              the sub-problem (no validation rows)
      complete.<output>       gpz_tpu.predict at the sub-problem's init point
                              for the first SCALE_COMPLETE_ROWS served rows
      missing.<output>        the same for the rows of scale_nan_picks among
                              the missing request's rows, by pattern group
                              with the coverage guard (no padding); and
                              missing.coverage / missing.escalated per row

    The full-size init (10**6 rows) is not here: gpz_tpu.init's distance
    matrix would hold three (10**6, 1000) float64 temporaries (24 GB) on the
    CPU. chip_smoke.py holds the port's full-size init to gpz_tpu's
    expression evaluated unblocked on the GPU machine's host instead."""
    os.environ["GPZ_MIX_DTYPE"] = "float64"
    sys.path.insert(0, ROOT)
    import jax
    from jax.flatten_util import ravel_pytree
    import gpz_tpu
    from gpz_tpu import datautils
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.model import _make_dataset
    from gpz_tpu.objective import nlog_ml

    X, Y, psi, tr, va, served, (pos, Xm) = scale_problem(synthetic_sdss)
    sub = slice(0, SCALE_SUB)
    model = gpz_tpu.init(X[sub], Y[sub], "VC", SCALE_M, heteroscedastic=True,
                         psi=psi[sub], seed=SEED, dtype="float64")
    out = {"sub.init.flat": np.asarray(ravel_pytree(model.last.params)[0])}

    rows = np.zeros(SCALE_SUB, bool)
    rows[:SCALE_OBJECTIVE_ROWS] = True
    Xn = (X[sub] - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[sub, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi[sub], SCALE_SUB, model.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(SCALE_SUB), rows, np.float64)
    (f, _), g = jax.value_and_grad(
        lambda p: nlog_ml(p, data, model.cfg, complete=True),
        has_aux=True)(model.last.params)
    out["init.nlml"] = np.asarray(f)
    out["init.grad"] = np.asarray(ravel_pytree(g)[0])

    c = served[:SCALE_COMPLETE_ROWS]
    pred = gpz_tpu.predict(X[c], model, psi=psi[c])
    for k in OUTPUTS:
        out[f"complete.{k}"] = np.asarray(getattr(pred, k))
    picks = scale_nan_picks(Xm)
    got, groups = _jax_predict_unpadded(model, Xm[picks],
                                        psi[served[pos[picks]]])
    for k in OUTPUTS:
        out[f"missing.{k}"] = got[k]
    out["missing.picks"] = picks
    out["missing.coverage"] = np.zeros(len(picks))
    out["missing.escalated"] = np.zeros(len(picks), bool)
    for grows, cov, esc in groups:
        out["missing.coverage"][grows] = cov
        out["missing.escalated"][grows] = esc

    fit = gpz_tpu.train(model, X[sub], Y[sub], psi=psi[sub],
                        max_iter=SCALE_TRACE_ITERS,
                        max_attempts=MAX_ATTEMPTS, verbose=False).fit_info
    keep = slice(0, fit["iterations"] + 1)
    out["trace.f"] = np.asarray(fit["trace"]["f"])[keep]
    out["trace.fevals"] = np.asarray(fit["trace"]["fevals"])[keep]
    return out


def load_golden_scale() -> dict:
    with np.load(GOLDEN_SCALE) as z:
        return {k: z[k] for k in z.files}


# --- wide-band surveys: nine bands, VC m=100 with full input noise ---

GOLDEN_BANDS = os.path.join(HERE, "data", "torch_port_golden_bands.npz")
BANDS = 9
BANDS_SEED = 6
BANDS_TRAIN = 70_000
BANDS_VALID = 10_000
BANDS_SERVE = 12_000
BANDS_MISSING = 3_000
BANDS_SUB = 1_000
BANDS_TRACE_ITERS = 2
BANDS_COMPLETE_ROWS = 16
#: the golden rows with NaNs: this many of each pattern of lost bands, the
#: first of the missing request's rows with that pattern
BANDS_NAN_PICKS = (((0,), 2), ((4,), 1), ((0, 4), 1))

#: how far gpz_tpu_torch may be from the nine-band golden values, (rtol,
#: atol), on the CPU and on the GPU alike; an absolute bound for the flat
#: parameters. The values are those of the sub-problem at its init point
#: (Sigma = gamma^-2 I, well conditioned) and of its first iterations, where
#: two float64 pipelines agree to rounding, so the bounds of the five-band
#: golden files hold: init is host NumPy in both packages (TRAIN_TOL's
#: init.flat); nlml and its gradient TRAIN_TOL's init bounds; the f trace
#: TRAIN_TOL's; the complete rows GOLDEN_TOL's float64 bounds, set for a
#: trained point; the rows with NaNs MISSING_TOL's float64 bounds, set for
#: the same mixture sums at d = 5. d = 9 goes through the JAX package's jnp
#: path (its Pallas gate stops at d = 6) and through the port's wide kernels
#: on the card or their plain twins (torch.linalg past d = 8) on the CPU.
BANDS_TOL = {
    "sub.init.flat": TRAIN_TOL["init.flat"],
    "init.nlml": TRAIN_TOL["init.nlml"], "init.grad": TRAIN_TOL["init.grad"],
    "trace.f": TRAIN_TOL["trace.f"],
    "complete": GOLDEN_TOL["float64"],
    "missing": MISSING_TOL["float64"],
}


def bands_problem(synthetic_sdss):
    """The nine-band configuration's data, drawn with the given package's
    copy of synthetic_sdss: one draw of synthetic_sdss(95,000, filters=9,
    seed=BANDS_SEED) with full input noise psi = diag(errs**2) (n, 9, 9).
    Returns (X, Y, psi, training, validation, served, missing): the first
    BANDS_TRAIN rows train, the next BANDS_VALID validate, `served` indexes
    the next BANDS_SERVE (served complete) and `missing` is (indices, X with
    NaNs) of the last BANDS_MISSING rows after inject_missing."""
    n = BANDS_TRAIN + BANDS_VALID + BANDS_SERVE + BANDS_MISSING
    mags, errs, z = synthetic_sdss(n, filters=BANDS, seed=BANDS_SEED)
    psi = np.einsum("ni,ij->nij", errs ** 2, np.eye(BANDS))
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    tr[:BANDS_TRAIN] = True
    va[BANDS_TRAIN:BANDS_TRAIN + BANDS_VALID] = True
    served = np.arange(BANDS_TRAIN + BANDS_VALID, n - BANDS_MISSING)
    missing = np.arange(n - BANDS_MISSING, n)
    return mags, z, psi, tr, va, served, (missing, inject_missing(
        mags[missing]))


def bands_nan_picks(Xm):
    """Positions among the rows Xm of the golden rows with NaNs
    (BANDS_NAN_PICKS), in pattern order."""
    nan = np.isnan(Xm)
    picks = []
    for bands, count in BANDS_NAN_PICKS:
        want = np.zeros(Xm.shape[1], bool)
        want[list(bands)] = True
        picks.append(np.where((nan == want[None, :]).all(axis=1))[0][:count])
    return np.concatenate(picks)


def jax_bands():
    """{name: array} of the nine-band golden file, from gpz_tpu on the CPU
    in float64 with its mixture scans in float64:

      sub.init.flat           gpz_tpu.init (VC, m=M, heteroscedastic, psi
                              (n, 9, 9), seed 1) on the first BANDS_SUB
                              training rows alone: the sub-problem
      init.nlml, init.grad    nlog_ml and its flat gradient at that point on
                              those rows
      trace.f, trace.fevals   gpz_tpu.train(max_iter=BANDS_TRACE_ITERS) of
                              the sub-problem (no validation rows)
      complete.<output>       gpz_tpu.predict at the sub-problem's init point
                              for the first BANDS_COMPLETE_ROWS served rows
      missing.<output>        the same for the rows of bands_nan_picks among
                              the missing rows, by pattern group with the
                              coverage guard (no padding); and
                              missing.coverage / missing.escalated per row

    The full-size run (70,000 x 100 pairs of 9 x 9 systems an evaluation) is
    not here: gpz_tpu's jnp path holds (n, m, 9, 9) float64 temporaries of
    4.5 GB each on the CPU. chip_smoke.py runs it on the card and holds
    this sub-problem to these values."""
    os.environ["GPZ_MIX_DTYPE"] = "float64"
    sys.path.insert(0, ROOT)
    import jax
    from jax.flatten_util import ravel_pytree
    import gpz_tpu
    from gpz_tpu import datautils
    from gpz_tpu.data import synthetic_sdss
    from gpz_tpu.model import _make_dataset
    from gpz_tpu.objective import nlog_ml

    X, Y, psi, tr, va, served, (idx, Xm) = bands_problem(synthetic_sdss)
    sub = slice(0, BANDS_SUB)
    model = gpz_tpu.init(X[sub], Y[sub], "VC", M, heteroscedastic=True,
                         psi=psi[sub], seed=SEED, dtype="float64")
    out = {"sub.init.flat": np.asarray(ravel_pytree(model.last.params)[0])}

    Xn = (X[sub] - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[sub, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi[sub], BANDS_SUB, model.sdX, True)
    data = _make_dataset(Xn, Yc, psi_c, np.ones(BANDS_SUB),
                         np.ones(BANDS_SUB, bool), np.float64)
    (f, _), g = jax.value_and_grad(
        lambda p: nlog_ml(p, data, model.cfg, complete=True),
        has_aux=True)(model.last.params)
    out["init.nlml"] = np.asarray(f)
    out["init.grad"] = np.asarray(ravel_pytree(g)[0])

    c = served[:BANDS_COMPLETE_ROWS]
    pred = gpz_tpu.predict(X[c], model, psi=psi[c])
    for k in OUTPUTS:
        out[f"complete.{k}"] = np.asarray(getattr(pred, k))
    picks = bands_nan_picks(Xm)
    got, groups = _jax_predict_unpadded(model, Xm[picks], psi[idx[picks]])
    for k in OUTPUTS:
        out[f"missing.{k}"] = got[k]
    out["missing.picks"] = picks
    out["missing.coverage"] = np.zeros(len(picks))
    out["missing.escalated"] = np.zeros(len(picks), bool)
    for grows, cov, esc in groups:
        out["missing.coverage"][grows] = cov
        out["missing.escalated"][grows] = esc

    fit = gpz_tpu.train(model, X[sub], Y[sub], psi=psi[sub],
                        max_iter=BANDS_TRACE_ITERS,
                        max_attempts=MAX_ATTEMPTS, verbose=False).fit_info
    keep = slice(0, fit["iterations"] + 1)
    out["trace.f"] = np.asarray(fit["trace"]["f"])[keep]
    out["trace.fevals"] = np.asarray(fit["trace"]["fevals"])[keep]
    return out


def load_golden_bands() -> dict:
    with np.load(GOLDEN_BANDS) as z:
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
    if "missing" in which:
        np.savez_compressed(GOLDEN_MISSING, seed=MISSING_SEED,
                            **jax_missing())
        print(f"wrote {GOLDEN_MISSING} ({os.path.getsize(GOLDEN_MISSING)} "
              "bytes)")
    if "inference" in which:
        np.savez_compressed(GOLDEN_INFERENCE, seed=INFERENCE_SEED,
                            **jax_inference())
        print(f"wrote {GOLDEN_INFERENCE} "
              f"({os.path.getsize(GOLDEN_INFERENCE)} bytes)")
    if "demos" in which:
        np.savez_compressed(GOLDEN_DEMOS, **jax_demos())
        print(f"wrote {GOLDEN_DEMOS} ({os.path.getsize(GOLDEN_DEMOS)} bytes)")
    if "scale" in which:
        np.savez_compressed(GOLDEN_SCALE, seed=SCALE_SEED, **jax_scale())
        print(f"wrote {GOLDEN_SCALE} ({os.path.getsize(GOLDEN_SCALE)} bytes)")
    if "bands" in which:
        np.savez_compressed(GOLDEN_BANDS, seed=BANDS_SEED, **jax_bands())
        print(f"wrote {GOLDEN_BANDS} ({os.path.getsize(GOLDEN_BANDS)} bytes)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["divergence"]:
        photoz_divergence(sys.argv[2] if len(sys.argv) > 2 else "small")
    else:
        main(sys.argv[1:] or ["photoz", "train", "missing", "inference",
                              "demos", "scale", "bands"])
