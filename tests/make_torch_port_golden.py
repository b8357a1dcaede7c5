"""Regenerate tests/data/torch_port_golden_photoz.npz.

The file holds gpz_tpu.predict's outputs (mu, sigma, nu, beta_i, gamma) for
the first 256 test rows of the photo-z parity data
(benchmarks/parity_numbers.py::photoz_data: synthetic_sdss(n=20000, seed=1),
psi = errs**2, 20/20/60 split drawn from default_rng(1)), served by the
trained VC m=100 checkpoint benchmarks/photoz_trained_m100.npz twice: at the
checkpoint's float32, and with every parameter cast to float64. gpz_tpu_torch
is held against it where JAX is absent (chip_smoke.py on the GPU), and
tests/test_torch_predict.py checks that JAX still reproduces it.

    JAX_PLATFORMS=cpu python tests/make_torch_port_golden.py
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "data", "torch_port_golden_photoz.npz")
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


def main():
    idx, preds = jax_predictions()
    arrays = {f"{dt}.{k}": v for dt, p in preds.items() for k, v in p.items()}
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, rows=idx, seed=SEED, n=N, **arrays)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
