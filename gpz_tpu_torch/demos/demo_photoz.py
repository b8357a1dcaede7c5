"""SDSS photo-z demo (demos/demo_photoz.py; ref demo_photoz.m): magnitudes
and their errors -> redshift, with input-noise propagation, cost-sensitive
weights and cumulative-confidence metric curves.

    python -m gpz_tpu_torch.demos.demo_photoz [--m 100] [--method VC]
        [--n 60000] [--data path.csv] [--device cuda] [--out pred.csv]

Without --data it uses the same synthetic SDSS-like sample as the JAX
script (`synthetic_sdss`); --data reads a CSV of m_1..m_f,e_1..e_f,z_spec.
With psi = errs**2 and the full-covariance methods, training and prediction
run through the design-matrix kernel pair on a CUDA device. The numbers are
those the JAX script prints for the same seed: the last point of the
cumulative RMSE, MLL, FR15, FR05 and BIAS curves on the test rows.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import gpz_tpu_torch
from gpz_tpu_torch import datautils
from gpz_tpu_torch import metrics as M
from gpz_tpu_torch.data import load_sdss_csv, synthetic_sdss

SPLIT = (0.2, 0.2, 0.6)  # training, validation, test


def run(n=60_000, m=100, method="VC", max_iter=500, max_attempts=50,
        csl="normal", bin_width=0.1, no_input_noise=False, dtype="float32",
        seed=1, device="cuda", data=None, verbose=False, out=None) -> dict:
    """Train and score the demo: {"rmse", "mll", "fr15", "fr05", "bias"} as
    the JAX script prints them (unrounded); "fits" (the training's
    fit_info), "model" (the trained model), the rows of the split
    ("n_train", "n_valid", "n_test") and "seconds". `out`
    names a CSV for the test rows' predictions, as the JAX script's
    --out."""
    t0 = time.perf_counter()
    if data:
        mags, errs, z = load_sdss_csv(data)
    else:
        mags, errs, z = synthetic_sdss(n=n, seed=seed)
    n = len(z)

    omega = datautils.get_omega(z, csl, bin_width)
    if no_input_noise:
        X = np.hstack([mags, np.log(errs)])  # errors as extra features
        psi = None
    else:
        X = mags
        psi = errs**2  # mag errors as input-noise variance (demo_photoz.m:57)

    rng = np.random.default_rng(seed)
    tr, va, te = datautils.split(n, *SPLIT, rng)

    model = gpz_tpu_torch.init(
        X, z, method, m, omega=omega, training=tr, heteroscedastic=True,
        psi=psi, seed=seed, dtype=dtype, device=device,
    )
    model = gpz_tpu_torch.train(
        model, X, z, omega=omega, training=tr, validation=va, psi=psi,
        max_iter=max_iter, max_attempts=max_attempts, verbose=verbose,
    )

    pred = gpz_tpu_torch.predict(X, model, psi=psi, selection=te)
    y, mu, sigma = z[te], pred.mu[:, 0], pred.sigma[:, 0]
    if out:
        np.savetxt(
            out,
            np.column_stack([y, mu, sigma, pred.nu[:, 0], pred.beta_i[:, 0],
                             pred.gamma[:, 0]]),
            delimiter=",",
            header="z_spec,mu,sigma,nu,beta_i,gamma", comments="",
        )
    return {
        "rmse": float(M.rmse_curve(y, mu, sigma)[-1]),
        "mll": float(M.cumulative_by_confidence(y, mu, sigma,
                                                M.log_likelihood)[-1]),
        "fr15": float(M.cumulative_by_confidence(y, mu, sigma, M.fr15)[-1]),
        "fr05": float(M.cumulative_by_confidence(y, mu, sigma, M.fr05)[-1]),
        "bias": float(M.cumulative_by_confidence(y, mu, sigma, M.bias)[-1]),
        "fits": [model.fit_info],
        "model": model,
        "n_train": int(tr.sum()),
        "n_valid": int(va.sum()),
        "n_test": int(te.sum()),
        "seconds": time.perf_counter() - t0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="demo_photoz")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    ap.add_argument("--data", default=None)
    ap.add_argument("--n", type=int, default=60_000)
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--method", default="VC")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--csl", default="normal",
                    choices=["normal", "normalized", "balanced"])
    ap.add_argument("--bin-width", type=float, default=0.1)
    ap.add_argument("--no-input-noise", action="store_true")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", default=None, help="csv path for predictions")
    args = ap.parse_args(argv)

    r = run(n=args.n, m=args.m, method=args.method, max_iter=args.max_iter,
            max_attempts=args.max_attempts, csl=args.csl,
            bin_width=args.bin_width, no_input_noise=args.no_input_noise,
            dtype=args.dtype, seed=args.seed, device=args.device,
            data=args.data, verbose=True, out=args.out)
    print("RMSE\t\tMLL\t\tFR15\t\tFR05\t\tBIAS")
    print(f"{r['rmse']:.6f}\t{r['mll']:.6f}\t{r['fr15']:.6f}\t{r['fr05']:.6f}"
          f"\t{r['bias']:.6f}")


if __name__ == "__main__":
    main()
