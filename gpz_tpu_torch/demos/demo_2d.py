"""2-D demo (demos/demo_2d.py; ref demo_2D.m): a GMM-generated surface,
input noise, one variable deleted from a share of the rows, and prediction
with a whole column missing compared with a reference model trained on the
observed column alone.

    python -m gpz_tpu_torch.demos.demo_2d [--m 50] [--method VD]
        [--percentage 0.5] [--device cuda]

Three trainings: the main model on both columns (the masked path of its
method on the rows with a NaN) and one reference model per column. The
numbers are those the JAX script prints for the same seed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import gpz_tpu_torch
from gpz_tpu_torch import datautils

N_PER = 1000             # rows drawn from each of the three components
MEANS = (np.array([10, 0]), np.array([10, 10]), np.array([5, 5]))
COVS = (np.array([[10.0, 0], [0, 1]]), np.array([[5.0, -3], [-3, 3]]),
        np.array([[2.0, 0], [0, 2]]))
WEIGHTS = np.array([-9.0, 6.0, 3.0])


def _mvnpdf(x, mu, C):
    diff = x - mu
    q = np.einsum("nd,de,ne->n", diff, np.linalg.inv(C), diff)
    return np.exp(-0.5 * q) / (2 * np.pi * np.sqrt(np.linalg.det(C)))


def run(m=50, method="VD", max_iter=500, max_attempts=50, percentage=0.5,
        dtype="float64", seed=1, device="cuda", verbose=False) -> dict:
    """Train and score the demo: the test RMSE with one column missing,
    {"predicted_missing_y", "predicted_missing_x"} from the main model and
    {"reference_missing_y", "reference_missing_x"} from the model trained on
    the other column, as the JAX script prints them (unrounded); "fits"
    (fit_info of the main model, then of the two reference models) and
    "seconds"."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    X = np.vstack([rng.multivariate_normal(mu, C, N_PER)
                   for mu, C in zip(MEANS, COVS)])
    n = X.shape[0]
    PHI = np.stack([_mvnpdf(X, mu, C) for mu, C in zip(MEANS, COVS)], axis=1)
    Y = PHI @ WEIGHTS + rng.standard_normal(n) * 0.01

    # input noise (ref demo_2D.m:45-60)
    E, V = 0.5, 0.25
    psi = rng.gamma(E**2 / V, V / E, size=(n, 2))
    Xn = X + rng.standard_normal((n, 2)) * np.sqrt(psi)
    psi_in = psi
    if method in ("GC", "VC"):
        psi_in = np.zeros((n, 2, 2))
        psi_in[:, 0, 0] = psi[:, 0]
        psi_in[:, 1, 1] = psi[:, 1]

    # delete one variable from a share of the rows (demo_2D.m:72-78)
    if percentage > 0:
        r = rng.permutation(n)
        psize = int(np.ceil(percentage * n / 2))
        Xn[r[:psize], 0] = np.nan
        Xn[r[psize:2 * psize], 1] = np.nan

    tr, va, te = datautils.split(n, 0.7, 0.15, 0.15, rng)

    model = gpz_tpu_torch.init(
        Xn, Y, method, m, heteroscedastic=True, training=tr, psi=psi_in,
        seed=seed, dtype=dtype, device=device,
    )
    model = gpz_tpu_torch.train(
        model, Xn, Y, training=tr, validation=va, psi=psi_in,
        max_iter=max_iter, max_attempts=max_attempts, verbose=verbose,
    )
    fits = [model.fit_info]

    # one variable fully missing vs a reference model on the other one
    rmses = np.zeros((2, 2))
    for o in range(2):
        Xs = np.full((te.sum(), 2), np.nan)
        Xs[:, o] = X[te, o]
        mu = gpz_tpu_torch.predict(Xs, model).mu[:, 0]
        rmses[0, o] = np.sqrt(np.mean((Y[te] - mu) ** 2))

        kept = ~np.isnan(Xn[:, o])
        ref = gpz_tpu_torch.init(
            Xn[:, o:o + 1], Y, method, m, heteroscedastic=True,
            training=tr & kept, psi=psi[:, o], seed=seed, dtype=dtype,
            device=device,
        )
        ref = gpz_tpu_torch.train(
            ref, Xn[:, o:o + 1], Y, training=tr & kept,
            validation=va & kept, psi=psi[:, o], max_iter=max_iter,
            max_attempts=max_attempts, verbose=False,
        )
        fits.append(ref.fit_info)
        mu_ref = gpz_tpu_torch.predict(X[te, o:o + 1], ref).mu[:, 0]
        rmses[1, o] = np.sqrt(np.mean((Y[te] - mu_ref) ** 2))

    return {
        "predicted_missing_y": float(rmses[0, 0]),
        "predicted_missing_x": float(rmses[0, 1]),
        "reference_missing_y": float(rmses[1, 0]),
        "reference_missing_x": float(rmses[1, 1]),
        "fits": fits,
        "seconds": time.perf_counter() - t0,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="demo_2d")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the models (default: cuda)")
    ap.add_argument("--m", type=int, default=50)
    ap.add_argument("--method", default="VD")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--percentage", type=float, default=0.5)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    r = run(m=args.m, method=args.method, max_iter=args.max_iter,
            max_attempts=args.max_attempts, percentage=args.percentage,
            dtype=args.dtype, seed=args.seed, device=args.device,
            verbose=True)
    print("\t\t  RMSE on the test set")
    print("\t\tMissing y\tMissing x")
    print(f"Predicted\t{r['predicted_missing_y']:.6f}\t"
          f"{r['predicted_missing_x']:.6f}")
    print(f"Reference\t{r['reference_missing_y']:.6f}\t"
          f"{r['reference_missing_x']:.6f}")


if __name__ == "__main__":
    main()
