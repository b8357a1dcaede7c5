"""1-D sinc demo (demos/demo_sinc.py; ref demo_sinc.m): heteroscedastic
noise, gamma-distributed input noise and a gap in the training support.

    python -m gpz_tpu_torch.demos.demo_sinc [--m 100] [--method VL]
        [--max-iter 500] [--device cuda] [--plot PATH]

The numbers are those the JAX script prints for the same seed: the test
set's RMSE and MLL, and the spread of 20 posterior-sample curves inside the
training gap and on the support (`sample_weights` draws the same weights as
gpz_tpu's for the same seed).
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np

import gpz_tpu_torch
from gpz_tpu_torch import datautils

GAP = (-7.0, -2.0)       # the training gap (ref demo_sinc.m:32)
GRID = 500               # points of the posterior-curve grid
CURVES = 20              # posterior-sample curves


def fx(x):
    return np.sinc(x / math.pi)  # sin(x)/x


def sx(x):
    return 0.05 + (1 / (1 + np.exp(-0.2 * x))) * (1 + np.sin(2 * x)) * 0.2


def run(n=10_000, m=100, method="VL", max_iter=500, max_attempts=50,
        no_input_noise=False, dtype="float64", seed=1, device="cuda",
        verbose=False, plot=None) -> dict:
    """Train and score the demo: {"rmse", "mll", "spread_gap",
    "spread_support"} as the JAX script prints them (unrounded), "fits" (the
    training's fit_info), "seconds" and "plot" (the path written, or None:
    written only where `plot` names one and matplotlib is importable)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    X = np.linspace(-10, 10, n)
    X = X[(X < GAP[0]) | (X > GAP[1])]
    n = len(X)
    Y = fx(X) + rng.standard_normal(n) * sx(X)

    if no_input_noise:
        psi = None
    else:
        E, V = 0.5, 0.25
        psi = rng.gamma(E**2 / V, V / E, size=n)
        X = X + rng.standard_normal(n) * np.sqrt(psi)

    tr, va, te = datautils.split(n, 0.7, 0.15, 0.15, rng)

    model = gpz_tpu_torch.init(
        X[:, None], Y, method, m, heteroscedastic=True, training=tr, psi=psi,
        seed=seed, dtype=dtype, device=device,
    )
    model = gpz_tpu_torch.train(
        model, X[:, None], Y, training=tr, validation=va, psi=psi,
        max_iter=max_iter, max_attempts=max_attempts, verbose=verbose,
    )

    pred = gpz_tpu_torch.predict(X[:, None], model, psi=psi, selection=te)
    err = Y[te] - pred.mu[:, 0]
    out = {
        "rmse": float(np.sqrt(np.mean(err**2))),
        "mll": float(np.mean(-0.5 * err**2 / pred.sigma[:, 0]
                             - 0.5 * np.log(pred.sigma[:, 0]))
                     - 0.5 * math.log(2 * math.pi)),
    }

    # posterior-sample curves (ref demo_sinc.m:77-87): weights drawn from
    # N(w, SIGMA^-1) pushed through the design matrix on a dense grid; their
    # spread blows up inside the gap and stays tight on the support
    Xs = np.linspace(-10, 10, GRID)
    grid = gpz_tpu_torch.predict(Xs[:, None], model)
    ws = gpz_tpu_torch.sample_weights(model, n_samples=CURVES, seed=seed)
    mus = grid.phi @ ws[:, 0, :] + model.muY[0]          # (GRID, CURVES)
    spread = mus.std(axis=1)
    in_gap = (Xs > GAP[0]) & (Xs < GAP[1])
    out["spread_gap"] = float(spread[in_gap].mean())
    out["spread_support"] = float(spread[~in_gap].mean())
    out["plot"] = None if plot is None else _plot(
        plot, X, Y, Xs, grid, mus)
    out["fits"] = [model.fit_info]
    out["seconds"] = time.perf_counter() - t0
    return out


def _plot(path, X, Y, Xs, grid, mus):
    """The JAX script's figure, written to `path`; None without
    matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    band = 2.0 * np.sqrt(grid.sigma[:, 0])
    plt.fill_between(Xs, grid.mu[:, 0] - band, grid.mu[:, 0] + band,
                     color="0.85", label=r"$\pm 2\sigma(x)$")
    plt.plot(X, Y, "b.", markersize=2)
    plt.plot(Xs, mus, linewidth=0.5)
    plt.plot(Xs, fx(Xs), "k-", linewidth=2, label="sinc(x)")
    plt.plot(Xs, grid.mu[:, 0], "r-", linewidth=2, label=r"$\mu(x)$")
    plt.legend(loc="upper left")
    plt.savefig(path, dpi=120)
    plt.close()
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="demo_sinc")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    ap.add_argument("--m", type=int, default=100)
    ap.add_argument("--method", default="VL")
    ap.add_argument("--max-iter", type=int, default=500)
    ap.add_argument("--max-attempts", type=int, default=50)
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--no-input-noise", action="store_true")
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--plot", default=None,
                    help="write the posterior-curve figure here (PNG)")
    args = ap.parse_args(argv)

    r = run(n=args.n, m=args.m, method=args.method, max_iter=args.max_iter,
            max_attempts=args.max_attempts,
            no_input_noise=args.no_input_noise, dtype=args.dtype,
            seed=args.seed, device=args.device, verbose=True, plot=args.plot)
    print("Scores on Test Set")
    print("RMSE\t\tMLL")
    print(f"{r['rmse']:.6f}\t{r['mll']:.6f}")
    print(f"Posterior-sample curves ({CURVES} draws from N(w, iSigma_w)):")
    print(f"  mean curve spread in the training gap:  {r['spread_gap']:.4f}")
    print(f"  mean curve spread on-support:           "
          f"{r['spread_support']:.4f}")
    if r["plot"] is not None:
        print(f"  wrote {r['plot']}")


if __name__ == "__main__":
    main()
