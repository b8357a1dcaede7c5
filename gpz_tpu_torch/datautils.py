"""Data canonicalization and weighting utilities.

A NumPy copy of gpz_tpu.datautils (which cannot be imported without JAX).
Host-side helpers mirroring the reference's data plumbing:
  * `fix_psi`   — canonicalize user input-noise variances, ref GPz/fixPsi.m
  * `split`     — random train/valid/test masks, ref GPz/sample.m
  * `get_omega` — cost-sensitive weights, ref GPz/getOmega.m
  * `normalization_stats` — NaN-aware muX/sdX + muY, ref GPz/init.m:22-43
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def fix_psi(psi, n: int, sdX: np.ndarray, full_cov: bool):
    """Canonicalize input-noise variances and rescale by sdX.

    Accepts (ref GPz/fixPsi.m:10-54):
      * scalar-per-row (n,) or (n, 1) — isotropic noise variance
      * diag-per-row (n, d)
      * full cubes (n, d, d)  [note: the reference uses MATLAB (d, d, n);
        the row-major convention here is (n, d, d)]
    Returns (n, d, d) for the full-covariance family, (n, d) otherwise,
    divided by the appropriate sdX outer products.
    """
    if psi is None:
        return None
    psi = np.asarray(psi, dtype=np.float64)
    d = len(sdX)
    if psi.ndim == 1:
        psi = psi[:, None]
    if psi.ndim == 2 and psi.shape == (n, 1):
        diag = np.broadcast_to(psi, (n, d)).copy()
        cube = None
    elif psi.ndim == 2 and psi.shape == (n, d):
        diag = psi
        cube = None
    elif psi.ndim == 3 and psi.shape == (n, d, d):
        diag = None
        cube = psi
    else:
        raise ValueError(
            f"Psi must be (n,), (n,1), (n,{d}) or (n,{d},{d}); got {psi.shape}"
        )

    if full_cov:
        ss = np.outer(sdX, sdX)
        if cube is None:
            out = np.zeros((n, d, d))
            idx = np.arange(d)
            out[:, idx, idx] = diag / sdX[None, :] ** 2
            return out
        return cube / ss[None, :, :]
    else:
        if cube is None:
            return diag / sdX[None, :] ** 2
        idx = np.arange(d)
        return cube[:, idx, idx] / sdX[None, :] ** 2


def split(
    n: int,
    train: float,
    valid: float,
    test: float,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random train/valid/test boolean masks; fractions or absolute counts.

    Ref GPz/sample.m:3-17 (same assignment order: valid, test, then train).
    """
    rng = rng or np.random.default_rng()
    if train < 1:
        valid = int(np.ceil(n * valid))
        test = int(np.ceil(n * test))
        train = min(int(np.ceil(n * train)), n - test - valid)
    train, valid, test = int(train), int(valid), int(test)
    r = rng.permutation(n)
    training = np.zeros(n, dtype=bool)
    validation = np.zeros(n, dtype=bool)
    testing = np.zeros(n, dtype=bool)
    validation[r[:valid]] = True
    testing[r[valid : valid + test]] = True
    training[r[valid + test : valid + test + train]] = True
    return training, validation, testing


def get_omega(Y, method: str = "normal", bin_width: Optional[float] = None):
    """Cost-sensitive learning weights, ref GPz/getOmega.m.

    'balanced'   — inverse-histogram weights (rare targets weighted up)
    'normalized' — omega = (1 + y)^-2 (photo-z convention; NB the reference
                   README says 1/(1+z) but the code squares, getOmega.m:19)
    'normal'     — all ones
    """
    Y = np.asarray(Y, dtype=np.float64).reshape(-1)
    n = len(Y)
    if method == "balanced":
        ymin, ymax = Y.min(), Y.max()
        if bin_width is None:
            bin_width = (ymax - ymin) / 100
        bins = int(np.ceil((ymax - ymin) / bin_width))
        centers = ymin + (np.arange(1, bins + 1)) * bin_width - bin_width / 2
        # nearest-center histogram (ref uses hist + min-distance assignment)
        idx = np.abs(Y[:, None] - centers[None, :]).argmin(axis=1)
        counts = np.bincount(idx, minlength=bins).astype(np.float64)
        counts[counts == 0] = 1.0
        return counts.max() / counts[idx]
    elif method == "normalized":
        return (1.0 + Y) ** -2
    elif method == "normal":
        return np.ones(n)
    raise ValueError(f"unknown omega method {method!r}")


def normalization_stats(X, Y, training=None, normalize: bool = True):
    """NaN-aware input stats + training-target mean, ref GPz/init.m:22-43.

    sdX uses the population formula sqrt(E[x^2] - E[x]^2) over observed
    entries, exactly as init.m:29-32.
    """
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, d = X.shape
    if training is None:
        training = np.ones(n, dtype=bool)
    if normalize:
        missing = np.isnan(X)
        Xz = np.where(missing, 0.0, X)
        counts = (~missing).sum(axis=0).astype(np.float64)
        muX = Xz.sum(axis=0) / counts
        ex2 = (Xz**2).sum(axis=0) / counts
        sdX = np.sqrt(ex2 - muX**2)
    else:
        muX = np.zeros(d)
        sdX = np.ones(d)
    muY = Y[training].mean(axis=0)
    return muX, sdX, muY
