"""Evaluation metrics library (ref GPz/metrics.m, bin.m, reduce.m +
score definitions from demo_photoz.m:89-101). A NumPy copy of
gpz_tpu.metrics, importable without JAX."""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np

_LN2PI = math.log(2.0 * math.pi)


# --- score functions (ref demo_photoz.m:89-101) -----------------------------

def sq_error(y, mu, sigma):
    return (y - mu) ** 2


def log_likelihood(y, mu, sigma):
    return -0.5 * (y - mu) ** 2 / sigma - 0.5 * np.log(sigma) - 0.5 * _LN2PI


def fr15(y, mu, sigma):
    return 100.0 * (np.abs(y - mu) / (y + 1) < 0.15)


def fr05(y, mu, sigma):
    return 100.0 * (np.abs(y - mu) / (y + 1) < 0.05)


def bias(y, mu, sigma):
    return y - mu


def cumulative_by_confidence(
    y: np.ndarray, mu: np.ndarray, sigma: np.ndarray, fun: Callable
) -> np.ndarray:
    """Cumulative mean of fun(y, mu, sigma) ordered by predicted confidence.

    "Metric vs % of most-confident data" curves, ref GPz/metrics.m:5-11.
    The last element is the metric over the full set.
    """
    y, mu, sigma = (np.asarray(a).reshape(-1) for a in (y, mu, sigma))
    order = np.argsort(sigma)
    scores = fun(y[order], mu[order], sigma[order])
    return np.cumsum(scores) / np.arange(1, len(y) + 1)


def rmse_curve(y, mu, sigma):
    return np.sqrt(cumulative_by_confidence(y, mu, sigma, sq_error))


def binned(
    x: np.ndarray, y: np.ndarray, bins: int = 100
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Binned mean/std of y vs x (nearest-center binning), ref GPz/bin.m:7-26.

    Returns (centers, means, stds) with empty bins removed.
    """
    x, y = np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)
    centers = np.linspace(x.min(), x.max(), bins)
    idx = np.abs(x[:, None] - centers[None, :]).argmin(axis=1)
    counts = np.bincount(idx, minlength=bins).astype(np.float64)
    sums = np.bincount(idx, weights=y, minlength=bins)
    safe = np.where(counts == 0, 1.0, counts)
    means = sums / safe
    sq = np.bincount(idx, weights=(y - means[idx]) ** 2, minlength=bins)
    stds = np.sqrt(sq / safe)
    keep = counts > 0
    return centers[keep], means[keep], stds[keep]


def reduce_scatter(
    x: np.ndarray,
    y: np.ndarray,
    color: Optional[np.ndarray] = None,
    bins: int = 200,
):
    """2-D histogram downsampling for scatter plots, ref GPz/reduce.m:4-24.

    Returns (x_centers, y_centers, color, counts) for occupied cells; color is
    log(count) when no color array is given, else the per-cell mean.
    """
    x, y = np.asarray(x).reshape(-1), np.asarray(y).reshape(-1)
    mnx, mny = x.min(), y.min()
    wx = (x.max() - mnx) / bins
    wy = (y.max() - mny) / bins
    xi = np.minimum((np.floor((x - mnx) / wx)).astype(int), bins - 1)
    yi = np.minimum((np.floor((y - mny) / wy)).astype(int), bins - 1)
    flat = xi * bins + yi
    uniq, inv, counts = np.unique(flat, return_inverse=True, return_counts=True)
    if color is None:
        cell_color = np.log(counts.astype(np.float64))
    else:
        sums = np.bincount(inv, weights=np.asarray(color).reshape(-1))
        cell_color = sums / counts
    cx = (uniq // bins) * wx + wx / 2 + mnx
    cy = (uniq % bins) * wy + wy / 2 + mny
    return cx, cy, cell_color, counts
