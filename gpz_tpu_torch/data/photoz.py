"""Photo-z dataset plumbing (a NumPy copy of gpz_tpu.data.photoz, importable
without JAX; same generator, same draw order).

`load_sdss_csv` reads the reference's CSV layout (ref demo_photoz.m:35-43):
columns m_1..m_f, e_1..e_f, z_spec — magnitudes, their uncertainties, and the
spectroscopic redshift. `synthetic_sdss` generates a statistically similar
sample (the real file is a stripped blob in the reference mount,
.MISSING_LARGE_BLOBS) for benchmarks and integration tests.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def load_sdss_csv(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (mags (n, f), errs (n, f), z (n,))."""
    raw = np.loadtxt(path, delimiter=",")
    z = raw[:, -1]
    rest = raw[:, :-1]
    f = rest.shape[1] // 2
    return rest[:, :f], rest[:, f:], z


def synthetic_sdss(
    n: int = 180_000,
    filters: int = 5,
    seed: int = 0,
    missing_frac: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SDSS-like synthetic photo-z sample (ugriz magnitudes + errors + z).

    A smooth nonlinear color-redshift relation plus realistic magnitude
    errors growing toward the faint end. Used where the reference relied on
    data/sdss_sample.csv.
    """
    rng = np.random.default_rng(seed)
    # redshift distribution ~ gamma, truncated (SDSS main+LRG-ish)
    z = rng.gamma(2.2, 0.13, size=n)
    z = np.clip(z, 0.001, 1.2)

    # base r-band magnitude correlates with z
    r = 17.0 + 3.2 * np.sqrt(z) + rng.standard_normal(n) * 0.8
    # colors as smooth functions of z with scatter
    zz = z[:, None]
    coefs = np.linspace(1.5, -1.0, filters)[None, :]
    curves = (
        coefs * np.log1p(2.5 * zz)
        + 0.4 * np.sin(3.0 * zz + np.arange(filters)[None, :])
    )
    mags = r[:, None] + curves + rng.standard_normal((n, filters)) * 0.05

    # errors grow exponentially toward the faint end
    errs = 0.01 + 0.05 * np.exp((mags - 21.0) / 1.5)
    errs = np.clip(errs, 0.005, 1.0)
    mags = mags + rng.standard_normal((n, filters)) * errs

    if missing_frac > 0:
        drop = rng.random((n, filters)) < missing_frac
        drop[drop.all(axis=1), 0] = False
        mags[drop] = np.nan
    return mags, errs, z
