"""The benchmark's data, drawn from the run's seed: frozen copies of the
photo-z generator (gpz_tpu_torch.data.synthetic_sdss), of the missing-band
rule (tests/make_torch_port_golden.py::inject_missing), of the north star's
training split (gpz_tpu_torch.bench_convergence.build_problem) and of the
scale configuration's split (make_torch_port_golden.scale_problem).

Copies, so that a change to the program cannot move the yardstick: the
benchmark hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, *tags: int) -> np.random.Generator:
    """A generator for one use of a run's seed (any non-negative integer,
    however large), kept apart from its other uses by `tags`."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *tags]))


def _draw_tags(tag: int, draw: int) -> tuple:
    """The tags of one use of the seed in a given draw: draw 0 is the
    seed's first, and each later draw is one of its own."""
    return (tag,) if draw == 0 else (tag, draw)


def init_seed(seed: int, draw: int = 0) -> int:
    """The seed from which `init` draws the basis centres, from the run's
    (and from the draw's, see training_problem)."""
    return int(rng_for(seed, *_draw_tags(4, draw)).integers(2**32))


def synthetic_sdss(n: int, filters: int, rng: np.random.Generator):
    """SDSS-like photo-z sample: (mags (n, f), errs (n, f), z (n,)). The
    draws of gpz_tpu_torch.data.synthetic_sdss, in its order, from `rng`."""
    z = np.clip(rng.gamma(2.2, 0.13, size=n), 0.001, 1.2)
    r = 17.0 + 3.2 * np.sqrt(z) + rng.standard_normal(n) * 0.8
    zz = z[:, None]
    coefs = np.linspace(1.5, -1.0, filters)[None, :]
    curves = (coefs * np.log1p(2.5 * zz)
              + 0.4 * np.sin(3.0 * zz + np.arange(filters)[None, :]))
    mags = r[:, None] + curves + rng.standard_normal((n, filters)) * 0.05
    errs = np.clip(0.01 + 0.05 * np.exp((mags - 21.0) / 1.5), 0.005, 1.0)
    mags = mags + rng.standard_normal((n, filters)) * errs
    return mags, errs, z


def inject_missing(X, shares, rng: np.random.Generator):
    """A copy of X with NaNs: of its rows, taken in one permutation, the
    share `shares["first"]` loses the first band (u), `shares["last"]` the
    last (z) and `shares["both"]` both, as make_torch_port_golden's rule
    (25%, 10%, 5%)."""
    n = len(X)
    order = rng.permutation(n)
    a, b, c = (int(round(shares[k] * n)) for k in ("first", "last", "both"))
    X = np.array(X, dtype=np.float64)
    X[order[:a], 0] = np.nan
    X[order[a:a + b], -1] = np.nan
    both = order[a + b:a + b + c]
    X[both, 0] = np.nan
    X[both, -1] = np.nan
    return X


def training_problem(cfg: dict, seed: int, draw: int = 0):
    """(X, Y, psi, training, validation) of a configuration: one draw of
    cfg["n_train"] + cfg["n_valid"] rows, psi = errs**2 (each row's
    diagonal input noise; the program widens it to (n, d, d)), the first
    n_train rows train and the rest validate: build_problem's recipe and
    scale_problem's split, drawn from the run's seed. `draw` k > 0 is the
    seed's k-th further draw, for a recipe that draws again."""
    n = cfg["n_train"] + cfg["n_valid"]
    mags, errs, z = synthetic_sdss(n, cfg["d"],
                                   rng_for(seed, *_draw_tags(1, draw)))
    tr = np.zeros(n, bool)
    tr[:cfg["n_train"]] = True
    return mags, z, errs ** 2, tr, ~tr


def catalogue(cfg: dict, rows: int, missing, seed: int):
    """(X, psi) of the catalogue a serving cell serves: `rows` fresh rows of
    the same generator, psi = errs**2, with bands lost by `missing` (None:
    every band observed)."""
    mags, errs, _ = synthetic_sdss(rows, cfg["d"], rng_for(seed, 2))
    if missing:
        mags = inject_missing(mags, missing, rng_for(seed, 3))
    return mags, errs ** 2
