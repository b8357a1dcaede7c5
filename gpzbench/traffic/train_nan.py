"""Training jobs on rows with unobserved bands: train.py's jobs (whole
`gpz_tpu_torch.model.train` runs from one initial model, recorded, and
the window that runs them) on a calibration sample whose rows lose bands
by the mix's `missing` shares (data.inject_missing), training and
validation rows alike, held to the NaN-aware reference
(reference/gpz_nan.py).

The sample and the initial model's centres are drawn once, from the
configuration's `sample_seed`; the run's seed draws the order of the
training rows and of the validation rows. So every seed trains the same
model on the same rows, and a job does the same work on every seed:
drawn from the run's seed, the rows or the centres alone set how many
evaluations L-BFGS takes for a job's iterations (8, 10 or 11 for 5), and
train_iters_per_s with them (0.70-0.92).

The mix's file gives each job's iteration cap (`max_iter`) and the shares
of rows that lose the first band, the last, or both. Set-up draws the
problem, builds the initial model with `init` on its rows with NaNs, and
drives it through its first iterations by the window's own call. The
check is train.py's, against gpz_nan's init, objective and optimizer
steps.
"""

from __future__ import annotations

import dataclasses
import os
import types

import numpy as np

from gpzbench import data, faults, harness
from gpzbench.reference import gpz_nan

_train = harness.load_module(os.path.join(harness.HERE, "traffic",
                                          "train.py"),
                             "gpzbench_traffic_train_for_nan")
# this copy's check follows the NaN-aware reference
_train.ref = gpz_nan
window, end_to_end = _train.window, _train.end_to_end

#: the faults a training cell can have (faults.py)
FAULTS = ("state_unchanged", "half_batch")


def problem(cfg: dict, missing: dict, seed: int):
    """(X, Y, psi, training, validation) of the configuration's sample,
    drawn from its sample_seed with NaNs by the shares `missing` over all
    its rows, in an order drawn from the run's seed (the training rows
    stay first)."""
    sample = cfg["sample_seed"]
    X, Y, psi, tr, va = data.training_problem(cfg, sample)
    X = data.inject_missing(X, missing, data.rng_for(sample, 5))
    rng = data.rng_for(seed, 5)
    n = cfg["n_train"]
    order = np.concatenate([rng.permutation(n),
                            n + rng.permutation(cfg["n_valid"])])
    return X[order], Y[order], psi[order], tr, va


def setup(ctx):
    import gpz_tpu_torch as g

    cfg, mix = ctx.cell.cfg, ctx.cell.traffic
    prob = problem(cfg, mix["missing"], ctx.seed)
    X, Y, psi, tr, va = prob
    model0 = g.init(X, Y, cfg["method"], cfg["m"], heteroscedastic=True,
                    training=tr, psi=psi,
                    seed=data.init_seed(cfg["sample_seed"]),
                    dtype=cfg["param_dtype"],
                    solve_dtype=(faults.TRAIN_CONTROL_SOLVE if ctx.control
                                 else "auto"),
                    device=ctx.device)
    state = types.SimpleNamespace(
        ctx=ctx, cfg=cfg, problem=prob, model0=model0, train=g.train,
        x0=gpz_nan.flatten(model0.last.params.to_numpy()),
        max_iter=mix["max_iter"] or cfg["max_iter"])
    state.first = _train._recorded_job(state, ctx.cell.spec["steps"])[1]
    return state


def check(state, rec):
    """train.py's check, its reference init drawn from the centres' seed
    that set-up's init took: the sample's, not the run's."""
    ctx = dataclasses.replace(state.ctx, seed=state.cfg["sample_seed"])
    return _train.check(types.SimpleNamespace(**{**vars(state), "ctx": ctx}),
                        rec)
