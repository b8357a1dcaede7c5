"""Multi-restart ensemble training (gpz_tpu.ensemble).

The reference's random center initialization (ref GPz/init.m:58) makes
multi-restart training embarrassingly parallel (SURVEY §2.3: the GPz analogue
of ensemble/expert parallelism). gpz_tpu runs all restarts as one vmapped
L-BFGS program, in which a restart that has finished is frozen, so each
restart's result is that restart trained alone. The port's optimizer is a
host loop around device evaluations (optim/lbfgs.py), so here the restarts
are trained one after another on one device, each by the same `minimize`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gpz_tpu_torch import datautils
from gpz_tpu_torch import model as model_mod
from gpz_tpu_torch.config import TrainConfig
from gpz_tpu_torch.objective import holdout_metrics
from gpz_tpu_torch.optim import minimize


def fit_ensemble(
    X,
    Y,
    method: str = "VL",
    m: int = 100,
    n_restarts: int = 4,
    *,
    heteroscedastic: bool = True,
    normalize: bool = True,
    omega=None,
    training=None,
    validation=None,
    psi=None,
    max_iter: int = 200,
    max_attempts: Optional[int] = None,
    seed: int = 0,
    dtype: str = "float32",
    mesh=None,
    device=None,
):
    """Initialize `n_restarts` models (seeds seed, seed + 1, ...) and train
    each by L-BFGS with validation early stopping; returns (best GPzModel,
    info dict with per-restart scores, iterations and evaluations).

    The restarts run one after another on `device` (None: the CUDA device;
    without one torch's own error is raised). `mesh` (gpz_tpu's restarts
    spread over the devices of a mesh) waits for the port's parallel slice:
    any value but None raises.

    Precision: every restart trains in float64, as `train` does, and the
    chosen model is stored in `dtype`. gpz_tpu's ensemble trains in `dtype`
    itself, so the two agree at dtype="float64" only.
    """
    if mesh is not None:
        raise NotImplementedError(
            "fit_ensemble(mesh=...) spreads restarts over the devices of a "
            "mesh, which waits for the port's parallel slice "
            "(gpz_tpu.parallel); call it with mesh=None")
    models = [
        model_mod.init(
            X, Y, method, m,
            heteroscedastic=heteroscedastic, normalize=normalize,
            omega=omega, training=training, psi=psi,
            seed=seed + r, dtype=dtype, device=device,
        )
        for r in range(n_restarts)
    ]
    cfg = models[0].cfg
    cfg64 = dataclasses.replace(cfg, dtype="float64")

    # shared preprocessing (identical stats across restarts by construction
    # since they come from the data, not the seed)
    base = models[0]
    dev = base.last.params.P.device
    Xa = np.asarray(X, dtype=np.float64)
    Ya = np.asarray(Y, dtype=np.float64)
    if Ya.ndim == 1:
        Ya = Ya[:, None]
    n = Xa.shape[0]
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)
    Xn = (Xa - base.muX[None, :]) / base.sdX[None, :]
    Yc = Ya - base.muY[None, :]
    psi_c = datautils.fix_psi(psi, n, base.sdX, cfg.full_cov)
    f64 = torch.float64
    data_tr = model_mod._make_dataset(Xn, Yc, psi_c, omega, training, f64, dev)
    complete_tr = model_mod._complete(data_tr)

    has_valid = validation is not None and bool(np.any(validation))
    if has_valid:
        data_va = model_mod._make_dataset(Xn, Yc, psi_c, omega, validation,
                                          f64, dev)
        complete_va = model_mod._complete(data_va)

    flat0s = []
    for mod in models:
        flat, unravel = mod.last.params.astype(f64).flatten()
        flat0s.append(flat)

    fun = model_mod._objective(unravel, data_tr, cfg64, complete_tr)

    score_fn = None
    if has_valid:
        def score_fn(flat, aux):
            rmse, ll = holdout_metrics(unravel(flat), aux.w, data_va, cfg64,
                                       complete=complete_va)
            return ll, {"valid_rmse": rmse, "valid_ll": ll}

    tc = TrainConfig(max_iter=max_iter, max_attempts=max_attempts)
    res = [
        minimize(
            fun, flat0,
            history=tc.history, max_iter=tc.max_iter,
            opt_tol=tc.opt_tol, prog_tol=tc.prog_tol,
            c1=tc.c1, c2=tc.c2, max_ls=tc.max_ls,
            score_fn=score_fn, max_attempts=tc.max_attempts,
        )
        for flat0 in flat0s
    ]

    scores = np.array([r.best_score for r in res], dtype=np.float64)
    best_r = int(np.argmax(scores))
    state = (unravel, data_tr, cfg64, complete_tr, cfg.dtype)
    best_model = model_mod.GPzModel(
        cfg=cfg, muX=base.muX, sdX=base.sdX, muY=base.muY,
        last=model_mod._resolve(res[best_r].x, -math.inf, *state),
        best=model_mod._resolve(res[best_r].x_best, float(scores[best_r]),
                                *state),
        fit_info={
            "restart_scores": scores,
            "best_restart": best_r,
            "iterations": np.array([r.iterations for r in res]),
            "fun_evals": np.array([r.fun_evals for r in res]),
        },
    )
    return best_model, best_model.fit_info
