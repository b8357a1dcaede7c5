"""Multi-restart ensemble training (gpz_tpu.ensemble).

The reference's random center initialization (ref GPz/init.m:58) makes
multi-restart training embarrassingly parallel (SURVEY §2.3: the GPz analogue
of ensemble/expert parallelism). gpz_tpu runs all restarts as one vmapped
L-BFGS program, in which a restart that has finished is frozen, so each
restart's result is that restart trained alone. The port's optimizer is a
host loop around device evaluations (optim/lbfgs.py), so here the restarts
are trained one after another on one device, each by the same `minimize`;
with a mesh, the restarts are split over its restart group and each rank
trains its own, on rows split over its data group.
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
from gpz_tpu_torch.parallel import sharded
from gpz_tpu_torch.parallel.mesh import DATA_AXIS, RESTART_AXIS, Mesh


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
    without one torch's own error is raised). With `mesh`
    (parallel.make_mesh; every rank calls fit_ensemble with the same
    arguments), restart r is trained by the ranks at restart index
    r % (restart group's size), on rows split over their data group
    (sharded.train_sharded's objective), and every rank returns the same
    best model and info: the restarts' results are assembled by one
    all-reduce over the restart group.

    Precision: every restart trains in float64, as `train` does, and the
    chosen model is stored in `dtype`. gpz_tpu's ensemble trains in `dtype`
    itself, so the two agree at dtype="float64" only.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a gpz_tpu_torch.parallel.make_mesh() "
                        f"mesh, got {type(mesh).__name__}")
    if mesh is None:
        mine = list(range(n_restarts))
    else:
        n_r = mesh.size(RESTART_AXIS)
        if n_restarts < n_r:
            raise ValueError(f"{n_restarts} restarts for a restart group of "
                             f"{n_r} ranks")
        mine = list(range(mesh.get_local_rank(RESTART_AXIS), n_restarts,
                          n_r))
    models = [
        model_mod.init(
            X, Y, method, m,
            heteroscedastic=heteroscedastic, normalize=normalize,
            omega=omega, training=training, psi=psi,
            seed=seed + r, dtype=dtype, device=device,
        )
        for r in mine
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

    if mesh is None:
        fun = model_mod._objective(unravel, data_tr, cfg64, complete_tr)
        valid = (data_va, None, lambda x: x) if has_valid else None
    else:
        # every rank holds all rows, so the complete flags already agree
        fun_s = sharded.sharded_value_and_grad(unravel, cfg64, mesh,
                                               complete_tr)
        shard_tr, n_tr = sharded.shard_dataset(data_tr, mesh)
        fun = lambda flat: fun_s(flat, shard_tr, n_tr)  # noqa: E731
        if has_valid:
            valid = (*sharded.shard_dataset(data_va, mesh),
                     sharded.sum_over(mesh.get_group(DATA_AXIS)))

    score_fn = None
    if has_valid:
        rows_va, n_va, reducer = valid

        def score_fn(flat, aux):
            rmse, ll = holdout_metrics(unravel(flat), aux.w, rows_va, cfg64,
                                       n_eff=n_va, complete=complete_va,
                                       reducer=reducer)
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

    # per restart: score, iterations, evaluations, x, x_best
    p = flat0s[0].shape[0]
    table = torch.zeros((n_restarts, 3 + 2 * p), dtype=f64, device=dev)
    for r_, rs in zip(mine, res):
        table[r_, :3] = torch.tensor(
            [rs.best_score, rs.iterations, rs.fun_evals], dtype=f64)
        table[r_, 3:3 + p] = rs.x
        table[r_, 3 + p:] = rs.x_best
    if mesh is not None:
        # each restart group holds each restart once; adding zeros keeps
        # its bits
        sharded.all_reduce(table, mesh.get_group(RESTART_AXIS))
    head = table[:, :3].cpu().numpy()
    scores = head[:, 0].copy()
    best_r = int(np.argmax(scores))
    state = (unravel, data_tr, cfg64, complete_tr, cfg.dtype)
    best_model = model_mod.GPzModel(
        cfg=cfg, muX=base.muX, sdX=base.sdX, muY=base.muY,
        last=model_mod._resolve(table[best_r, 3:3 + p], -math.inf, *state),
        best=model_mod._resolve(table[best_r, 3 + p:], float(scores[best_r]),
                                *state),
        fit_info={
            "restart_scores": scores,
            "best_restart": best_r,
            "iterations": head[:, 1].astype(np.int64),
            "fun_evals": head[:, 2].astype(np.int64),
        },
    )
    return best_model, best_model.fit_info
