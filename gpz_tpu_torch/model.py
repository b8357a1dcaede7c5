"""Model lifecycle: init -> train -> predict (gpz_tpu.model; ref GPz/init.m,
train.m, predict.m).

Host-side orchestration around the device computations. A model is
normalization stats plus two parameter sets, `last` (current theta) and
`best` (validation-selected theta), each with its derived posterior state
(ref init.m:106-120, train.m:53-80). `train` may be called repeatedly: it
restarts from `last` and preserves `best` across calls (ref train.m:8-11).

`init` and `checkpoint.load_model` place a model on the CUDA device unless
told otherwise; `train` and `predict` run where the model's parameters are.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from gpz_tpu_torch.config import ModelConfig, TrainConfig
from gpz_tpu_torch.dataset import Dataset
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.objective import (
    Posterior, holdout_metrics, nlog_ml, nlog_ml_batched, posterior,
)
from gpz_tpu_torch.prior import get_prior
from gpz_tpu_torch.optim import minimize
from gpz_tpu_torch import datautils
from gpz_tpu_torch import predict as predict_mod


@dataclasses.dataclass
class ParamSet:
    """One resolved parameter set with derived posterior state
    (ref model.last / model.best, init.m:104-120)."""

    params: GPzParams
    post: Posterior
    priors: torch.Tensor     # (m,) mixture prior over bases (ref getPrior.m)
    score: float = -math.inf  # validation LL (ref model.best.LL)

    def astype(self, dtype: torch.dtype) -> "ParamSet":
        post = Posterior(*(t.to(dtype) for t in (
            self.post.w, self.post.iSigma_w, self.post.logdet)))
        return ParamSet(self.params.astype(dtype), post,
                        self.priors.to(dtype), self.score)


@dataclasses.dataclass
class GPzModel:
    cfg: ModelConfig
    muX: np.ndarray
    sdX: np.ndarray
    muY: np.ndarray
    last: ParamSet
    best: ParamSet
    fit_info: Optional[dict] = None

    def astype(self, dtype: str) -> "GPzModel":
        """The model with cfg.dtype and every parameter set cast to `dtype`
        ("float32" or "float64")."""
        tdt = getattr(torch, dtype)
        return dataclasses.replace(
            self, cfg=dataclasses.replace(self.cfg, dtype=dtype),
            last=self.last.astype(tdt), best=self.best.astype(tdt),
        )


@dataclasses.dataclass
class Prediction:
    mu: np.ndarray
    sigma: np.ndarray
    nu: np.ndarray
    beta_i: np.ndarray
    gamma: np.ndarray
    phi: np.ndarray


class _LiveRowPrinter:
    """Streamed per-iteration table row (ref GPz/callBack.m:16-46), the
    optimizer's `iter_callback`: a long run shows progress, and early
    stopping approaching, live. The `[...]` brackets mark a new validation
    best (callBack.m:26-34)."""

    def __init__(self, has_valid: bool):
        self.has_valid = has_valid
        self.t0 = time.perf_counter()

    def __call__(self, it, f, opt_cond, step, score, improved, extras):
        if it == 0:
            self.t0 = time.perf_counter()
            if self.has_valid:
                print("\tIter\tlogML/n\t\tTrain RMSE\tTrain MLL"
                      "\tValid RMSE\tValid MLL\tTime", flush=True)
            else:
                print("\tIter\tlogML/n\t\tTime", flush=True)
        dt = time.perf_counter() - self.t0
        if self.has_valid:
            vr = f"{float(extras['valid_rmse']):.5e}"
            vl = f"{float(extras['valid_ll']):.5e}"
            if improved:
                vr, vl = f"[{vr}]", f"[{vl}]"
            print(
                f"\t{it}\t{-float(f):.5e}\t"
                f"{float(extras['train_rmse']):.5e}\t"
                f"{float(extras['train_ll']):.5e}\t{vr}\t{vl}\t{dt:.2f}",
                flush=True,
            )
        else:
            print(f"\t{it}\t{-float(f):.5e}\t{dt:.2f}", flush=True)


def _print_trace(fit_info, has_valid):
    """Post-hoc iteration table (ref GPz/callBack.m:16-46)."""
    tr = fit_info["trace"]
    n_it = fit_info["iterations"]
    if has_valid:
        print("\tIter\tlogML/n\t\tTrain RMSE\tTrain MLL\tValid RMSE"
              "\tValid MLL")
        ex = tr["extras"]
        for i in range(n_it + 1):
            print(
                f"\t{i}\t{-tr['f'][i]:.5e}\t{ex['train_rmse'][i]:.5e}"
                f"\t{ex['train_ll'][i]:.5e}\t{ex['valid_rmse'][i]:.5e}"
                f"\t{ex['valid_ll'][i]:.5e}"
            )
    else:
        print("\tIter\tlogML/n")
        for i in range(n_it + 1):
            print(f"\t{i}\t{-tr['f'][i]:.5e}")
    print(f"\t[{fit_info['iterations']} iters, "
          f"{fit_info['fun_evals']} evals, status={fit_info['status']}]")


def _make_dataset(Xn, Yc, psi, omega, rows, dtype, device) -> Dataset:
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    Xr = Xn[rows]
    mask = ~np.isnan(Xr)
    return Dataset(
        X=dev(np.where(mask, Xr, 0.0)),
        mask=torch.as_tensor(mask, device=device),
        omega=dev(omega[rows]),
        Y=None if Yc is None else dev(Yc[rows]),
        psi=None if psi is None else dev(psi[rows]),
    )


#: rows of one block of init's length-scale heuristic: the (rows, m)
#: distances of a block and their temporaries stay within a few hundred MB
#: whatever n is (at n = 10**6 and m = 1000 one (n, m) float64 array is 8 GB)
INIT_BLOCK_ROWS = 65536


def _mean_sq_dist(Xl, P):
    """mean over the rows of Xl (n, d) of |x - p_j|^2 for every center p_j
    of P (m, d), as gpz_tpu.init computes it (|x|^2 + |p|^2 - 2 x.p, taken
    absolute), over blocks of INIT_BLOCK_ROWS rows whose column sums add up
    in block order. One block (n <= INIT_BLOCK_ROWS) is gpz_tpu's expression
    and gives its bits; several round the matrix product and the sum per
    block, ~1e-16 relative."""
    p2 = (P**2).sum(1)[None, :]
    total = np.zeros(P.shape[0])
    for r0 in range(0, Xl.shape[0], INIT_BLOCK_ROWS):
        Xb = Xl[r0:r0 + INIT_BLOCK_ROWS]
        D = np.abs((Xb**2).sum(1)[:, None] + p2 - 2.0 * Xb @ P.T)
        total += D.sum(axis=0)
    return total / Xl.shape[0]


def _complete(data: Dataset) -> bool:
    """All rows observed? The whole-dataset hint that phi.log_phi takes."""
    return bool(data.mask.all())


def _objective(unravel, data: Dataset, cfg64: ModelConfig, complete: bool):
    """fun(flat) -> (nlml, flat gradient, aux) of nlog_ml on `data`, the
    objective that `optim.minimize` takes (float64 flat parameters)."""

    def fun(flat):
        flat = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            nlml, aux = nlog_ml(unravel(flat), data, cfg64, complete=complete)
            grad, = torch.autograd.grad(nlml, flat)
        return nlml.detach(), grad, aux

    return fun


def _objective_batched(unravel, data: Dataset, cfg64: ModelConfig,
                       complete: bool):
    """fun(flats (B, p)) -> (nlml (B,), flat gradients (B, p), Aux with a
    leading B) of nlog_ml_batched on `data`, the objective that
    `optim.minimize_batched` takes: B sets in one call of the design
    matrix."""

    def fun(flats):
        flats = flats.detach().requires_grad_(True)
        with torch.enable_grad():
            nlml, aux = nlog_ml_batched(flats, unravel, data, cfg64,
                                        complete, lanes=True)
            grad, = torch.autograd.grad(nlml.sum(), flats)
        return nlml.detach(), grad, aux

    return fun


def _resolve(flat, score, unravel, data: Dataset, cfg64: ModelConfig,
             complete: bool, dtype: str) -> ParamSet:
    """The ParamSet of float64 flat parameters: posterior state and priors
    computed in float64 on the training rows, everything stored in `dtype`."""
    dt = getattr(torch, dtype)
    params = unravel(flat)
    post = posterior(params, data, cfg64, complete=complete)
    priors = get_prior(params, data, cfg64, complete=complete)
    return ParamSet(
        params=unravel(flat.to(dt).clone()),
        post=Posterior(w=post.w.to(dt), iSigma_w=post.iSigma_w.to(dt),
                       logdet=post.logdet.to(dt)),
        priors=priors.to(dt),
        score=score,
    )


def init(
    X,
    Y,
    method: str = "VL",
    m: int = 100,
    *,
    heteroscedastic: bool = True,
    normalize: bool = True,
    omega=None,
    training=None,
    psi=None,
    seed: int = 0,
    dtype: str = "float32",
    solve_dtype: str = "auto",
    solve_mode: str = "auto",
    device=None,
) -> GPzModel:
    """Build and initialize a GPz model (ref GPz/init.m) on `device` (None:
    the CUDA device; without one torch's own error is raised).

    Initialization heuristics match the reference, and the arrays match
    gpz_tpu.init's for the same seed:
      * centers drawn uniform in the PCA-whitened unit cube (init.m:57-59)
      * length scales from the mean-distance heuristic over linearly imputed
        data: gamma = sqrt(0.5 m^(1/d) / mean Dxy(Xl, P)) (init.m:61-62)
      * b = log var(Y), lnAlpha = -log var(Y) (init.m:54-55)
    """
    device = torch.device("cuda" if device is None else device)
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n, d = X.shape
    k = Y.shape[1]
    if d == 1:
        method = method[0] + "L"  # ref init.m:12-14

    cfg = ModelConfig(
        m=m, d=d, k=k, method=method,
        heteroscedastic=heteroscedastic, normalize=normalize, dtype=dtype,
        solve_dtype=solve_dtype, solve_mode=solve_mode,
    )
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)

    muX, sdX, muY = datautils.normalization_stats(X, Y, training, normalize)
    Xn = (X - muX[None, :]) / sdX[None, :]
    Yc = Y - muY[None, :]
    psi_c = datautils.fix_psi(psi, n, sdX, cfg.full_cov)

    rng = np.random.default_rng(seed)
    Xtr = Xn[training]
    Ytr = Yc[training]

    b = np.log(np.var(Ytr, axis=0, ddof=1))                 # (k,)
    ln_alpha = np.broadcast_to(-b[None, :], (m, k)).copy()  # (m, k)

    # PCA-whitened uniform centers (init.m:57-59), host-side NumPy
    mu_p, cov_p, Ti = datautils.pca_whiten_np(Xtr)
    P = (rng.random((m, d)) - 0.5) * math.sqrt(12.0)
    P = P @ Ti + mu_p[None, :]

    # length-scale heuristic on imputed data (init.m:61-62)
    Xl = datautils.fill_linear_np(Xtr, mu_p, cov_p)
    gamma = np.sqrt(0.5 * m ** (1.0 / d) / _mean_sq_dist(Xl, P))  # (m,)

    gshape = cfg.gamma_shape
    if method in ("GL", "GD"):
        g0 = np.full(gshape, gamma.mean())
    elif method == "VL":
        g0 = gamma[:, None]
    elif method == "VD":
        g0 = np.broadcast_to(gamma[:, None], gshape).copy()
    elif method == "GC":
        g0 = np.eye(d)[None, :, :] * gamma.mean()
    else:  # VC
        g0 = np.eye(d)[None, :, :] * gamma[:, None, None]
    g0 = np.ascontiguousarray(np.broadcast_to(g0, gshape))

    dt = getattr(torch, cfg.dtype)
    arrays = {"P": P, "gamma": g0, "ln_alpha": ln_alpha, "b": b}
    if heteroscedastic:
        arrays["v"] = np.zeros((m, k))
        arrays["ln_tau"] = np.zeros((m, k))
    params = GPzParams.from_numpy(arrays, device, dt)

    data = _make_dataset(Xn, Yc, psi_c, omega, training, dt, device)
    post = posterior(params, data, cfg, complete=_complete(data))
    priors = torch.full((m,), 1.0 / m, dtype=dt, device=device)

    last = ParamSet(params=params, post=post, priors=priors)
    best = ParamSet(params=params, post=post, priors=priors, score=-math.inf)
    return GPzModel(cfg=cfg, muX=muX, sdX=sdX, muY=muY, last=last, best=best)


def train(
    model: GPzModel,
    X,
    Y,
    *,
    omega=None,
    training=None,
    validation=None,
    psi=None,
    max_iter: int = 200,
    max_attempts: Optional[int] = None,
    tc: Optional[TrainConfig] = None,
    verbose: bool = True,
) -> GPzModel:
    """Fit hyperparameters by maximizing the log marginal likelihood
    (ref GPz/train.m): L-BFGS with validation early stopping, on the device
    that holds the model's parameters.

    One float64 phase whatever cfg.dtype is: parameters and data are cast
    up, trained, and `last` / `best` are stored back in cfg.dtype with their
    posterior state (computed in float64). Continuation (ref train.m:8-11):
    the run starts from `model.last` and threads both the previous best
    score and the previous best parameters, so a run that never improves
    keeps the old best.
    """
    t_start = time.perf_counter()
    tc = tc or TrainConfig(max_iter=max_iter, max_attempts=max_attempts,
                           verbose=verbose)
    cfg = model.cfg
    device = model.last.params.P.device
    X = np.asarray(X, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    n = X.shape[0]
    if training is None:
        training = np.ones(n, dtype=bool)
    if omega is None:
        omega = np.ones(n)

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, n, model.sdX, cfg.full_cov)

    f64 = torch.float64
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    data_tr = _make_dataset(Xn, Yc, psi_c, omega, training, f64, device)
    complete_tr = _complete(data_tr)
    has_valid = validation is not None and bool(np.any(validation))
    if has_valid:
        data_va = _make_dataset(Xn, Yc, psi_c, omega, validation, f64, device)
        complete_va = _complete(data_va)

    flat0, unravel = model.last.params.astype(f64).flatten()
    x_best0 = model.best.params.astype(f64).flatten()[0]

    fun = _objective(unravel, data_tr, cfg64, complete_tr)

    score_fn = None
    if has_valid:
        def score_fn(flat, aux):
            rmse, ll = holdout_metrics(unravel(flat), aux.w, data_va, cfg64,
                                       complete=complete_va)
            return ll, {
                "valid_rmse": rmse,
                "valid_ll": ll,
                "train_rmse": aux.train_rmse,
                "train_ll": aux.train_ll,
            }

    with _profiled(device):
        res = minimize(
            fun,
            flat0,
            history=tc.history,
            max_iter=tc.max_iter,
            opt_tol=tc.opt_tol,
            prog_tol=tc.prog_tol,
            c1=tc.c1,
            c2=tc.c2,
            max_ls=tc.max_ls,
            score_fn=score_fn,
            max_attempts=tc.max_attempts,
            init_best_score=(model.best.score
                             if math.isfinite(model.best.score) else None),
            x_best0=x_best0,
            iter_callback=_LiveRowPrinter(has_valid) if tc.verbose else None,
        )

    state = (unravel, data_tr, cfg64, complete_tr, cfg.dtype)
    last = _resolve(res.x, res.best_score if not has_valid else -math.inf,
                    *state)
    best = _resolve(res.x_best, res.best_score, *state)

    fit_info = {
        "iterations": res.iterations,
        "fun_evals": res.fun_evals,
        "status": res.status,
        "final_nlml": res.f,
        "seconds": time.perf_counter() - t_start,
        "trace": res.trace,
    }
    if tc.verbose:
        _print_trace(fit_info, has_valid)

    return GPzModel(
        cfg=cfg, muX=model.muX, sdX=model.sdX, muY=model.muY,
        last=last, best=best, fit_info=fit_info,
    )


def _profiled(device: torch.device):
    """With GPZ_PROFILE set to a directory, a torch.profiler trace of the
    block (host and, on a CUDA device, the card's kernels) written there on
    exit, as gpz_tpu writes a jax.profiler trace of its training; with it
    unset, nothing."""
    out = os.environ.get("GPZ_PROFILE")
    if not out:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(out))


def sample_weights(
    model: GPzModel,
    n_samples: int = 20,
    *,
    which_set: str = "best",
    seed: int = 0,
) -> np.ndarray:
    """Draw basis-weight samples from the Gaussian posterior N(w, SIGMA^-1).

    The reference's posterior-sample plot (ref demo_sinc.m:77-87) draws
    ws = w + U sqrt(S) z with [U, S] = svd(iSigma_w), z ~ N(0, I), then
    plots the sampled curves PHI @ ws + muY. This is that draw as an API:
    returns (m, k, n_samples); curves for inputs X are
    `predict(X, model).phi @ draws[:, j, :] + model.muY[j]` per output j.

    Host-side NumPy: one m x m SVD per output, and gpz_tpu's draws for the
    same seed.
    """
    pset = model.best if which_set == "best" else model.last
    w = pset.post.w.detach().cpu().numpy().astype(np.float64)         # (m, k)
    C = pset.post.iSigma_w.detach().cpu().numpy().astype(np.float64)  # (k,m,m)
    rng = np.random.default_rng(seed)
    m = w.shape[0]
    draws = []
    for kk in range(C.shape[0]):
        # svd of the (symmetrized) posterior covariance, like the reference;
        # eigenvalue clipping guards the f32-stored matrix's tiny negatives
        U, S, _ = np.linalg.svd((C[kk] + C[kk].T) / 2.0)
        R = U * np.sqrt(np.maximum(S, 0.0))[None, :]
        draws.append(
            w[:, kk, None] + R @ rng.standard_normal((m, n_samples))
        )
    return np.stack(draws, axis=1)                           # (m, k, S)


def _moments_batch(cfg: ModelConfig, batch_size: int = 2048) -> int:
    """Rows per batch of predict()'s moment-matching pass.

    The pass tiles itself over basis-index blocks against
    predict.PAIR_BUDGET; the row batch keeps eight (n, m, d_cost) tensors
    within it: the diagonal family's pair block at a block size of 8, the
    full family's mixture tensors (X_hat, Psi_hat) of the missing-data path.
    Budgets are calibrated in f32 elements and the chain runs in
    predict.variance_dtype(), so the batch scales down with its width.
    """
    d_cost = cfg.d * cfg.d if cfg.full_cov else cfg.d
    vbytes = torch.finfo(predict_mod.variance_dtype()).bits // 8
    return max(
        16, min(batch_size,
                predict_mod.PAIR_BUDGET * 4 // vbytes // (8 * cfg.m * d_cost))
    )


def predict(
    X,
    model: GPzModel,
    *,
    psi=None,
    which_set: str = "best",
    selection=None,
    batch_size: int = 2048,
) -> Prediction:
    """Predict mean + decomposed uncertainty (ref GPz/predict.m).

    sigma = nu + beta_i + gamma (predict.m:72); mu is un-centered by muY.
    Rows are grouped by missingness pattern host-side (predict.m:45-56) and
    each group runs in row batches on the device that holds the model's
    parameters; clean rows take the O(n m) fast path. NaN in X marks a
    missing value.
    """
    cfg = model.cfg
    X = np.asarray(X, dtype=np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if selection is not None:
        X = X[selection]
        if psi is not None:
            psi = np.asarray(psi)[selection]
    n, d = X.shape
    pset = model.best if which_set == "best" else model.last
    dt = getattr(torch, cfg.dtype)
    device = pset.params.P.device

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                               device=device)

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    psi_c = datautils.fix_psi(psi, n, model.sdX, cfg.full_cov)

    mask = ~np.isnan(Xn)
    Xz = np.where(mask, Xn, 0.0)
    k = cfg.k
    out = {
        "mu": np.zeros((n, k)),
        "nu": np.zeros((n, k)),
        "beta_i": np.zeros((n, k)),
        "gamma": np.zeros((n, k)),
        "phi": np.zeros((n, cfg.m)),
    }

    # the full-covariance missing path truncates its conditioning mixture to
    # the top MIX_TOPL responsibilities per row; a batch whose dropped mass
    # is not negligible (flat responsibilities) is run again with the exact
    # sum, at the price of one host read of `coverage` per guarded batch
    guard_mix = cfg.full_cov and cfg.m > predict_mod.MIX_TOPL

    def run_batch(idx, pat, complete):
        Xg = dev(Xz[idx])
        if complete and psi_c is None:
            mask_g = torch.ones_like(Xg, dtype=torch.bool)
            return predict_mod.predict_clean(
                pset.params, pset.post, cfg, Xg, mask_g, None, complete=True,
            )
        if psi_c is None:
            shape = (len(idx), d, d) if cfg.full_cov else (len(idx), d)
            psig = torch.zeros(shape, dtype=dt, device=device)
        else:
            psig = dev(psi_c[idx])
        margs = (pset.params, pset.post, pset.priors, cfg, Xg, dev(pat),
                 psig, complete)
        if not cfg.full_cov:
            # the diagonal family computes its mixture exactly
            return predict_mod.predict_moments_diag(*margs)
        if guard_mix and not complete:
            *res, coverage = predict_mod.predict_moments_full(
                *margs, mix_topl=None, return_coverage=True)
            if float(coverage) >= predict_mod.MIX_COVERAGE_MIN:
                return res
            return predict_mod.predict_moments_full(*margs, mix_topl=cfg.m)
        return predict_mod.predict_moments_full(*margs)

    moments_batch = _moments_batch(cfg, batch_size)

    # group rows by missingness pattern (ref predict.m:45-56)
    patterns, inverse = np.unique(mask, axis=0, return_inverse=True)
    with torch.no_grad():
        for pi in range(patterns.shape[0]):
            rows = np.where(inverse == pi)[0]
            pat = patterns[pi]
            complete = bool(pat.all())
            bs = batch_size if (complete and psi_c is None) else moments_batch
            for start in range(0, len(rows), bs):
                idx = rows[start : start + bs]
                res = run_batch(idx, pat, complete)
                for key, val in zip(("mu", "nu", "beta_i", "gamma", "phi"),
                                    res):
                    out[key][idx] = val.cpu().numpy()

    # gamma = E[(phi'w)^2] - (E[phi'w])^2 >= 0 mathematically, but the
    # moment-matched difference can come out epsilon-negative; nu likewise
    # via the iSigma_w quadratic form. Clamp at zero so sigma stays a valid
    # variance (sigma = nu+beta_i+gamma, predict.m:72)
    out["gamma"] = np.maximum(out["gamma"], 0.0)
    out["nu"] = np.maximum(out["nu"], 0.0)
    sigma = out["nu"] + out["beta_i"] + out["gamma"]
    mu = out["mu"] + model.muY[None, :]
    return Prediction(
        mu=mu, sigma=sigma, nu=out["nu"], beta_i=out["beta_i"],
        gamma=out["gamma"], phi=out["phi"],
    )
