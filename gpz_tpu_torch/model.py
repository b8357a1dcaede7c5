"""Model containers and the predict entry point (gpz_tpu.model): a model is
normalization stats plus two parameter sets, `last` and `best`, each with
its derived posterior state (ref init.m:106-120, train.m:53-80).

Training (init / train) comes with the next slice; a model comes from
checkpoint.load_model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from gpz_tpu_torch.config import ModelConfig, not_ported
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.objective import Posterior
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
    parameters; clean rows take the O(n m) fast path. Only complete rows of
    the full-covariance family are ported: anything else raises
    NotImplementedError.
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

    def run_batch(idx, pat, complete):
        Xg = dev(Xz[idx])
        if complete and psi_c is None:
            mask_g = torch.ones_like(Xg, dtype=torch.bool)
            return predict_mod.predict_clean(
                pset.params, pset.post, cfg, Xg, mask_g, None, complete=True,
            )
        if not cfg.full_cov:
            raise not_ported(
                f"prediction for the diagonal family ({cfg.method})")
        if psi_c is None:
            psig = torch.zeros((len(idx), d, d), dtype=dt, device=device)
        else:
            psig = dev(psi_c[idx])
        return predict_mod.predict_moments_full(
            pset.params, pset.post, pset.priors, cfg, Xg, dev(pat), psig,
            complete,
        )

    # the moment-matching pass tiles itself over basis-index blocks against
    # predict.PAIR_BUDGET; the row batch leaves room for a block size of ~8.
    # Budgets are calibrated in f32 elements and the chain runs in
    # predict.VARIANCE_DTYPE, so the batch scales down with its width
    d_cost = d * d if cfg.full_cov else d
    vbytes = torch.finfo(predict_mod.VARIANCE_DTYPE).bits // 8
    moments_batch = max(
        16, min(batch_size,
                predict_mod.PAIR_BUDGET * 4 // vbytes // (8 * cfg.m * d_cost))
    )

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
