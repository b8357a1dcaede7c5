"""Negative log marginal likelihood, posterior solve, and metrics
(gpz_tpu.objective), as a function whose exact gradient comes from autograd.
The math (ref GPz/GPz.m:43-110):

  beta      = exp(-lnBeta_i)                       noise precisions (n, k)
  SIGMA_k   = PHI^T diag(omega * beta_k) PHI + diag(alpha_k)
  w_k       = SIGMA_k^-1 PHI^T (omega * beta_k * y_k)
  logML     = sum_k [ -1/2 sum_i omega_i beta_ik delta_ik^2
                      -1/2 sum_j alpha_jk w_jk^2 + 1/2 sum_j lnalpha_jk
                      -1/2 logdet SIGMA_k - 1/2 sum_i lnBeta_ik omega_i ]
              (+ heteroscedastic prior terms on v with lnTau, GPz.m:96-108)
              - k/2 log(2 pi) sum_i omega_i
  nlogML    = -logML / (n_eff * k)

NB: the reference's 2pi constant (GPz.m:110) omits the factor k for k > 1;
here, as in gpz_tpu, the mathematically correct k factor is used (identical
for k == 1, and a constant offset otherwise, so optimization is unaffected).

Every sample-indexed reduction is a weighted sum against `omega`, so rows with
omega == 0 contribute exactly nothing.

Precision: the three reductions over samples (Gram, rhs, sum ob*y^2), the
(k, m, m) factorization and solve, and every scalar evidence term run in the
solve dtype. `cfg.solve_dtype == "auto"` means float64 whatever cfg.dtype is;
an explicit "float32" is honoured. The reductions are plain matrix products in
that dtype (the strict branch of gpz_tpu's _gram_reductions): float64 products
are native here, so gpz_tpu's mixed and Ozaki branches, its fast solve and its
phase probe have no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.dataset import Dataset
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.phi import design_matrix
from gpz_tpu_torch.linalg import (
    chol_solve, per_set, safe_cholesky, solve_w_logdet,
)

_LN2PI = math.log(2.0 * math.pi)


@dataclasses.dataclass
class Aux:
    """Per-evaluation aux outputs (the reference's global side channel); B
    parameter sets (nlog_ml_batched) give every field a leading axis B."""

    w: torch.Tensor            # (m, k) posterior mean weights
    train_rmse: torch.Tensor   # scalar
    train_ll: torch.Tensor     # scalar (mean log likelihood)


@dataclasses.dataclass
class Posterior:
    """Posterior state stored per parameter set (ref train.m:53-58)."""

    w: torch.Tensor          # (m, k)
    iSigma_w: torch.Tensor   # (k, m, m) inverse of the Gram SIGMA
    logdet: torch.Tensor     # (k,)


def _identity(x):
    return x


def solve_dtype(cfg: ModelConfig) -> torch.dtype:
    """The dtype of the reduced quantities: float64 for "auto"."""
    name = "float64" if cfg.solve_dtype == "auto" else cfg.solve_dtype
    return getattr(torch, name)


def _gram_reductions(PHI, ob, Y, sdt, r, sets=0):
    """The three n-reductions of the objective (Gram A, rhs, sum ob*y^2) in
    the solve dtype (ref GPz.m:63-75): the sums that a row-sharded run reduces
    across its shards through `r`. PHI (..., n, m) and ob (..., n, k), with
    any leading axes of parameter sets; the first `sets` of them are taken
    set by set (linalg.per_set)."""
    PHIs = PHI.to(sdt)
    W = PHIs[..., None, :] * ob.to(sdt)[..., None]              # (..., n, k, m)

    def gram(W, PHIs):
        # one set's (n, m) operand stays 2-D, so that matmul folds (k, m, n)
        # @ (n, m) into one product (a broadcast batch of one rounds
        # differently)
        right = PHIs if PHIs.dim() == 2 else PHIs[..., None, :, :]
        return W.movedim(-3, -1) @ right                # (..., k, m, m)

    A = r(per_set(gram, sets, W, PHIs))
    rhs = r(per_set(lambda P, oy: P.transpose(-1, -2) @ oy, sets, PHIs,
                    (ob * Y).to(sdt)))                          # (..., m, k)
    obyy = r(per_set(lambda t: torch.sum(t, dim=-2), sets,
                     (ob * Y * Y).to(sdt)))                     # (..., k)
    return A, rhs, obyy


def _gram_terms(params: GPzParams, cfg: ModelConfig, data: Dataset,
                complete: bool, reducer: Callable = _identity,
                batch_dims: int = 0, alone: bool = False):
    """Shared forward computation: PHI, noise, Gram, posterior weights.
    `batch_dims` leading axes of `params` are independent parameter sets
    (`design_matrix`): every result gains them, and each set climbs the
    jitter ladder of SIGMA on its own. With `alone`, every product and sum
    over rows and the factorization of SIGMA run set by set, so each set's
    results have the bits of the set alone."""
    sdt = solve_dtype(cfg)
    sets = batch_dims if alone else 0
    PHI, _, ln_beta = design_matrix(params, cfg, data.X, data.mask, data.psi,
                                    complete, alone)
    beta = torch.exp(-ln_beta)                           # (..., n, k)
    ob = data.omega[:, None] * beta                      # (..., n, k)
    alpha = torch.exp(params.ln_alpha.to(sdt))           # (..., m, k)

    # SIGMA_k = PHI^T diag(ob_k) PHI + diag(alpha_k)   (ref GPz.m:63-65)
    A, rhs, obyy = _gram_reductions(PHI, ob, data.Y, sdt, reducer, sets)
    SIGMA = A + torch.diag_embed(alpha.transpose(-1, -2))   # (..., k, m, m)
    # w (..., m, k), logdet (..., k)
    if alone:
        w, logdet = per_set(solve_w_logdet, batch_dims, SIGMA, rhs)
    else:
        w, logdet = solve_w_logdet(SIGMA, rhs, batch_dims)
    return PHI, ln_beta, beta, ob, alpha, SIGMA, logdet, w, rhs, obyy


def _n_eff(n_eff, data: Dataset, sdt):
    if n_eff is None:
        return torch.tensor(data.n, dtype=sdt, device=data.X.device)
    return torch.as_tensor(n_eff, device=data.X.device).to(sdt)


def _fit_metrics(PHI, w, ln_beta, beta, data, n_eff, k, sdt, r, sets=0):
    """(rmse, mean log likelihood) of the fit PHI w against data.Y (ref
    GPz.m:236-259): PHI (..., n, m) and w (..., m, k) with any leading axes
    of parameter sets, each set's sums over its own rows; the first `sets`
    of them are taken set by set (linalg.per_set). The (..., n, k) residual
    stays in the compute dtype; only the scalar accumulations happen in the
    solve dtype."""
    delta = per_set(torch.matmul, sets, PHI, w.to(PHI.dtype)) - data.Y
    om = data.omega[:, None]

    def total(t):
        return r(per_set(lambda u: torch.sum(u, dim=(-2, -1)), sets,
                         t.to(sdt)))

    rmse = torch.sqrt(total(om * delta**2) / (n_eff * k))
    ll = (total(om * (-0.5 * beta * delta**2 - 0.5 * ln_beta)) / (n_eff * k)
          - 0.5 * _LN2PI)
    return rmse, ll


def _evidence(params, cfg, w, rhs, alpha, obyy, logdet, lnb_omega, sdt):
    """Per-output log evidence (ref GPz.m:81-82, the prior on v :103) from
    the reduced quantities: w, rhs, alpha (..., m, k); obyy, logdet and
    lnb_omega = sum_i omega_i ln_beta_ik (..., k).

    The data-fit quadratic by the exact normal-equations identity: with
    A = SIGMA - diag(alpha) and SIGMA w = rhs,
      sum_i ob (phi_i'w - y_i)^2 = w'Aw - 2 w'rhs + sum_i ob y^2
                                 = sum_i ob y^2 - w'rhs - sum alpha w^2,
    so the whole term is built from the m-sized reductions plus the
    n-scalar obyy. The identity holds for every theta, so autograd through
    this form gives the gradient of the computed function exactly.
    """
    wrhs = torch.sum(w * rhs, dim=-2)
    aw2 = torch.sum(alpha * w**2, dim=-2)
    quad = obyy - wrhs - aw2
    log_ml = (
        -0.5 * quad
        - 0.5 * aw2
        + 0.5 * torch.sum(params.ln_alpha.to(sdt), dim=-2)
        - 0.5 * logdet
        - 0.5 * lnb_omega
    )
    if params.heteroscedastic:
        tau = torch.exp(params.ln_tau.to(sdt))
        log_ml = log_ml + (
            -0.5 * torch.sum(params.v.to(sdt)**2 * tau, dim=-2)
            + 0.5 * torch.sum(params.ln_tau.to(sdt), dim=-2)
            - 0.5 * cfg.m * _LN2PI
        )
    return log_ml


def _neg_log_ml(params, data, cfg, n_eff, complete, r, batch_dims,
                alone=False):
    """(nlml (...), the _gram_terms) of one parameter set, or of a batch of
    them along `batch_dims` leading axes (`alone`: as _gram_terms); `n_eff`
    a tensor or a number."""
    sdt = solve_dtype(cfg)
    k = cfg.k
    terms = _gram_terms(params, cfg, data, complete, r, batch_dims, alone)
    _, ln_beta, _, _, alpha, _, logdet, w, rhs, obyy = terms
    lnb_omega = r(per_set(lambda t: torch.sum(t, dim=-2),
                          batch_dims if alone else 0,
                          (ln_beta * data.omega[:, None]).to(sdt)))
    log_ml = _evidence(params, cfg, w, rhs, alpha, obyy, logdet, lnb_omega,
                       sdt)
    total = torch.sum(log_ml, dim=-1) - 0.5 * _LN2PI * k * r(
        torch.sum(data.omega.to(sdt))
    )
    return -total / (n_eff * k), terms


def nlog_ml(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    n_eff=None,
    complete: bool = False,
    reducer: Callable = _identity,
):
    """Negative mean log marginal likelihood and aux metrics: (nlml, Aux).

    `n_eff`: number of real samples; defaults to data.n.
    `reducer`: applied to every partial sum over samples (identity for one
    process; an all-reduce when the rows are sharded).
    Differentiate by autograd (`nlml.backward()`): the full analytic gradient
    of ref GPz.m:89-234 falls out, through the design-matrix kernel pair.
    """
    return _with_aux(params, data, cfg, n_eff, complete, reducer, 0)


def _with_aux(params, data, cfg, n_eff, complete, reducer, batch_dims):
    """(nlml, Aux) of _neg_log_ml, its sets (if any) each as alone."""
    sdt = solve_dtype(cfg)
    n_eff = _n_eff(n_eff, data, sdt)
    nlml, (PHI, ln_beta, beta, _, _, _, _, w, _, _) = _neg_log_ml(
        params, data, cfg, n_eff, complete, reducer, batch_dims, True)

    # train metrics (ref GPz.m:236-237), explicit instead of globals
    with torch.no_grad():
        train_rmse, train_ll = _fit_metrics(
            PHI, w, ln_beta, beta, data, n_eff, cfg.k, sdt, reducer,
            batch_dims)
    return nlml, Aux(w=w.detach(), train_rmse=train_rmse, train_ll=train_ll)


def nlog_ml_batched(flat: torch.Tensor, unravel: Callable, data: Dataset,
                    cfg: ModelConfig, complete: bool = False, n_eff=None,
                    reducer: Callable = _identity, lanes: bool = False):
    """nlog_ml of B parameter sets at once: flat (B, p), a flat parameter
    vector per row (`GPzParams.flatten`'s layout, read by `unravel`), gives
    the (B,) nlml on the same data, what vmapping gpz_tpu's nlog_ml over
    flat vectors gives. `n_eff` and `reducer` as in nlog_ml: the real row
    count of a padded or row-sharded `data`, and the sum over shards.

    `lanes`: the sets are the lanes of optim.minimize_batched. The result
    is then (nlml, Aux) with a leading B on w, train_rmse and train_ll, the
    whole of what the vmapped nlog_ml returns, and each set's value,
    gradient and Aux have the bits of nlog_ml on that set alone: every
    product and sum over rows and the factorization of SIGMA run set by set
    (linalg.per_set), which costs launches, so a lane of a lockstep L-BFGS
    takes the branches it takes alone. Without it (the samplers) one joint
    pass computes the nlml, equal to the single values to rounding.

    The design matrix joins the B sets' bases into one (n, B * m) call, so
    on complete rows with full psi the kernel pair launches once forward and
    once backward whatever B is. Everything after it is nlog_ml's own path
    with a leading axis B: ln_beta, the three reductions, the (B, k, m, m)
    factorization, whose jitter ladder each set climbs on its own, and the
    evidence terms. The sets share nothing, so autograd's gradient of
    `nlml.sum()` in flat is each row's own gradient. (With `lanes`, the
    pair's backward plans its sums over rows per set; a lane's bits are its
    lone ones given rows of `flat` that start where a lone vector's storage
    would, as minimize_batched lays them out.)
    """
    if lanes:
        return _with_aux(unravel(flat), data, cfg, n_eff, complete, reducer,
                         1)
    return _neg_log_ml(unravel(flat), data, cfg,
                       data.n if n_eff is None else n_eff, complete, reducer,
                       1)[0]


def posterior(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    complete: bool = False,
    reducer: Callable = _identity,
) -> Posterior:
    """Posterior weights + full Gram inverse (the reference's "weights-only"
    nargout trick, GPz.m:84-87, as an explicit function), stored in
    cfg.dtype."""
    with torch.no_grad():
        _, _, _, _, _, SIGMA, logdet, w, _, _ = _gram_terms(
            params, cfg, data, complete, reducer
        )
        m = cfg.m
        eye = torch.eye(m, dtype=SIGMA.dtype, device=SIGMA.device).expand(
            cfg.k, m, m)
        iSigma_w = chol_solve(safe_cholesky(SIGMA), eye)
    dt = getattr(torch, cfg.dtype)
    # row-major storage (the solves return transposed / column-major views)
    return Posterior(w=w.to(dt).contiguous(),
                     iSigma_w=iSigma_w.to(dt).contiguous(),
                     logdet=logdet.to(dt))


def holdout_metrics(
    params: GPzParams,
    w: torch.Tensor,
    data: Dataset,
    cfg: ModelConfig,
    n_eff=None,
    complete: bool = False,
    reducer: Callable = _identity,
):
    """Validation RMSE / mean log likelihood given training weights w: the
    validation block of ref GPz.m:239-259. Returns (rmse, ll). B parameter
    sets (each field of `params` with a leading axis B, w (B, m, k)) give
    (B,) each through one call of the design matrix, each set's bits those
    of the set alone (the scores of minimize_batched's lanes)."""
    sdt = solve_dtype(cfg)
    n_eff = _n_eff(n_eff, data, sdt)
    with torch.no_grad():
        PHI, _, ln_beta = design_matrix(params, cfg, data.X, data.mask,
                                        data.psi, complete, alone=True)
        beta = torch.exp(-ln_beta)
        return _fit_metrics(PHI, w, ln_beta, beta, data, n_eff, cfg.k, sdt,
                            reducer, PHI.dim() - 2)
