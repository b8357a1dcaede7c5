"""Design-matrix construction (gpz_tpu.phi): the getPHI equivalent as batched
masked math, for all six methods, with or without input noise and missing
values.

  * GL/VL/GD/VD: diagonal covariance, Sigma_jd = gamma_jd^-2 (ref getPHI.m:93)
  * GC/VC: full covariance, iSigma_j = Gamma_j^T Gamma_j (ref getPHI.m:73)
  * input noise Psi enters as Psi + Sigma in the quadratic form plus a log-det
    correction (Gaussian convolution, getPHI.m:84-87,102-105)
  * missing dims are handled by masked dense algebra: X is zero-filled, the
    pattern lives in a boolean mask, and each unobserved dim contributes
    -0.5*log(2) to lnPHI (marginalization constant, getPHI.m:76)

`complete` is a hint about the whole dataset, decided on the host: for the
full-covariance family complete rows with psi run through
ops.vc_phi.vc_lnphi_complete (the CUDA kernel pair on the card), complete rows
without psi need no inverse at all, and anything else takes the masked pass
over (rows, m, d, d) systems, PHI_BLOCK_ROWS rows at a time, each block
recomputed in the backward so that only (rows, m) results persist. The
diagonal family is mask-native.

Differentiable in P and gamma (GL/GD/GC's broadcast gamma sums its gradient
over the broadcast axes).

Returns log-space quantities; exp happens at the caller:
  lnPHI (n, m)  log basis activations
  lnN   (n, m)  log *normalized* densities
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.linalg import (
    safe_cholesky,
    chol_logdet,
    masked_psd,
    per_set,
    quad_logdet_psd,
)
# PHI_BLOCK_ROWS: the row block of the masked full-covariance pass too; it
# bounds the working set (rows * m * d^2 elements per temporary) whatever n is
from gpz_tpu_torch.ops.vc_phi import PHI_BLOCK_ROWS, vc_lnphi_complete
from gpz_tpu_torch.trace import count, span

_LN2 = math.log(2.0)
_LN2PI = math.log(2.0 * math.pi)


def log_phi(
    params: GPzParams,
    cfg: ModelConfig,
    X: torch.Tensor,
    mask: torch.Tensor,
    psi: Optional[torch.Tensor],
    complete: bool = False,
    alone: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (lnPHI, lnN), each (n, m).

    X:        (n, d) zero-filled inputs
    mask:     (n, d) True where observed
    psi:      None | (n, d) | (n, d, d) input-noise variances
    complete: hint that mask is all-True (the full-covariance family then
              skips the masked restrictions; the diagonal family is
              mask-native)

    B parameter sets, each field with a leading axis B (as `unravel` gives
    them for a (B, p) batch of flat vectors), give (lnPHI, lnN) of (B, n, m):
    the sets' bases are joined into one axis of B * m bases, so the kernel
    pair runs once for all of them, and the full family's iSigma climbs the
    jitter ladder per set. With `alone`, each set's values and gradient have
    the bits of the set alone (the lanes of optim.minimize_batched): the
    pair's backward plans its sums over rows per set, the results are laid
    out set after set, and a path without the pair computes each set by
    itself (linalg.per_set).
    """
    lead = params.P.dim() - 2
    if alone and lead and not (cfg.full_cov and complete and psi is not None):
        return per_set(lambda g, p: _log_phi(g, p, cfg, X, mask, psi,
                                             complete, False),
                       lead, params.gamma, params.P)
    return _log_phi(params.gamma, params.P, cfg, X, mask, psi, complete,
                    alone)


def _log_phi(gamma, P, cfg, X, mask, psi, complete, alone):
    lead = P.shape[:-2]
    G = gamma.expand(*lead, *cfg.gamma_expanded_shape)
    if cfg.full_cov:
        ln_phi, ln_n = _log_phi_full(G, P, X, mask, psi, complete, len(lead),
                                     lead.numel() if alone else 1)
    else:
        ln_phi, ln_n = _log_phi_diag(G.reshape(-1, cfg.d),
                                     P.reshape(-1, cfg.d), X, mask, psi)
    if lead:
        ln_phi, ln_n = (t.reshape(X.shape[0], *lead, cfg.m).movedim(0, -2)
                        for t in (ln_phi, ln_n))
        if alone:
            ln_phi, ln_n = ln_phi.contiguous(), ln_n.contiguous()
    return ln_phi, ln_n


def _log_phi_diag(G, P, X, mask, psi):
    Sigma = G**-2                            # per-dim variances (getPHI.m:93)
    fmask = mask.to(X.dtype)
    n_obs = torch.sum(fmask, dim=1)          # (n,)
    n_mis = X.shape[1] - n_obs

    Delta = X[:, None, :] - P[None, :, :]    # (n, m, d)
    log_sigma_obs = fmask @ torch.log(Sigma).transpose(0, 1)   # (n, m)

    if psi is None:
        quad = torch.einsum("nmd,md,nd->nm", Delta**2, 1.0 / Sigma, fmask)
        ln_phi = -0.5 * quad - 0.5 * n_mis[:, None] * _LN2
    else:
        ps = psi[:, None, :] + Sigma[None, :, :]               # (n, m, d)
        quad = torch.einsum("nmd,nd->nm", Delta**2 / ps, fmask)
        # log(1 + psi/Sigma) correction (getPHI.m:104)
        logr = torch.einsum(
            "nmd,nd->nm", torch.log1p(psi[:, None, :] / Sigma[None, :, :]),
            fmask)
        ln_phi = -0.5 * quad - 0.5 * logr - 0.5 * n_mis[:, None] * _LN2

    ln_n = (
        ln_phi
        - 0.5 * log_sigma_obs
        - 0.5 * n_obs[:, None] * _LN2PI
        + 0.5 * n_mis[:, None] * _LN2
    )
    return ln_phi, ln_n


def _masked_block(Xb, maskb, psib, P, Sigma):
    """The masked pass on one block of rows: (rows, m, d, d) work through
    Sigma_oo and (Psi + Sigma)_oo (ref getPHI.m:76-87)."""
    d = Xb.shape[1]
    fm = maskb.to(Xb.dtype)
    n_obs = torch.sum(fm, dim=1)
    n_mis = d - n_obs
    Delta = (Xb[:, None, :] - P[None, :, :]) * fm[:, None, :]
    Soo = masked_psd(Sigma[None, :, :, :], maskb[:, None, :])
    quad, logdet_Soo = quad_logdet_psd(Soo, Delta)
    if psib is None:
        ln_phi = -0.5 * quad - 0.5 * n_mis[:, None] * _LN2
    else:
        ps = masked_psd(psib[:, None, :, :] + Sigma[None, :, :, :],
                        maskb[:, None, :])
        quad, logdet_ps = quad_logdet_psd(ps, Delta)
        # +0.5 logdet(Sigma_oo) - 0.5 logdet(Psi_oo+Sigma_oo) (getPHI.m:86)
        ln_phi = (
            -0.5 * quad
            + 0.5 * logdet_Soo
            - 0.5 * logdet_ps
            - 0.5 * n_mis[:, None] * _LN2
        )
    ln_n = (
        ln_phi
        - 0.5 * logdet_Soo
        - 0.5 * n_obs[:, None] * _LN2PI
        + 0.5 * n_mis[:, None] * _LN2
    )
    return ln_phi, ln_n


def _log_phi_full(G, P, X, mask, psi, complete, batch_dims=0, sets=1):
    """G (*sets, m, d, d) and P (*sets, m, d), with `batch_dims` leading
    axes of parameter sets whose bases are joined into one axis after the
    factorization of iSigma; the kernel pair's backward plans its sums for
    `sets` equal runs of the joined bases."""
    n, d = X.shape
    count("phi.rows_total", n)
    iSig = G.transpose(-1, -2) @ G           # Gamma^T Gamma (getPHI.m:73)
    L_iSig = safe_cholesky(iSig, batch_dims)
    G, P, L_iSig = G.reshape(-1, d, d), P.reshape(-1, d), L_iSig.reshape(
        -1, d, d)
    m = P.shape[0]
    logdet_Sigma = -chol_logdet(L_iSig)      # (m,)

    if complete and psi is None:
        # quad = |Gamma Delta|^2: no inverse needed
        Delta = X[:, None, :] - P[None, :, :]
        V = torch.einsum("mab,nmb->nma", G, Delta)
        quad = torch.sum(V * V, dim=-1)      # (n, m)
        ln_phi = -0.5 * quad
        ln_n = ln_phi - 0.5 * logdet_Sigma[None, :] - 0.5 * d * _LN2PI
        return ln_phi, ln_n

    # Sigma_j = iSig^-1 via the Cholesky factor (getPHI.m:77,86)
    eye = torch.eye(d, dtype=X.dtype, device=X.device).expand(m, d, d)
    Linv = torch.linalg.solve_triangular(L_iSig, eye, upper=False)
    Sigma = (Linv.transpose(-1, -2) @ Linv).contiguous()

    if complete:
        ln_phi = vc_lnphi_complete(X, psi, P.contiguous(), Sigma,
                                   logdet_Sigma, sets)
        ln_n = ln_phi - 0.5 * logdet_Sigma[None, :] - 0.5 * d * _LN2PI
        return ln_phi, ln_n

    B = PHI_BLOCK_ROWS
    count("phi.rows_masked", n)
    with span("gpz.phi.masked", rows=n, blocks=-(-n // B), d=d):
        if n <= B:
            return _masked_block(X, mask, psi, P, Sigma)
        # each block is recomputed in the backward: autograd keeps a block's
        # inputs and its two (rows, m) results, not its (rows, m, d, d) chain
        outs = [
            checkpoint(_masked_block, X[r0:r0 + B], mask[r0:r0 + B],
                       None if psi is None else psi[r0:r0 + B], P, Sigma,
                       use_reentrant=False)
            for r0 in range(0, n, B)
        ]
        return (torch.cat([o[0] for o in outs]),
                torch.cat([o[1] for o in outs]))


def design_matrix(
    params: GPzParams,
    cfg: ModelConfig,
    X: torch.Tensor,
    mask: torch.Tensor,
    psi: Optional[torch.Tensor],
    complete: bool = False,
    alone: bool = False,
):
    """(PHI, lnN, ln_beta_i): activations, log densities, log noise variance.

    ln_beta_i = b + PHI @ v when heteroscedastic (ref getPHI.m:117-125).
    B parameter sets with a leading axis B give each a leading axis B
    (`log_phi`); with `alone`, each set's results and gradient have the bits
    of the set alone: `log_phi`'s, and PHI @ v and b's broadcast over rows
    set by set.
    """
    ln_phi, ln_n = log_phi(params, cfg, X, mask, psi, complete, alone)
    PHI = torch.exp(ln_phi)

    def noise(PHI, b, v):
        ln_beta_i = b[..., None, :].expand(*PHI.shape[:-1], cfg.k)
        return ln_beta_i if v is None else ln_beta_i + PHI @ v

    return PHI, ln_n, per_set(noise, PHI.dim() - 2 if alone else 0, PHI,
                              params.b, params.v)
