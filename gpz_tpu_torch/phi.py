"""Design-matrix construction (gpz_tpu.phi), full-covariance family on
complete rows.

  * GC/VC: full covariance, iSigma_j = Gamma_j^T Gamma_j (ref getPHI.m:73)
  * input noise Psi enters as Psi + Sigma in the quadratic form plus a log-det
    correction (Gaussian convolution, getPHI.m:84-87); with psi the pass runs
    through ops.vc_phi.vc_lnphi_complete, the CUDA kernel on the card

Differentiable in P and gamma (the kernel pair carries the gradient through
lnPHI; GC's broadcast gamma sums its gradient over the bases).

Returns log-space quantities; exp happens at the caller:
  lnPHI (n, m)  log basis activations
  lnN   (n, m)  log *normalized* densities
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gpz_tpu_torch.config import ModelConfig, not_ported
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.linalg import safe_cholesky, chol_logdet
from gpz_tpu_torch.ops.vc_phi import vc_lnphi_complete

_LN2PI = math.log(2.0 * math.pi)


def log_phi(
    params: GPzParams,
    cfg: ModelConfig,
    X: torch.Tensor,
    mask: torch.Tensor,
    psi: Optional[torch.Tensor],
    complete: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compute (lnPHI, lnN), each (n, m).

    X:        (n, d) inputs
    mask:     (n, d) True where observed
    psi:      None | (n, d, d) input-noise covariances
    complete: hint that mask is all-True; only complete rows are ported
    """
    if not cfg.full_cov:
        raise not_ported(f"the diagonal family ({cfg.method})")
    if not complete:
        raise not_ported("the design matrix with missing data")
    return _log_phi_full(params, cfg, X, psi)


def _log_phi_full(params, cfg, X, psi):
    G = params.expand_gamma(cfg)             # (m, d, d)
    P = params.P
    d = X.shape[1]
    m = cfg.m
    iSig = G.transpose(-1, -2) @ G           # Gamma^T Gamma (getPHI.m:73)
    L_iSig = safe_cholesky(iSig)
    logdet_Sigma = -chol_logdet(L_iSig)      # (m,)

    if psi is None:
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
    ln_phi = vc_lnphi_complete(X, psi, P.contiguous(), Sigma, logdet_Sigma)
    ln_n = ln_phi - 0.5 * logdet_Sigma[None, :] - 0.5 * d * _LN2PI
    return ln_phi, ln_n


def design_matrix(
    params: GPzParams,
    cfg: ModelConfig,
    X: torch.Tensor,
    mask: torch.Tensor,
    psi: Optional[torch.Tensor],
    complete: bool = False,
):
    """(PHI, lnN, ln_beta_i): activations, log densities, log noise variance.

    ln_beta_i = b + PHI @ v when heteroscedastic (ref getPHI.m:117-125).
    """
    ln_phi, ln_n = log_phi(params, cfg, X, mask, psi, complete)
    PHI = torch.exp(ln_phi)
    ln_beta_i = params.b[None, :].expand(X.shape[0], cfg.k)
    if params.heteroscedastic:
        ln_beta_i = ln_beta_i + PHI @ params.v
    return PHI, ln_n, ln_beta_i
