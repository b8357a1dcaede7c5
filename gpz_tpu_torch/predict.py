"""Prediction: predictive mean + full uncertainty decomposition
(gpz_tpu.predict), full-covariance family on complete rows.

Outputs per sample (ref demo_sinc.m:105-109, predict.m:72):
  mu      point estimate
  nu      model ("density") variance
  beta_i  noise variance                  exp(E ln S) (1 + V ln S / 2)
  gamma   input-noise propagation         Var[phi^T w]
  sigma = nu + beta_i + gamma

Precision, as in gpz_tpu: the moment-matched second moments are tiny
differences of large sums (nu ~ 1e-6 against sum |terms| ~ 10 on the trained
photo-z model), so the elementwise density chain runs in float64
(`VARIANCE_DTYPE`) while the contractions against w / v / iSigma_w stay in
the parameters' dtype.

Both evaluations of the design-matrix function go through
ops.vc_phi.vc_lnphi_complete, the CUDA kernel on the card: the expected
activations PHI, and the pair pass, where the (B * m) pairs of a block play
the role of bases.
"""

from __future__ import annotations

import torch

from gpz_tpu_torch.config import ModelConfig, not_ported
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.phi import design_matrix
from gpz_tpu_torch.linalg import quad_logdet_psd, unrolled_inv_psd
from gpz_tpu_torch.ops.vc_phi import vc_lnphi_complete


def _v_or_zero(params: GPzParams, cfg: ModelConfig):
    if params.v is not None:
        return params.v
    return params.P.new_zeros((cfg.m, cfg.k))


#: element budget for the pair-pass intermediates, calibrated in f32
#: elements: the O(n m^2) moment-matching pass is tiled over blocks of basis
#: index i with B ~= budget / (n m d_cost). gpz_tpu's default, so the blocks
#: match; re-deriving it for the H100 is later work.
PAIR_BUDGET = 3 * 10**7

#: dtype of the moment-matching chain (gpz_tpu's variance_dtype() default)
VARIANCE_DTYPE = torch.float64


def _block_size(n: int, m: int, d_cost: int, budget: int = 0,
                itemsize: int = 4) -> int:
    # budgets are calibrated in f32 elements; scale down for wider dtypes
    # so the peak live BYTES stay constant
    budget = (budget or PAIR_BUDGET) * 4 // itemsize
    return max(1, min(m, budget // max(1, n * m * d_cost)))


def _blocked_sum(body, nb: int, B: int):
    """sum over i-blocks of body(i0) (a tuple of tensors), in block order."""
    acc = body(0)
    for i0 in range(B, nb * B, B):
        acc = tuple(a + o for a, o in zip(acc, body(i0)))
    return acc


def predict_clean(params, post, cfg: ModelConfig, X, mask, psi=None,
                  complete=True):
    """Fast path — ref predictFull (predictDiag.m:58-74).

    Returns (mu, nu, beta_i, gamma, PHI).
    """
    PHI, _, ln_beta = design_matrix(params, cfg, X, mask, psi, complete)
    mu = PHI @ post.w
    # nu_k = diag(PHI iSigma_w_k PHI^T)
    nu = torch.einsum("nm,kmj,nj->nk", PHI, post.iSigma_w, PHI)
    beta_i = torch.exp(ln_beta)
    gamma = torch.zeros_like(mu)
    return mu, nu, beta_i, gamma, PHI


def predict_moments_full(params, post, priors, cfg: ModelConfig, X,
                         mask_vec, psi, complete: bool):
    """Moment-matched prediction, full-covariance family (GC/VC), on
    complete rows: ref predictCov.m predictNoisy (70-133).

    X (n, d); psi (n, d, d) (zeros when none); priors (m,) enter only the
    missing-data paths, which are not ported yet.
    """
    if not complete:
        raise not_ported("prediction with missing data")
    n, d = X.shape
    m, k = cfg.m, cfg.k
    vdt = VARIANCE_DTYPE                      # density-chain dtype (f64)
    cdt = params.P.dtype                      # contraction dtype
    P = params.P.to(vdt)
    G = params.expand_gamma(cfg).to(vdt)      # (m, d, d)
    w = post.w.to(cdt)
    v = _v_or_zero(params, cfg).to(cdt)
    b = params.b.to(vdt)
    X = X.to(vdt)
    psi = psi.to(vdt)

    iSig = torch.einsum("mij,mik->mjk", G, G)  # (m, d, d)
    Sigma, logdet_iSig = unrolled_inv_psd(iSig)
    lnz = -0.5 * logdet_iSig                  # = +0.5 logdet Sigma, (m,)

    # expected activations: exp(lnz) N(x; P, Sigma + Psi) (predictCov.m:167)
    PHI = torch.exp(vc_lnphi_complete(X, psi, P, Sigma, 2.0 * lnz))

    PHI_c = PHI.to(cdt)
    mu = (PHI_c @ w).to(vdt)
    ElnS = (PHI_c @ v).to(vdt)

    # --- pairwise pass (predictCov.m:101-113), tiled over blocks of basis
    # index i; the peak live block is (n, B, m) ---
    PiS = torch.einsum("mi,mij->mj", P, iSig)  # (m, d)
    B = _block_size(n, m, d * d, itemsize=torch.finfo(vdt).bits // 8)
    nb = -(-m // B)
    pad = nb * B - m
    # padded i-side rows contribute exactly zero: w / v / iSigma_w rows are
    # zero, and identity covariances keep every padded density finite
    eye_pad = torch.eye(d, dtype=vdt, device=X.device).expand(pad, d, d)
    P_i = torch.nn.functional.pad(P, (0, 0, 0, pad))
    PiS_i = torch.nn.functional.pad(PiS, (0, 0, 0, pad))
    iSig_i = torch.cat([iSig, eye_pad])
    Sig_i = torch.cat([Sigma, eye_pad])
    lnz_i = torch.nn.functional.pad(lnz, (0, pad))
    w_i = torch.nn.functional.pad(w, (0, 0, 0, pad))
    v_i = torch.nn.functional.pad(v, (0, 0, 0, pad))
    iSW_i = torch.nn.functional.pad(post.iSigma_w.to(cdt), (0, 0, 0, pad))
    zeros_pairs = X.new_zeros(B * m)

    def pair_block(i0):
        sl = slice(i0, i0 + B)
        Pb, PiSb, iSigb, Sigb, lzb, wb, vb = (
            P_i[sl], PiS_i[sl], iSig_i[sl], Sig_i[sl], lnz_i[sl],
            w_i[sl], v_i[sl],
        )
        iSWb = iSW_i[:, sl]                                    # (k, B, m)
        Cij, _ = unrolled_inv_psd(iSigb[:, None] + iSig[None])  # (B, m, d, d)
        cij = torch.einsum("bma,bmac->bmc", PiSb[:, None, :] + PiS[None],
                           Cij)                                # (B, m, d)
        quad_p, ld_p = quad_logdet_psd(Sigb[:, None] + Sigma[None],
                                       Pb[:, None, :] - P[None, :, :])
        lnZij = lzb[:, None] + lnz[None, :] - 0.5 * quad_p - 0.5 * ld_p

        # Ec = N(x; c_ij, C_ij + Psi): the pairs of the block as bases
        Ec = torch.exp(vc_lnphi_complete(
            X, psi, cij.reshape(B * m, d).contiguous(),
            Cij.reshape(B * m, d, d), zeros_pairs,
        )).reshape(n, B, m)

        ZN = (torch.exp(lnZij)[None] * Ec).to(cdt)            # (n, B, m)
        g_c = torch.einsum("nij,ik,jk->nk", ZN, wb, w)
        V_c = torch.einsum("nij,ik,jk->nk", ZN, vb, v)
        nu_c = torch.einsum("nij,kij->nk", ZN, iSWb)
        return g_c.to(vdt), V_c.to(vdt), nu_c.to(vdt)

    g_sum, V_sum, nu = _blocked_sum(pair_block, nb, B)
    gamma = g_sum - mu**2
    VlnS = V_sum - ElnS**2

    ElnS_b = ElnS + b[None, :]
    beta_i = torch.exp(ElnS_b) * (1.0 + 0.5 * VlnS)
    return mu, nu, beta_i, gamma, PHI
