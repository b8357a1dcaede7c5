"""Prediction: predictive mean + full uncertainty decomposition
(gpz_tpu.predict).

Each family has one moment-matching implementation: input noise psi == 0 and
an all-True mask reduce it to the clean case, so {noisy, missing,
noisy+missing, clean} are the same code (ref GPz/predictDiag.m:58-296,
GPz/predictCov.m:53-337). `predict_clean` covers the clean case in O(n m)
instead of O(n m^2).

Outputs per sample (ref demo_sinc.m:105-109, predict.m:72):
  mu      point estimate
  nu      model ("density") variance
  beta_i  noise variance                  exp(E ln S) (1 + V ln S / 2)
  gamma   input-noise/missing propagation Var[phi^T w]
  sigma = nu + beta_i + gamma

All rows of one call share a single missingness pattern (a (d,) mask vector):
model.predict groups rows by pattern like ref GPz/predict.m:45-56.

Precision, as in gpz_tpu: the moment-matched second moments are tiny
differences of large sums (nu ~ 1e-6 against sum |terms| ~ 10 on the trained
photo-z model), so the elementwise density chain runs in float64
(`variance_dtype()`) while the contractions against w / v / iSigma_w stay in
the parameters' dtype.

In the full-covariance family every evaluation of the design-matrix function
goes through ops.vc_phi.vc_lnphi_complete, the CUDA kernel on the card: the
expected activations PHI, and the pair pass, where the (B * m) pairs of a
block play the role of bases. With missing values the conditionally imputed
rows X_hat and their covariances Psi_hat are complete in all d dimensions, so
the two mixture sums over components (PHI and the pair pass) are the same
call, on the rows of several components at once.
"""

from __future__ import annotations

import os
import threading
import weakref
from typing import NamedTuple

import torch

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.phi import design_matrix
from gpz_tpu_torch.linalg import masked_psd, quad_logdet_psd, unrolled_inv_psd
from gpz_tpu_torch.ops.vc_phi import vc_lnphi_complete
from gpz_tpu_torch.trace import count


def _v_or_zero(params: GPzParams, cfg: ModelConfig):
    if params.v is not None:
        return params.v
    return params.P.new_zeros((cfg.m, cfg.k))


def _log_priors(priors):
    """log prior with a floor at the dtype's tiny.

    The EM fixed point (ref getPrior.m) collapses most bases to prior ~0 on
    trained models; stored in float32 those are exactly 0 and log gives -inf.
    Callers up-cast first, so the floor is the wide dtype's tiny (log ~ -708
    in float64) and the responsibilities stay defined everywhere."""
    tiny = torch.finfo(priors.dtype).tiny
    return torch.log(torch.clamp(priors, min=tiny))


# The four sizes below are read from the environment when the module is
# imported, under gpz_tpu's names; the defaults are the port's own.

#: element budget of the pair pass (env GPZ_PAIR_BUDGET), calibrated in f32
#: elements: the O(n m^2) moment-matching pass is tiled over blocks of basis
#: index i so that the largest live tensor, (n, B, m, d_cost), stays within
#: it. d_cost is d for the diagonal family and 1 for the full family, whose
#: (n, B, m, d, d) systems exist only inside vc_lnphi_complete (the kernel's
#: registers or shared memory on the card, row blocks of the plain version on
#: the CPU). PERF.md holds the measurement on the H100 that set this value
#: and MISSING_PAIR_BUDGET.
PAIR_BUDGET = int(os.environ.get("GPZ_PAIR_BUDGET", str(10**8)))

#: the same budget for one launch of the full family's mixture sums with
#: missing values (env GPZ_PAIR_BUDGET_MISSING): the (components * n, B * m)
#: output of the rows of several mixture components against the pairs of a
#: block.
MISSING_PAIR_BUDGET = int(
    os.environ.get("GPZ_PAIR_BUDGET_MISSING", str(3 * 10**7)))

#: mixture-truncation width of the full-covariance missing-data path (env
#: GPZ_MIX_TOPL): the responsibilities are a softmax whose mass sits on a
#: handful of bases on trained models, so each row keeps its top-L
#: components, renormalized. L >= m is the exact sum, and model.predict then
#: runs no guard. predict_moments_full reports the minimum per-row top-L mass
#: and model.predict re-runs a batch with the exact sum when it falls below
#: MIX_COVERAGE_MIN (flat responsibilities: untrained models, rows with few
#: observed dims).
MIX_TOPL = int(os.environ.get("GPZ_MIX_TOPL", "64"))

#: minimum per-row top-L responsibility mass (dropped mass <= 1 - this; env
#: GPZ_MIX_COVERAGE_MIN)
MIX_COVERAGE_MIN = float(os.environ.get("GPZ_MIX_COVERAGE_MIN", "0.999999"))


def variance_dtype() -> torch.dtype:
    """dtype of the moment-matching chain: float64 unless
    GPZ_VARIANCE_DTYPE names another (float32), read at each call as
    gpz_tpu reads it."""
    return getattr(torch, os.environ.get("GPZ_VARIANCE_DTYPE", "float64"))


def mix_dtype() -> torch.dtype:
    """dtype of the mixture sums of the full-covariance missing-data path
    (env GPZ_MIX_DTYPE, read at each call). The sums are nonnegative, so
    float32 passes its per-component error through linearly, but at a
    trained model's covariance scales that error is not small: at the
    trained photo-z point (cond(Sigma) ~ 5e7) float32 sums moved mu by
    2.5e-2 on an NVIDIA H100, with no NaN and no gain in time (PERF.md).
    float64 is native on the card and the port's default (gpz_tpu's is
    float32); float32 stays selectable."""
    return getattr(torch, os.environ.get("GPZ_MIX_DTYPE", "float64"))


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


# --------------------------------------------------------------------------
# diagonal family: one unified moment-matching path
# --------------------------------------------------------------------------

def _ln_normal_diag(delta, var, weight):
    """sum over the dims selected by `weight` (d,) of the log density of
    delta under variance var, without the 2 pi constant."""
    return torch.einsum("...d,d->...",
                        -0.5 * delta**2 / var - 0.5 * torch.log(var), weight)


def predict_moments_diag(params, post, priors, cfg: ModelConfig, X,
                         mask_vec, psi, complete: bool):
    """Unified noisy/missing moment-matched prediction, diagonal family.

    Equivalent to ref predictDiag.m predictNoisy (75-125), predictMissing
    (127-209) and predictNoisyMissing (211-296); reduces to predictFull when
    psi == 0 and mask_vec is all-True.

    X:        (n, d) zero-filled rows sharing one missingness pattern
    mask_vec: (d,) observed indicator for the whole group
    psi:      (n, d) input-noise variances (zeros when none)
    complete: True when mask_vec is all-True (skips the GMM conditioning)
    """
    vdt = variance_dtype()                    # density-chain dtype (f64)
    cdt = params.P.dtype                      # contraction dtype
    P = params.P.to(vdt)                      # (m, d)
    G = params.expand_gamma(cfg).to(vdt)
    Sigma = G**-2.0                           # (m, d)
    iS = G**2.0
    w = post.w.to(cdt)                        # (m, k)
    v = _v_or_zero(params, cfg).to(cdt)
    b = params.b.to(vdt)
    X = X.to(vdt)
    psi = psi.to(vdt)
    om = mask_vec.to(vdt)                     # (d,)
    um = 1.0 - om

    # --- responsibilities + expected activations (PHI) ---
    lnNo = _ln_normal_diag(X[:, None, :] - P[None, :, :],
                           psi[:, None, :] + Sigma[None, :, :], om)  # (n, m)
    lnz = 0.5 * torch.sum(torch.log(Sigma), dim=1)          # (m,)

    if complete:
        PHI = torch.exp(lnz[None, :] + lnNo)
        Pio = None
    else:
        logits = lnNo + _log_priors(priors.to(vdt))[None, :]
        Pio = torch.softmax(logits, dim=1)                  # (n, m)
        # Nij over unobserved dims (predictDiag.m:160)
        lnNij_u = _ln_normal_diag(P[:, None, :] - P[None, :, :],
                                  Sigma[:, None, :] + Sigma[None, :, :], um)
        # nonnegative contraction: no cancellation, so the cdt product keeps
        # full relative accuracy on the vdt-accurate factors
        PHI = torch.exp(lnz)[None, :] * torch.exp(lnNo) * (
            Pio.to(cdt) @ torch.exp(lnNij_u).to(cdt)
        ).to(vdt)

    PHI_c = PHI.to(cdt)
    mu = (PHI_c @ w).to(vdt)                                # (n, k)
    ElnS = (PHI_c @ v).to(vdt)

    # --- pairwise moment matching (predictDiag.m:93-121), tiled over blocks
    # of the first basis index i: the peak intermediate is (n, B, m, d) ---
    n, d = X.shape
    m = cfg.m
    B = _block_size(n, m, d, itemsize=torch.finfo(vdt).bits // 8)
    nb = -(-m // B)
    pad = nb * B - m
    # i-side arrays padded so partial blocks contribute exactly zero: padded
    # w / v / iSigma_w rows are zero; padded Sigma / iS are 1 and P / lnz are
    # 0 so every padded pair density stays finite
    fpad = torch.nn.functional.pad
    P_i = fpad(P, (0, 0, 0, pad))
    iS_i = fpad(iS, (0, 0, 0, pad), value=1.0)
    Sig_i = fpad(Sigma, (0, 0, 0, pad), value=1.0)
    lnz_i = fpad(lnz, (0, pad))
    w_i = fpad(w, (0, 0, 0, pad))
    v_i = fpad(v, (0, 0, 0, pad))
    iSW_i = fpad(post.iSigma_w.to(cdt), (0, 0, 0, pad))
    Pio_l = None if complete else fpad(Pio, (0, pad))
    one = X.new_ones(d)

    def pair_block(i0):
        sl = slice(i0, i0 + B)
        Pb, iSb, Sb, lzb, wb, vb = (
            P_i[sl], iS_i[sl], Sig_i[sl], lnz_i[sl], w_i[sl], v_i[sl])
        iSWb = iSW_i[:, sl]                                    # (k, B, m)
        Cij = 1.0 / (iSb[:, None, :] + iS[None, :, :])         # (B, m, d)
        cij = (Pb[:, None, :] * iSb[:, None, :]
               + P[None, :, :] * iS[None, :, :]) * Cij
        lnZij = lzb[:, None] + lnz[None, :] + _ln_normal_diag(
            Pb[:, None, :] - P[None, :, :],
            Sb[:, None, :] + Sigma[None, :, :], one)           # (B, m)
        Ec = torch.exp(_ln_normal_diag(
            X[:, None, None, :] - cij[None],
            Cij[None] + psi[:, None, None, :], om))            # (n, B, m)
        if not complete:
            # GMM expectation over unobserved dims (predictDiag.m:181-186),
            # chunked over mixture components l with the same block size so
            # the n-independent (l, B, m, d) table is bounded too
            def l_block(l0):
                ll = slice(l0, l0 + B)
                lnNu = _ln_normal_diag(
                    P_i[ll][:, None, None, :] - cij[None],
                    Sig_i[ll][:, None, None, :] + Cij[None], um)
                # nonnegative mixture sum: the cdt contraction is safe
                return (torch.einsum("nl,lij->nij", Pio_l[:, ll].to(cdt),
                                     torch.exp(lnNu).to(cdt)),)
            (mix,) = _blocked_sum(l_block, nb, B)
            Ec = Ec * mix.to(vdt)
        return _contract_pairs(torch.exp(lnZij)[None] * Ec, wb, vb, iSWb,
                               w, v, cdt, vdt)

    g_sum, V_sum, nu = _blocked_sum(pair_block, nb, B)
    return _assemble(mu, ElnS, g_sum, V_sum, nu, b, PHI)


def _contract_pairs(ZN, wb, vb, iSWb, w, v, cdt, vdt):
    """The three contractions of a block's (n, B, m) pair expectations, in
    cdt: the pair densities are vdt-accurate, so the cdt products only add
    ~eps(cdt) * sum|terms|."""
    ZN = ZN.to(cdt)
    g_c = torch.einsum("nij,ik,jk->nk", ZN, wb, w)
    V_c = torch.einsum("nij,ik,jk->nk", ZN, vb, v)
    nu_c = torch.einsum("nij,kij->nk", ZN, iSWb)
    return g_c.to(vdt), V_c.to(vdt), nu_c.to(vdt)


def _assemble(mu, ElnS, g_sum, V_sum, nu, b, PHI):
    gamma = g_sum - mu**2
    VlnS = V_sum - ElnS**2
    beta_i = torch.exp(ElnS + b[None, :]) * (1.0 + 0.5 * VlnS)
    return mu, nu, beta_i, gamma, PHI


# --------------------------------------------------------------------------
# full-covariance family
# --------------------------------------------------------------------------

def _mixture_chunk(L: int, n: int, bases: int, itemsize: int) -> int:
    """Components per vc_lnphi_complete call of a mixture sum over L
    components of n rows against `bases` bases: as many as keep the call's
    (components * n, bases) output within MISSING_PAIR_BUDGET."""
    budget = MISSING_PAIR_BUDGET * 4 // itemsize
    return max(1, min(L, budget // max(1, n * bases)))


def _mixture_sum(Xh, Ph, pio, Pb, Sb):
    """sum_l pio[l] N(Xh[l]; Pb, Sb + Ph[l]) without the 2 pi constant, (n,
    bases): Xh (L, n, d), Ph (L, n, d, d), pio (L, n) against bases Pb
    (bases, d), Sb (bases, d, d).

    One vc_lnphi_complete call takes the rows of as many components as
    MISSING_PAIR_BUDGET allows; the chunks are summed in component order, so
    one component per call adds the components one by one, as gpz_tpu's scan
    does.
    """
    L, n, d = Xh.shape
    bases = Pb.shape[0]
    Lc = _mixture_chunk(L, n, bases, torch.finfo(Xh.dtype).bits // 8)
    zeros = Xh.new_zeros(bases)
    acc = None
    for l0 in range(0, L, Lc):
        c = min(L, l0 + Lc) - l0
        ln = vc_lnphi_complete(Xh[l0:l0 + c].reshape(c * n, d),
                               Ph[l0:l0 + c].reshape(c * n, d, d),
                               Pb, Sb, zeros)
        term = torch.sum(torch.exp(ln).reshape(c, n, bases)
                         * pio[l0:l0 + c, :, None], dim=0)
        acc = term if acc is None else acc + term
    return acc


class _Tables:
    """What predict_moments_full computes from one parameter set alone, in
    one pair of chain dtypes (variance, mixture), kept with the set and
    found again by every later call: the basis tables, the pair tables of
    one block size, and the tables of each band pattern served. Each is
    built by the ops, on the shapes, that a call rebuilding it would run,
    so a call gives the same bits either way. They carry no autograd
    history.

    `inputs` are weak references to what the tables are built from (P,
    gamma, v, b, w, iSigma_w) and `versions` their version counters:
    another tensor, an in-place edit or other chain dtypes make new
    tables."""

    def __init__(self, inputs, versions, dtypes):
        self.inputs, self.versions, self.dtypes = inputs, versions, dtypes
        self.pairs = (None,)       # (B, _pair_tables(self, B, ...))
        self.patterns = {}         # pattern tuple -> _pattern_tables(...)

    def current(self, inputs, versions, dtypes) -> bool:
        return (self.dtypes == dtypes and self.versions == versions
                and all(t is (None if r is None else r())
                        for r, t in zip(self.inputs, inputs)))


#: band patterns whose tables one parameter set keeps; a new one past this
#: drops the oldest's
PATTERN_TABLES_MAX = 64

#: id(params) -> the _Tables of that GPzParams; the entry goes when the
#: params are freed. _LOCK serialises finding and building them.
_TABLES: dict = {}
_LOCK = threading.Lock()


def _build_basis(tab, params, post, cfg, vdt, mdt):
    """The basis tables: the responsibilities', the expected activations'
    and the contractions' model-only inputs."""
    cdt = params.P.dtype                      # contraction dtype
    tab.P = params.P.to(vdt)
    G = params.expand_gamma(cfg).to(vdt)      # (m, d, d)
    tab.iSig = torch.einsum("mij,mik->mjk", G, G)  # (m, d, d)
    tab.Sigma, logdet_iSig = unrolled_inv_psd(tab.iSig)
    tab.lnz = -0.5 * logdet_iSig              # = +0.5 logdet Sigma, (m,)
    tab.lnz2 = 2.0 * tab.lnz                  # the complete PHI's logdet
    tab.z = torch.exp(tab.lnz)                # the mixture PHI's scale
    tab.P_mix, tab.Sigma_mix = tab.P.to(mdt), tab.Sigma.to(mdt)
    tab.w = post.w.to(cdt)
    tab.v = _v_or_zero(params, cfg).to(cdt)
    tab.b = params.b.to(vdt)
    tab.iSW = post.iSigma_w.to(cdt)


class _PairBlock(NamedTuple):
    """One i-block's pair tables (predictCov.m:101-113,180-218): the pairs
    (i, j), i in the block, as bases (c_ij, C_ij; in the mixture dtype
    too), their weights exp(lnZ_ij), and the block's rows of w, v and
    iSigma_w."""

    cij: torch.Tensor          # (B * m, d)
    Cij: torch.Tensor          # (B * m, d, d)
    cij_mix: torch.Tensor
    Cij_mix: torch.Tensor
    Z: torch.Tensor            # (B, m)
    w: torch.Tensor            # (B, k)
    v: torch.Tensor            # (B, k)
    iSW: torch.Tensor          # (k, B, m)


def _pair_tables(tab, B, mdt):
    """(a _PairBlock per block of B basis indices i, the zero logdets of a
    block's pairs). Padded i-side rows contribute exactly zero: w / v /
    iSigma_w rows are zero, and identity covariances keep every padded
    density finite."""
    P, iSig, Sigma, lnz = tab.P, tab.iSig, tab.Sigma, tab.lnz
    m, d = P.shape
    nb = -(-m // B)
    pad = nb * B - m
    fpad = torch.nn.functional.pad
    eye_pad = torch.eye(d, dtype=P.dtype, device=P.device).expand(pad, d, d)
    PiS = torch.einsum("mi,mij->mj", P, iSig)  # (m, d)
    P_i = fpad(P, (0, 0, 0, pad))
    PiS_i = fpad(PiS, (0, 0, 0, pad))
    iSig_i = torch.cat([iSig, eye_pad])
    Sig_i = torch.cat([Sigma, eye_pad])
    lnz_i = fpad(lnz, (0, pad))
    w_i = fpad(tab.w, (0, 0, 0, pad))
    v_i = fpad(tab.v, (0, 0, 0, pad))
    iSW_i = fpad(tab.iSW, (0, 0, 0, pad))
    blocks = []
    for i0 in range(0, nb * B, B):
        sl = slice(i0, i0 + B)
        Cij, _ = unrolled_inv_psd(iSig_i[sl][:, None] + iSig[None])
        cij = torch.einsum("bma,bmac->bmc", PiS_i[sl][:, None, :] + PiS[None],
                           Cij)                                # (B, m, d)
        quad_p, ld_p = quad_logdet_psd(Sig_i[sl][:, None] + Sigma[None],
                                       P_i[sl][:, None, :] - P[None, :, :])
        lnZij = lnz_i[sl][:, None] + lnz[None, :] - 0.5 * quad_p - 0.5 * ld_p
        cij = cij.reshape(B * m, d).contiguous()
        Cij = Cij.reshape(B * m, d, d)
        blocks.append(_PairBlock(
            cij, Cij, cij.to(mdt), Cij.to(mdt), torch.exp(lnZij),
            w_i[sl], v_i[sl], iSW_i[:, sl]))
    return blocks, P.new_zeros(B * m)


def _pattern_tables(tab, pattern):
    """A band pattern's tables: the observed indicator on the device (as
    bool and in the chain dtype) and the conditional imputation per basis
    (predictCov.m:169-174), in PRECISION form: the covariance form
    cond_cov = Sigma - J Sigma is a catastrophic cancellation at trained
    models' covariance scales (indefinite cond_cov, NaN logdets
    downstream). Instead
        cond_cov = inv(iSig_uu)  (embedded on the unobserved block)
        J = M - cond_cov iSig M  (so J_oo = I,
                                  J_uo = -inv(iSig_uu) iSig_uo
                                       = Sigma_uo Sigma_oo^-1)
    the same math without subtracting large equals, PSD by construction."""
    m, d = tab.P.shape
    obs = torch.tensor(pattern, dtype=torch.bool, device=tab.P.device)
    om = obs.to(tab.P.dtype)
    um = 1.0 - om
    Binv, _ = unrolled_inv_psd(masked_psd(tab.iSig, (~obs).expand(m, d)))
    cond_cov = Binv * (um[None, :, None] * um[None, None, :])
    J = torch.diag(om)[None] - (
        torch.einsum("mij,mjk->mik", cond_cov, tab.iSig) * om[None, None, :])
    return obs, om, cond_cov, J


def _model_tables(params, post, cfg, vdt, mdt, B, pattern):
    """(the parameter set's _Tables, its _pair_tables of block size B, the
    _pattern_tables of `pattern` or None if it is None): found, or built
    and kept. Counts predict.tables_built once per group built (basis,
    pairs, a pattern), or predict.tables_reused once if everything was
    found."""
    inputs = (params.P, params.gamma, params.v, params.b, post.w,
              post.iSigma_w)
    versions = tuple(None if t is None else t._version for t in inputs)
    dtypes = (vdt, mdt)
    key = id(params)
    tab = _TABLES.get(key)
    built = 0
    with _LOCK, torch.no_grad():
        if tab is None or not tab.current(inputs, versions, dtypes):
            if tab is None:
                weakref.finalize(params, _TABLES.pop, key, None)
            tab = _TABLES[key] = _Tables(
                tuple(None if t is None else weakref.ref(t) for t in inputs),
                versions, dtypes)
            _build_basis(tab, params, post, cfg, vdt, mdt)
            built += 1
        if tab.pairs[0] != B:
            tab.pairs = (B, *_pair_tables(tab, B, mdt))
            built += 1
        pairs = tab.pairs[1:]
        pat = None
        if pattern is not None:
            pat = tab.patterns.get(pattern)
            if pat is None:
                if len(tab.patterns) >= PATTERN_TABLES_MAX:
                    del tab.patterns[next(iter(tab.patterns))]
                pat = tab.patterns[pattern] = _pattern_tables(tab, pattern)
                built += 1
    if built:
        count("predict.tables_built", built)
    else:
        count("predict.tables_reused")
    return tab, pairs, pat


def predict_moments_full(params, post, priors, cfg: ModelConfig, X,
                         mask_vec, psi, complete: bool,
                         mix_topl: int = None, return_coverage: bool = False):
    """Unified moment-matched prediction, full-covariance family (GC/VC).

    Equivalent to ref predictCov.m predictNoisy (70-133), predictMissing
    (134-232) and predictNoisyMissing (233-337). The conditional-imputation
    objects of the missing paths (R, X_hat, Psi_hat; predictCov.m:159-175,
    268-277) are built with masked dense algebra:
        J_i     = Sigma_i A_i^-1 M          (the unshuffled [I; R'] map)
        X_hat_i = P_i + J_i (x - P_i)
        Psi_hat_i = J_i Psi J_i^T + Sigma_i - J_i Sigma_i
    which reduce to X_hat = x, Psi_hat = Psi when nothing is missing.

    What depends on the model alone (Sigma, lnz, the pair tables C_ij, c_ij,
    lnZ_ij, and per band pattern the conditional maps J and covariances) is
    built once per parameter set and reused by every later call (_Tables);
    each call computes only what depends on its rows.

    X (n, d) zero-filled; mask_vec (d,) observed indicator of the group, on
    the host or the device: its values key the pattern's tables, so a host
    tensor (model.predict passes one) costs no device read; psi (n, d, d)
    (zeros when none); priors (m,) enter only with missing values.
    mix_topl: mixture-truncation width (None: the module's MIX_TOPL).
    return_coverage: append the minimum per-row top-L responsibility mass (1
    when no truncation applies), a 0-d tensor, so model.predict can detect flat
    responsibilities and escalate to the exact sum (see MIX_COVERAGE_MIN).
    """
    n, d = X.shape
    m = cfg.m
    vdt = variance_dtype()                    # density-chain dtype (f64)
    mdt = mix_dtype()
    cdt = params.P.dtype                      # contraction dtype
    X = X.to(vdt)
    psi = psi.to(vdt)
    # the pairwise pass (predictCov.m:101-113,180-218) is tiled over blocks
    # of basis index i; the peak live block is (n, B, m), or with missing
    # values the (components * n, B * m) output of one mixture launch
    B = _block_size(n, m, 1, 0 if complete else MISSING_PAIR_BUDGET,
                    itemsize=torch.finfo(vdt).bits // 8)
    pattern = None if complete else tuple(mask_vec.to(torch.bool).tolist())
    tab, (blocks, zeros_pairs), pat = _model_tables(params, post, cfg, vdt,
                                                    mdt, B, pattern)
    P, Sigma, w, v = tab.P, tab.Sigma, tab.w, tab.v
    coverage = X.new_ones(())

    if complete:
        # expected activations: exp(lnz) N(x; P, Sigma + Psi)
        # (predictCov.m:167)
        PHI = torch.exp(vc_lnphi_complete(X, psi, P, Sigma, tab.lnz2))
        mix = None
    else:
        obs, om, cond_cov, J = pat
        Delta = X[:, None, :] - P[None, :, :]  # (n, m, d)
        # responsibilities: N(x_o; P_o, (Sigma + Psi)_oo) (predictCov.m:167,
        # 266); the masked embedding's identity block adds zero to the logdet
        SPoo = masked_psd(Sigma[None] + psi[:, None], obs[None, None, :])
        quad_No, ld_No = quad_logdet_psd(SPoo, Delta * om[None, None, :])
        logits = (-0.5 * quad_No - 0.5 * ld_No
                  + _log_priors(priors.to(vdt))[None, :])
        Pio = torch.softmax(logits, dim=1)                     # (n, m)

        # conditional imputation per basis (the pattern's J and cond_cov)
        X_hat = P[None, :, :] + torch.einsum("mij,nmj->nmi", J, Delta)
        Psi_hat = (torch.einsum("mij,njk,mlk->nmil", J, psi, J)
                   + cond_cov[None])                           # (n, m, d, d)

        # mixture truncation (see MIX_TOPL): keep each row's top-L
        # responsibilities, renormalized so the conditional mixture still
        # integrates to 1; L >= m is the exact full sum. Where
        # responsibilities tie at the L-th place, torch.topk and
        # jax.lax.top_k may keep different components; the sums then agree
        # only as far as the tied components' terms do.
        L = min(m, MIX_TOPL if mix_topl is None else int(mix_topl))
        if L < m:
            pio_t, idx = torch.topk(Pio, L, dim=1)             # (n, L)
            coverage = torch.min(torch.sum(pio_t, dim=1))
            pio_t = pio_t / torch.sum(pio_t, dim=1, keepdim=True)
            X_hat = torch.gather(
                X_hat, 1, idx[:, :, None].expand(n, L, d))
            Psi_hat = torch.gather(
                Psi_hat, 1, idx[:, :, None, None].expand(n, L, d, d))
        else:
            pio_t = Pio
        # component-major and contiguous, as the kernel's wrapper wants rows
        mix = (X_hat.transpose(0, 1).to(mdt).contiguous(),     # (L, n, d)
               Psi_hat.transpose(0, 1).to(mdt).contiguous(),   # (L, n, d, d)
               pio_t.transpose(0, 1).to(mdt).contiguous())     # (L, n)

        # PHI_i = exp(lnz_i) sum_j Pio_j N(X_hat_j; P_i, Sigma_i + Psi_hat_j)
        phi_sum = _mixture_sum(*mix, tab.P_mix, tab.Sigma_mix)
        PHI = tab.z[None, :] * phi_sum.to(vdt)

    PHI_c = PHI.to(cdt)
    mu = (PHI_c @ w).to(vdt)
    ElnS = (PHI_c @ v).to(vdt)

    def pair_block(i0):
        blk = blocks[i0 // B]
        if complete:
            # Ec = N(x; c_ij, C_ij + Psi): the pairs of the block as bases
            Ec = torch.exp(vc_lnphi_complete(X, psi, blk.cij, blk.Cij,
                                             zeros_pairs))
        else:
            # mixture sum over l (predictCov.m:197-202,301-306); the
            # cancellation-sensitive pair table lnZij stays in vdt
            Ec = _mixture_sum(*mix, blk.cij_mix, blk.Cij_mix).to(vdt)
        return _contract_pairs(blk.Z[None] * Ec.reshape(n, B, m),
                               blk.w, blk.v, blk.iSW, w, v, cdt, vdt)

    g_sum, V_sum, nu = _blocked_sum(pair_block, len(blocks), B)
    out = _assemble(mu, ElnS, g_sum, V_sum, nu, tab.b, PHI)
    return (*out, coverage) if return_coverage else out
