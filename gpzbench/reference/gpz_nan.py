"""A plain reference of GPz's VC model trained on rows with unobserved
bands (NaN in X): init.m with pca.m's NaN-aware moments and fillLinear.m's
imputation, and the objective with getPHI.m:76-87's marginalisation, in
plain PyTorch and NumPy, float64 throughout. It imports nothing of the
program, and of the benchmark only the complete-row reference (gpz.py),
whose Gaussian terms, evidence and parameter layout it shares.

The design matrix is built pattern by pattern: the rows that observe the
bands o are a Gaussian over o alone, gauss_terms on X[:, o],
Psi[:, o, o], P[:, o] and Sigma[:, o, o], plus 0.5 log|Sigma_j,oo| and
-0.5 (d - |o|) ln 2. So it shares nothing with the program's masked pass,
which embeds each row's observed block in a full d x d system.

`init_vc`, `Problem`, `nlml_grad`, `flatten` and `leaf_slices` take and
give what gpz.py's do, so that a check written against gpz.py follows this
reference as it stands.

Departures from GPz, each the complete-row reference's too where it has
them:
  * unit row weights, where GPz's demo trains with getOmega's weights;
  * psi is each row's diagonal input noise (n, d), widened to (n, d, d);
  * the 2 pi constant carries the factor k (k = 1 here: no difference);
  * fillLinear's conditional mean is solved on each pattern's observed
    block, and keeps the observed values as given, where fillLinear.m
    solves the masked full-size system and gives them back to rounding;
  * the gradient is autograd's of the same function, where GPz writes
    its derivatives out by hand.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpzbench.reference.gpz import (  # noqa: F401  (the shared interface)
    BLOCK, _evidence, blocked, covariances, flatten, gauss_terms,
    leaf_slices, normalise, unflatten,
)

LN2 = math.log(2.0)


def patterns(X) -> list:
    """[(rows, observed bands)] of X's rows (NaN where unobserved), one
    entry a pattern of observed bands, as index arrays."""
    obs = ~np.isnan(np.asarray(X))
    pats, inv = np.unique(obs, axis=0, return_inverse=True)
    inv = np.ravel(inv)
    return [(np.nonzero(inv == g)[0], np.nonzero(pat)[0])
            for g, pat in enumerate(pats)]


# ---------------------------------------------------------------- init ----

def nan_moments(X):
    """pca.m:5-17: the mean over each band's observed values, and the
    covariance of the zero-filled centred rows over n less the rows that
    miss either band of a pair."""
    n = len(X)
    miss = np.isnan(X)
    mu = np.where(miss, 0.0, X).sum(0) / (~miss).sum(0)
    Xc = np.where(miss, 0.0, X - mu)
    Mc = miss.astype(np.float64)
    return mu, Xc.T @ Xc / (n - Mc.T @ Mc)


def fill_linear(X, mu, cov):
    """fillLinear.m: each unobserved band of a row set to its Gaussian
    conditional mean given the row's observed bands, mu_u + cov_uo
    cov_oo^-1 (x_o - mu_o)."""
    out = np.array(X, dtype=np.float64)
    for rows, o in patterns(X):
        u = np.setdiff1d(np.arange(X.shape[1]), o)
        if not len(u):
            continue
        gain = np.linalg.solve(cov[np.ix_(o, o)], cov[np.ix_(o, u)])
        out[np.ix_(rows, u)] = mu[u] + (X[np.ix_(rows, o)] - mu[o]) @ gain
    return out


def init_vc(X, Y, psi, training, m: int, seed: int, device):
    """init.m for VC with heteroscedastic noise on rows with NaNs: centres
    uniform in the unit cube whitened by pca.m's NaN-aware moments of the
    training rows (the draw `default_rng(seed).random((m, d))`), length
    scales gamma_j = sqrt(0.5 m^(1/d) / mean_i |xl_i - p_j|^2) over the
    imputed rows xl, b = log var(y), ln_alpha = -b, v = ln_tau = 0.
    Returns (params, (muX, sdX, muY)); params as float64 NumPy arrays."""
    Y = Y.reshape(len(Y), -1)
    muX, sdX, muY, Xn, _ = normalise(X, Y, psi, training)
    Xt = Xn[training]
    n, d = Xt.shape
    k = Y.shape[1]
    b = np.log(np.var(Y[training] - muY, axis=0, ddof=1))
    mu, cov = nan_moments(Xt)
    ev, U = np.linalg.eigh(n * cov)
    ev = np.abs(ev)
    order = np.argsort(-ev)
    U, ev = U[:, order], ev[order]
    T = np.sqrt(ev / (n - 1))[:, None] * U.T
    rng = np.random.default_rng(seed)
    P = ((rng.random((m, d)) - 0.5) * math.sqrt(12.0)) @ T + mu
    Xl = torch.as_tensor(fill_linear(Xt, mu, cov), dtype=torch.float64,
                         device=device)
    Pd = torch.as_tensor(P, dtype=torch.float64, device=device)
    dist = torch.zeros(m, dtype=torch.float64, device=device)
    rows = max(1, BLOCK // m)
    for r in range(0, n, rows):
        dist += ((Xl[r:r + rows, None, :] - Pd[None]) ** 2).sum(-1).sum(0)
    g = np.sqrt(0.5 * m ** (1.0 / d) / (dist / n).cpu().numpy())
    params = {"P": P, "gamma": np.eye(d)[None] * g[:, None, None],
              "ln_alpha": np.tile(-b, (m, 1)), "b": b,
              "v": np.zeros((m, k)), "ln_tau": np.zeros((m, k))}
    return params, (muX, sdX, muY)


# ----------------------------------------------------------- objective ----

class Problem:
    """A training set on the device: normalised X (n, d) with NaN where a
    band is unobserved, Psi (n, d, d), centred Y (n, k), unit weights, and
    its rows grouped by their pattern of observed bands (`groups`: device
    index tensors (rows, observed bands))."""

    def __init__(self, X, Y, psi, rows, stats, device):
        muX, sdX, muY = stats
        f64 = torch.float64
        Xn = (X[rows] - muX) / sdX
        Psi = np.zeros(Xn.shape + (Xn.shape[1],))
        idx = np.arange(Xn.shape[1])
        Psi[:, idx, idx] = psi[rows] / sdX ** 2
        self.X = torch.as_tensor(Xn, dtype=f64, device=device)
        self.Psi = torch.as_tensor(Psi, dtype=f64, device=device)
        self.Y = torch.as_tensor(Y[rows].reshape(len(Xn), -1) - muY,
                                 dtype=f64, device=device)
        self.groups = [(torch.as_tensor(r, device=device),
                        torch.as_tensor(o, device=device))
                       for r, o in patterns(Xn)]


def group_terms(X, Psi, o, P, S):
    """lnPHI (C, M) of rows X (C, d) that observe the bands o, with input
    noise Psi (C, d, d), against bases P (M, d), Sigma S (M, d, d): the
    Gaussian over o alone, 0.5 log|S_oo| and -0.5 ln 2 for each unobserved
    band (getPHI.m:76-87)."""
    d = S.shape[-1]
    Soo = S[:, o][:, :, o]
    return (gauss_terms(X[:, o], Psi[:, o][:, :, o], P[:, o], Soo)
            + 0.5 * torch.linalg.slogdet(Soo)[1][None]
            - 0.5 * (d - len(o)) * LN2)


def log_design(p, prob, block=BLOCK):
    """log PHI (n, m) of the parameters p (tensors) on the problem's rows,
    pattern by pattern."""
    S = covariances(p["gamma"])[0]
    out = torch.empty(prob.X.shape[0], S.shape[0], dtype=S.dtype,
                      device=S.device)
    for rows, o in prob.groups:
        out[rows] = blocked(
            lambda X, Psi: group_terms(X, Psi, o, p["P"], S),
            prob.X[rows], prob.Psi[rows], S.shape[0], block)
    return out


def nlml_grad(x, prob, m, d, k, block=2**21):
    """(nlml, gradient) at the flat float64 parameters x (a device tensor),
    as gpz.nlml_grad: PHI once without a graph, the evidence and its
    cotangent in PHI by autograd, then each pattern's rows again in blocks
    with a graph, the cotangent pulled back to P and Sigma, and from Sigma
    to gamma."""
    x = x.detach().clone().requires_grad_(True)
    p = unflatten(x, m, d, k)
    with torch.no_grad():
        PHI = torch.exp(log_design({n: t.detach() for n, t in p.items()},
                                   prob))
    PHI.requires_grad_(True)
    nlml = _evidence(PHI, prob.Y, p)
    nlml.backward()
    cot = PHI.grad
    del PHI
    S = covariances(p["gamma"])[0]
    Pl, Sl = (t.detach().clone().requires_grad_(True) for t in (p["P"], S))
    step = max(1, block // m)
    for rows, o in prob.groups:
        for r in range(0, len(rows), step):
            sel = rows[r:r + step]
            lnphi = group_terms(prob.X[sel], prob.Psi[sel], o, Pl, Sl)
            torch.exp(lnphi).backward(cot[sel])
    torch.autograd.backward([p["P"], S], [Pl.grad, Sl.grad])
    return float(nlml.detach()), x.grad.detach()
