"""A plain reference of GPz's VC model (Almosallam et al. 2016; the
MATLAB reference's init.m, GPz.m, getPrior.m and predictCov.m) in plain
PyTorch and NumPy, float64 throughout. It imports nothing of the program:
everything it needs (normalisation, length scales, posterior weights,
mixture priors, the moments) it works out from the benchmark's data and
the hyperparameters it is handed.

Every Gaussian of a d x d covariance is one unrolled Cholesky over d,
elementwise on (rows, bases) tensors, so that a block of rows against all
bases is a few hundred plain tensor operations whatever the sizes.

A parameter set is a dict of the leaves of GPz's theta (LEAVES):
P (m, d) centres, gamma (m, d, d) with iSigma_j = gamma_j' gamma_j,
ln_alpha (m, k), b (k,), v (m, k), ln_tau (m, k).
"""

from __future__ import annotations

import math

import numpy as np
import torch

LEAVES = ("P", "gamma", "ln_alpha", "b", "v", "ln_tau")
LN2PI = math.log(2.0 * math.pi)

#: elements of one (rows, bases) block: its few dozen live tensors stay
#: within a few GB
BLOCK = 2**22


def gauss_terms(X, Psi, P, S):
    """-1/2 (x_c - p_j)' (Psi_c + S_j)^-1 (x_c - p_j) - 1/2 log|Psi_c + S_j|
    for every row c of X (C, d), Psi (C, d, d) and every j of P (M, d),
    S (M, d, d): a (C, M) tensor. Lower triangles are read."""
    d = X.shape[1]
    A = [[Psi[:, a, b][:, None] + S[:, a, b][None, :] for b in range(a + 1)]
         for a in range(d)]
    L = [[None] * d for _ in range(d)]
    logdet = 0.0
    for j in range(d):
        s = A[j][j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        logdet = logdet + torch.log(s)
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, d):
            s2 = A[i][j]
            for t in range(j):
                s2 = s2 - L[i][t] * L[j][t]
            L[i][j] = s2 / L[j][j]
    quad = 0.0
    z = []
    for i in range(d):
        r = X[:, i][:, None] - P[:, i][None, :]
        for t in range(i):
            r = r - L[i][t] * z[t]
        z.append(r / L[i][i])
        quad = quad + z[i] * z[i]
    return -0.5 * quad - 0.5 * logdet


def blocked(fn, X, Psi, M, block=BLOCK):
    """fn(X block, Psi block) over blocks of rows of at most `block` / M
    rows, concatenated."""
    rows = max(1, block // max(1, M))
    return torch.cat([fn(X[r:r + rows], Psi[r:r + rows])
                      for r in range(0, X.shape[0], rows)])


def covariances(gamma):
    """(Sigma (m, d, d), log|Sigma| (m,), iSigma) of gamma."""
    iS = gamma.transpose(-1, -2) @ gamma
    return torch.linalg.inv(iS), -torch.linalg.slogdet(iS)[1], iS


def flatten(params: dict) -> np.ndarray:
    return np.concatenate([np.asarray(params[k], np.float64).ravel()
                           for k in LEAVES])


def unflatten(x, m: int, d: int, k: int) -> dict:
    shapes = {"P": (m, d), "gamma": (m, d, d), "ln_alpha": (m, k), "b": (k,),
              "v": (m, k), "ln_tau": (m, k)}
    out, at = {}, 0
    for name in LEAVES:
        size = int(np.prod(shapes[name]))
        out[name] = x[at:at + size].reshape(shapes[name])
        at += size
    return out


def leaf_slices(m: int, d: int, k: int) -> dict:
    sizes = {"P": m * d, "gamma": m * d * d, "ln_alpha": m * k, "b": k,
             "v": m * k, "ln_tau": m * k}
    out, at = {}, 0
    for name in LEAVES:
        out[name] = slice(at, at + sizes[name])
        at += sizes[name]
    return out


# ---------------------------------------------------------------- init ----

def normalise(X, Y, psi, training):
    """(muX, sdX, muY) as init.m:22-43: NaN-aware mean and population
    standard deviation over every row given, the target's mean over the
    training rows; and X, psi normalised (psi (n, d) diagonal variances ->
    (n, d, d))."""
    obs = ~np.isnan(X)
    Xz = np.where(obs, X, 0.0)
    cnt = obs.sum(0)
    muX = Xz.sum(0) / cnt
    sdX = np.sqrt((Xz ** 2).sum(0) / cnt - muX ** 2)
    muY = Y[training].mean(0)
    Xn = (X - muX) / sdX
    Psi = np.zeros(psi.shape + (psi.shape[1],))
    idx = np.arange(psi.shape[1])
    Psi[:, idx, idx] = psi / sdX ** 2
    return muX, sdX, muY, Xn, Psi


def init_vc(X, Y, psi, training, m: int, seed: int, device):
    """The starting hyperparameters of init.m for VC with heteroscedastic
    noise on complete rows: centres uniform in the PCA-whitened unit cube
    (the draw `default_rng(seed).random((m, d))`), length scales
    gamma_j = sqrt(0.5 m^(1/d) / mean_i |x_i - p_j|^2) on the diagonal,
    b = log var(y), ln_alpha = -b, v = ln_tau = 0. Returns (params,
    (muX, sdX, muY)); params as float64 NumPy arrays."""
    Y = Y.reshape(len(Y), -1)
    muX, sdX, muY, Xn, _ = normalise(X, Y, psi, training)
    Xt = Xn[training]
    n, d = Xt.shape
    k = Y.shape[1]
    b = np.log(np.var(Y[training] - muY, axis=0, ddof=1))
    mu = Xt.mean(0)
    Xc = Xt - mu
    cov = Xc.T @ Xc / n
    ev, U = np.linalg.eigh(n * cov)
    ev = np.abs(ev)
    order = np.argsort(-ev)
    U, ev = U[:, order], ev[order]
    T = np.sqrt(ev / (n - 1))[:, None] * U.T
    rng = np.random.default_rng(seed)
    P = ((rng.random((m, d)) - 0.5) * math.sqrt(12.0)) @ T + mu
    Xd = torch.as_tensor(Xt, dtype=torch.float64, device=device)
    Pd = torch.as_tensor(P, dtype=torch.float64, device=device)
    dist = torch.zeros(m, dtype=torch.float64, device=device)
    rows = max(1, BLOCK // m)
    for r in range(0, n, rows):
        dist += ((Xd[r:r + rows, None, :] - Pd[None]) ** 2).sum(-1).sum(0)
    g = np.sqrt(0.5 * m ** (1.0 / d) / (dist / n).cpu().numpy())
    params = {"P": P, "gamma": np.eye(d)[None] * g[:, None, None],
              "ln_alpha": np.tile(-b, (m, 1)), "b": b,
              "v": np.zeros((m, k)), "ln_tau": np.zeros((m, k))}
    return params, (muX, sdX, muY)


# ----------------------------------------------------------- objective ----

class Problem:
    """A training set on the device: normalised X (n, d), Psi (n, d, d) and
    centred Y (n, k), complete rows, unit weights."""

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


def log_design(p, prob, block=BLOCK):
    """log PHI (n, m) of the parameters p (tensors) on the problem's rows."""
    S, ld, _ = covariances(p["gamma"])
    return blocked(
        lambda X, Psi: gauss_terms(X, Psi, p["P"], S) + 0.5 * ld[None],
        prob.X, prob.Psi, S.shape[0], block)


def _evidence(PHI, Y, p, solve=False):
    """-mean log marginal likelihood (GPz.m:43-110) of PHI and p, and with
    `solve` the posterior (w (m, k), SIGMA^-1 (k, m, m))."""
    n, m = PHI.shape
    k = Y.shape[1]
    ln_beta = p["b"][None, :] + PHI @ p["v"]
    beta = torch.exp(-ln_beta)
    alpha = torch.exp(p["ln_alpha"])
    total = -0.5 * LN2PI * k * n
    ws, inv = [], []
    for kk in range(k):
        ob = beta[:, kk]
        SIG = PHI.T @ (PHI * ob[:, None]) + torch.diag(alpha[:, kk])
        rhs = PHI.T @ (ob * Y[:, kk])
        L = torch.linalg.cholesky(SIG)
        w = torch.cholesky_solve(rhs[:, None], L)[:, 0]
        delta = PHI @ w - Y[:, kk]
        total = total + (
            -0.5 * torch.sum(ob * delta ** 2)
            - 0.5 * torch.sum(alpha[:, kk] * w ** 2)
            + 0.5 * torch.sum(p["ln_alpha"][:, kk])
            - torch.sum(torch.log(torch.diagonal(L)))
            - 0.5 * torch.sum(ln_beta[:, kk])
            - 0.5 * torch.sum(p["v"][:, kk] ** 2 * torch.exp(p["ln_tau"][:, kk]))
            + 0.5 * torch.sum(p["ln_tau"][:, kk]) - 0.5 * m * LN2PI)
        if solve:
            ws.append(w)
            inv.append(torch.cholesky_inverse(L))
    nlml = -total / (n * k)
    if solve:
        return nlml, torch.stack(ws, 1), torch.stack(inv)
    return nlml


def nlml_grad(x, prob, m, d, k, block=2**21):
    """(nlml, gradient) at the flat float64 parameters x (a device tensor):
    PHI once without a graph, the evidence and its cotangent in PHI by
    autograd, then each block of rows again with a graph and the cotangent
    pulled back to P and Sigma, and from Sigma to gamma."""
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
    S, ld, _ = covariances(p["gamma"])
    Pl, Sl, ldl = (t.detach().clone().requires_grad_(True)
                   for t in (p["P"], S, ld))
    rows = max(1, block // m)
    for r in range(0, prob.X.shape[0], rows):
        lnphi = (gauss_terms(prob.X[r:r + rows], prob.Psi[r:r + rows], Pl, Sl)
                 + 0.5 * ldl[None])
        torch.exp(lnphi).backward(cot[r:r + rows])
    torch.autograd.backward([p["P"], S, ld], [Pl.grad, Sl.grad, ldl.grad])
    return float(nlml.detach()), x.grad.detach()


def posterior(params, prob):
    """(w (m, k), SIGMA^-1 (k, m, m), priors (m,)) of parameters (float64
    tensors) on the training rows: the weights' posterior (GPz.m:84-87)
    and the mixture prior's EM fixed point (getPrior.m: at most 100
    iterations, to a relative change under 1e-10)."""
    with torch.no_grad():
        lnPHI = log_design(params, prob)
        _, w, inv = _evidence(torch.exp(lnPHI), prob.Y, params, solve=True)
        S, ld, _ = covariances(params["gamma"])
        d = S.shape[1]
        lnN = lnPHI - 0.5 * ld[None] - 0.5 * d * LN2PI
        N = torch.exp(lnN - lnN.max(1, keepdim=True).values)
        m = S.shape[0]
        prior = torch.full((m,), 1.0 / m, dtype=N.dtype, device=N.device)
        for _ in range(100):
            r = N * prior[None]
            new = (r / r.sum(1, keepdim=True)).mean(0)
            delta = float(torch.linalg.norm(prior - new)
                          / torch.linalg.norm(prior + new))
            prior = new
            if delta < 1e-10:
                break
    return w, inv, prior


# ------------------------------------------------------------- moments ----

def _components(X, Psi, p, S, iS, prior):
    """The Gaussian components of each row's inputs, (rows (C,), weights
    (C,), X_hat (C, d), Psi_hat (C, d, d)): a complete row is its own one
    component; a row with unobserved bands is the mixture over all m bases
    of the band's conditional given the observed ones (predictCov.m:134-232,
    the exact sum), weighted by the bases' responsibilities under the
    observed bands."""
    n, d = X.shape
    m = S.shape[0]
    obs = ~torch.isnan(X)
    rows, wts, xs, ps = [], [], [], []
    pats, inv = torch.unique(obs, dim=0, return_inverse=True)
    for g, pat in enumerate(pats):
        idx = torch.nonzero(inv == g)[:, 0]
        if bool(pat.all()):
            rows.append(idx)
            wts.append(torch.ones(len(idx), dtype=X.dtype, device=X.device))
            xs.append(X[idx])
            ps.append(Psi[idx])
            continue
        o = torch.nonzero(pat)[:, 0]
        u = torch.nonzero(~pat)[:, 0]
        xo = X[idx][:, o]
        Poo = Psi[idx][:, o][:, :, o]
        logit = blocked(lambda Xb, Pb: gauss_terms(
            Xb, Pb, p["P"][:, o], S[:, o][:, :, o]), xo, Poo, m)
        tiny = torch.finfo(prior.dtype).tiny
        resp = torch.softmax(logit + torch.log(prior.clamp(min=tiny))[None],
                             1)                                   # (r, m)
        K = iS[:, u][:, :, u]                                     # (m, u, u)
        cond = torch.linalg.inv(K)
        R = -cond @ iS[:, u][:, :, o]                             # (m, u, o)
        r_, dd = len(idx), d
        Xh = X[idx][:, None, :].expand(r_, m, dd).clone()
        Xh[:, :, u] = p["P"][None][:, :, u] + torch.einsum(
            "mab,rmb->rma", R, xo[:, None, :] - p["P"][None][:, :, o])
        J = torch.zeros(m, dd, dd, dtype=X.dtype, device=X.device)
        J[:, o, o] = 1.0
        J[:, u[:, None], o[None, :]] = R
        Ph = torch.einsum("mab,rbc,mdc->rmad", J, Psi[idx], J)
        Ph[:, :, u[:, None], u[None, :]] += cond[None]
        rows.append(idx[:, None].expand(r_, m).reshape(-1))
        wts.append(resp.reshape(-1))
        xs.append(Xh.reshape(-1, dd))
        ps.append(Ph.reshape(-1, dd, dd))
    return torch.cat(rows), torch.cat(wts), torch.cat(xs), torch.cat(ps)


def predict(params, w, iSw, prior, muY, X, Psi, block=BLOCK):
    """GPz's predictive moments (predictCov.m) of rows X (n, d), NaN where
    a band is unobserved, normalised, with input noise Psi (n, d, d): dict
    of mu, sigma, nu, beta_i, gamma, each (n, k), float64 NumPy arrays."""
    with torch.no_grad():
        S, ld, iS = covariances(params["gamma"])
        P = params["P"]
        m, d = P.shape
        lnz = 0.5 * ld
        rows, wts, Xh, Ph = _components(X, Psi, params, S, iS, prior)
        n = X.shape[0]

        def mix(Pb, Sb, shift):
            """sum over each row's components of weight * exp(terms)."""
            M = Pb.shape[0]
            out = torch.zeros(n, M, dtype=X.dtype, device=X.device)
            step = max(1, block // M)
            for c in range(0, len(rows), step):
                t = torch.exp(gauss_terms(Xh[c:c + step], Ph[c:c + step], Pb,
                                          Sb) + shift[None])
                out.index_add_(0, rows[c:c + step], t * wts[c:c + step, None])
            return out

        PHI = mix(P, S, lnz)
        # the pairs (i, j): N(x; P_i, S_i) N(x; P_j, S_j) is
        # N(P_i; P_j, S_i + S_j) N(x; c_ij, C_ij)
        C = torch.linalg.inv(iS[:, None] + iS[None])               # (m, m, d, d)
        c = torch.einsum("ijab,ijb->ija", C,
                         (iS @ P[..., None])[:, None, :, 0]
                         + (iS @ P[..., None])[None, :, :, 0])
        lnZ = (lnz[:, None] + lnz[None, :]
               + gauss_terms(P, S, P, S))                          # (m, m)
        Ec = mix(c.reshape(m * m, d), C.reshape(m * m, d, d),
                 torch.zeros(m * m, dtype=X.dtype, device=X.device))
        ZN = torch.exp(lnZ)[None] * Ec.reshape(n, m, m)
        v, b = params["v"], params["b"]
        mu = PHI @ w
        ElnS = PHI @ v
        g = torch.einsum("nij,ik,jk->nk", ZN, w, w)
        V = torch.einsum("nij,ik,jk->nk", ZN, v, v)
        nu = torch.clamp(torch.einsum("nij,kij->nk", ZN, iSw), min=0.0)
        gamma = torch.clamp(g - mu ** 2, min=0.0)
        beta = torch.exp(ElnS + b[None]) * (1.0 + 0.5 * (V - ElnS ** 2))
        out = {"mu": mu + torch.as_tensor(muY, dtype=mu.dtype,
                                          device=mu.device)[None],
               "sigma": nu + beta + gamma, "nu": nu, "beta_i": beta,
               "gamma": gamma}
        return {k_: t.cpu().numpy() for k_, t in out.items()}
