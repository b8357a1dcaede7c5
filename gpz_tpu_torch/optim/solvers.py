"""Full minFunc-equivalent solver family on the host.

The reference optimizer exposes ten unconstrained methods
(ref minFunc/minFunc.m:10-41,248-257); GPz itself only drives the L-BFGS
path, but the framework keeps the whole family available for host-side
objectives (NumPy models, posterior diagnostics, small calibration fits):

  sd       steepest descent                     (ref minFunc.m:386-387)
  csd      cyclic steepest descent              (ref minFunc.m:389-399)
  bb       Barzilai–Borwein step lengths        (ref minFunc.m:401-444)
  cg       nonlinear conjugate gradient         (ref minFunc.m:447-485)
  pcg      L-BFGS-preconditioned CG             (ref minFunc.m:487-543)
  lbfgs    limited-memory BFGS                  (optim/host_lbfgs.py)
  qnewton  dense quasi-Newton (BFGS inverse H)  (ref minFunc.m:584-713)
  newton0  Hessian-free Newton (CG + num. Hv)   (ref minFunc.m:715-793)
  newton   exact Newton w/ modified Cholesky    (ref minFunc.m:795-819,
                                                 mex/mcholC.c via native)
  scg      CG with Hessian-scaled initial step  (ref minFunc_process-
                                                 InputOptions.m:98-101,
                                                 minFunc.m:1001-1017)
  mnewton  Newton, Hessian reused 5 iterations  (ref minFunc_process-
                                                 InputOptions.m:77-79,
                                                 minFunc.m:1041-1049)
  tensor   3rd-order Taylor model via inner     (ref minFunc.m:932-959,
           Newton solve, eig-step fallback       taylorModel.m)

All methods share the strong-Wolfe / Armijo line searches and the
optTol/progTol termination rules of the reference's minFunc.m
(ref minFunc.m:96-97,963,1118-1147). This is deliberately a *host*
component, a copy of gpz_tpu.optim.solvers (the same callable gives the same
bits) — GPU training is the device-tensor optimizer in optim/lbfgs.py; these
exist for reference parity and for host-side objectives.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from gpz_tpu_torch import native
from gpz_tpu_torch.optim.host_lbfgs import (
    HostResult,
    _cubic_min,
    _wolfe,
    minimize_host as _lbfgs_host,
)

METHODS = (
    "sd", "csd", "bb", "cg", "pcg", "lbfgs", "qnewton", "newton0", "newton",
    "scg", "mnewton", "tensor",
)


def armijo_backtrack(fun, x, f0, g0, d, t0, c1, max_ls, prog_tol):
    """Backtracking line search with cubic interpolation
    (ref minFunc/ArmijoBacktrack.m). Returns (t, f, g, evals, failed)."""
    gtd0 = float(g0 @ d)
    evals = 0

    def ev(t):
        nonlocal evals
        f, g = fun(x + t * d)
        evals += 1
        return (np.inf if not np.isfinite(f) else float(f)), g

    t = t0
    f_new, g_new = ev(t)
    ls_iter = 0
    while f_new > f0 + c1 * t * gtd0:
        if ls_iter >= max_ls or t * np.max(np.abs(d)) <= prog_tol:
            return 0.0, f0, g0, evals, True
        # cubic backtrack using (0, f0, gtd0) and the failed trial
        gtd_new = float(g_new @ d)
        t = _cubic_min(0.0, f0, gtd0, t, f_new, gtd_new,
                       1e-3 * t, 0.6 * t)
        f_new, g_new = ev(t)
        ls_iter += 1
    return t, f_new, g_new, evals, False


def conj_grad(hv, b, tol, max_iter, precond=None):
    """Preconditioned linear CG for H d = b given only Hessian-vector
    products, stopping early on negative curvature
    (ref minFunc/conjGrad.m). Returns (d, iters) where `iters` counts the
    Hessian-vector products actually performed (so callers can account
    evals exactly).

    On a first-iteration negative-curvature exit the negative residual
    -r = b is returned; in the Newton-direction use (b == -g, as newton0
    calls it) that is the steepest-descent direction, matching the
    reference's fallback (conjGrad.m). Generic callers get b itself —
    an arbitrary but finite direction, not a solve.
    """
    x = np.zeros_like(b)
    r = -b.astype(np.float64)  # residual of Hx - b at x = 0
    y = precond(r) if precond is not None else r
    p = -y
    ry = float(r @ y)
    for it in range(max_iter):
        Hp = hv(p)
        pHp = float(p @ Hp)
        if pHp <= 1e-16 * float(p @ p):
            # negative/zero curvature: it + 1 Hv products have been spent
            if it == 0:
                return -r, 1
            return x, it + 1
        alpha = ry / pHp
        x = x + alpha * p
        r = r + alpha * Hp
        if np.linalg.norm(r) <= tol:
            return x, it + 1
        y = precond(r) if precond is not None else r
        ry_new = float(r @ y)
        p = -y + (ry_new / ry) * p
        ry = ry_new
    return x, max_iter


def numerical_hvp(fun, x, v, eps=None):
    """Hessian-vector product by central differences of the gradient
    (ref autoDif/autoHv.m)."""
    if eps is None:
        eps = np.sqrt(np.finfo(np.float64).eps) * max(1.0, np.linalg.norm(x)) \
            / max(np.linalg.norm(v), 1e-30)
    _, gp = fun(x + eps * v)
    _, gm = fun(x - eps * v)
    return (np.asarray(gp, np.float64) - np.asarray(gm, np.float64)) / (2 * eps)


class _LBFGSPrecond:
    """Circular-buffer L-BFGS memory used as a preconditioner for the
    pcg / newton0 methods (ref minFunc.m:489-506,722-741)."""

    def __init__(self, p, history=10):
        self.S = np.zeros((history, p))
        self.Y = np.zeros((history, p))
        self.count = 0
        self.pos = 0
        self.hdiag = 1.0
        self.history = history

    def update(self, s, y):
        ys = float(y @ s)
        if ys > 1e-10:
            self.S[self.pos] = s
            self.Y[self.pos] = y
            self.pos = (self.pos + 1) % self.history
            self.count = min(self.count + 1, self.history)
            self.hdiag = ys / float(y @ y)

    def apply(self, g):
        if self.count == 0:
            return g.copy()
        return -native.lbfgs_direction(
            self.S, self.Y, self.count, self.pos, self.hdiag, g
        )


def minimize_any(
    fun: Callable,
    x0: np.ndarray,
    *,
    method: str = "lbfgs",
    max_iter: int = 200,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 25,
    history: int = 100,
    cycle: int = 3,
    bb_type: int = 0,
    hess_fun: Optional[Callable] = None,
    callback: Optional[Callable] = None,
) -> HostResult:
    """Minimize fun(x) -> (f, g) with any reference solver method.

    `method='newton'` additionally needs the Hessian: either pass
    `hess_fun(x) -> H` or make `fun` return (f, g, H).
    """
    method = method.lower()
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; expected one of {METHODS}")
    if method == "lbfgs":
        return _lbfgs_host(
            fun, x0, history=history, max_iter=max_iter, opt_tol=opt_tol,
            prog_tol=prog_tol, c1=c1, c2=c2, max_ls=max_ls, callback=callback,
        )
    # reference aliases (minFunc_processInputOptions.m:70-114): scg is CG
    # with the Hessian-scaled step init; mnewton is Newton with the Hessian
    # recomputed every 5 iterations
    scaled_init = method == "scg"
    hessian_iter = 5 if method == "mnewton" else 1
    if method == "scg":
        method = "cg"
    elif method == "mnewton":
        method = "newton"

    def split(fx):
        # accept (f, g) or (f, g, H)
        if len(fx) == 3:
            return float(fx[0]), np.asarray(fx[1], np.float64), \
                np.asarray(fx[2], np.float64)
        return float(fx[0]), np.asarray(fx[1], np.float64), None

    def fg(x):
        f, g, _ = split(fun(x))
        return f, g

    def eval_H(xq):
        """Hessian at xq for the newton/mnewton/tensor families."""
        if hess_fun is not None:
            return np.asarray(hess_fun(xq), np.float64)
        fx = fun(xq)
        if len(fx) != 3 or fx[2] is None:
            raise ValueError(
                f"method={method!r} needs hess_fun or fun returning (f, g, H)"
            )
        return np.asarray(fx[2], np.float64)

    x = np.asarray(x0, np.float64).copy()
    p = x.shape[0]
    f, g, H = split(fun(x))
    evals = 1
    trace = [(f, float(np.max(np.abs(g))))]
    status = "max_iter"

    if np.max(np.abs(g)) <= opt_tol:
        return HostResult(x, f, 0, evals, "optimal", trace)

    # per-method carried state
    g_old = None
    d_old = None
    s_old = None  # preconditioned gradient (pcg)
    t = 1.0
    alpha = 1.0
    f_prev = f    # previous-iterate f (scg quadratic step init)
    h_age = 0     # iterations since the Hessian was computed (mnewton)
    Hinv = None  # qnewton dense inverse Hessian
    precond = _LBFGSPrecond(p, history=min(history, 10)) \
        if method in ("pcg", "newton0") else None

    for it in range(max_iter):
        # ---- direction ----
        use_armijo = False
        if method == "sd":
            d = -g
        elif method == "csd":
            # every `cycle` iterations reset to unit steepest descent with a
            # Wolfe search; in between reuse the previous accepted step size
            # with a cheap Armijo search (ref minFunc.m:389-399)
            if it % cycle == 0:
                alpha = 1.0
            else:
                alpha = t
                use_armijo = True
            d = -alpha * g
        elif method == "bb":
            if it == 0:
                d = -g
            else:
                y = g - g_old
                s = t * d_old
                if bb_type == 0:
                    denom = float(y @ y)
                    a = float(s @ y) / denom if denom > 0 else 1.0
                else:
                    sy = float(s @ y)
                    a = float(s @ s) / sy if sy != 0 else 1.0
                if not np.isfinite(a) or a <= 1e-10 or a > 1e10:
                    a = 1.0
                d = -a * g
            use_armijo = True
        elif method == "cg":
            if it == 0:
                d = -g
            else:
                gotgo = float(g_old @ g_old)
                # Gilbert–Nocedal PR+/FR hybrid (ref minFunc.m:466-471)
                beta_fr = float(g @ (g - g_old)) / gotgo
                beta_pr = (float(g @ g) - float(g @ g_old)) / gotgo
                beta = max(-beta_fr, min(beta_pr, beta_fr))
                d = -g + beta * d_old
                if float(g @ d) > -prog_tol:  # restart
                    d = -g
        elif method == "pcg":
            if it > 0:
                precond.update(t * d_old, g - g_old)
            s = precond.apply(-g)
            if it == 0:
                d = s
            else:
                denom = float(g_old @ s_old)
                beta_fr = float(g @ s) / denom
                beta_pr = float(g @ (s - s_old)) / denom
                beta = max(-beta_fr, min(beta_pr, beta_fr))
                d = s + beta * d_old
                if float(g @ d) > -prog_tol:
                    d = s
            s_old = s
        elif method == "qnewton":
            if it == 0:
                d = -g
            else:
                y = g - g_old
                s = t * d_old
                ys = float(y @ s)
                if Hinv is None:
                    # scaled-identity initial inverse Hessian
                    yy = float(y @ y)
                    Hinv = np.eye(p) * (ys / yy if yy > 0 else 1.0)
                if ys > 1e-10:
                    # BFGS inverse update (Sherman–Morrison form)
                    rho = 1.0 / ys
                    V = np.eye(p) - rho * np.outer(s, y)
                    Hinv = V @ Hinv @ V.T + rho * np.outer(s, s)
                d = -(Hinv @ g)
        elif method == "newton0":
            if it > 0:
                precond.update(t * d_old, g - g_old)
            gn = np.linalg.norm(g)
            tol = min(0.5, np.sqrt(gn)) * gn
            pre = precond.apply if precond.count > 0 else None
            d, cg_iters = conj_grad(
                lambda v: numerical_hvp(fg, x, v), g.copy() * -1.0,
                tol, min(p, 2 * max_iter), precond=pre,
            )
            evals += 2 * cg_iters  # two grad evals per Hv product
        elif method == "newton":
            if H is None:
                H = eval_H(x)
                evals += 1
                h_age = 0
            # Gill–Murray modified Cholesky: PD by construction
            L, dd, perm = native.modified_cholesky(H)
            z = np.linalg.solve(L, g[perm])
            w = np.linalg.solve(L.T, z / dd)
            d = np.zeros_like(g)
            d[perm] = -w
        elif method == "tensor":
            # 3rd-order Taylor model (ref minFunc.m:932-959): numerically
            # differentiate the Hessian for T (ref autoDif/autoTensor.m),
            # minimize the cubic model with an inner Newton run
            # (taylorModel.m), fall back to the eigendecomposed 2nd-order
            # step when the model step is unbounded/degenerate
            H = eval_H(x)
            T = np.zeros((p, p, p))
            h_eps = 1e-5 * max(1.0, float(np.linalg.norm(x)))
            for i_dim in range(p):
                e = np.zeros(p)
                e[i_dim] = h_eps
                T[i_dim] = (eval_H(x + e) - eval_H(x - e)) / (2 * h_eps)
            evals += 1 + 2 * p
            f_c, g_c, H_c = f, g.copy(), H

            def taylor(dd):
                fd = (
                    f_c + g_c @ dd + 0.5 * dd @ H_c @ dd
                    + np.einsum("ijk,i,j,k->", T, dd, dd, dd) / 6.0
                )
                gd = g_c + H_c @ dd + 0.5 * np.einsum("ijk,i,j->k", T, dd, dd)
                Hd = H_c + np.einsum("ijk,i->jk", T, dd)
                if np.any(np.abs(dd) > 1e5):  # unbounded model (taylorModel.m)
                    gd = np.zeros_like(gd)
                return fd, gd, Hd

            sub = minimize_any(
                taylor, np.zeros(p), method="newton",
                max_iter=max_iter, opt_tol=opt_tol, prog_tol=prog_tol,
            )
            d = sub.x
            if (np.any(np.abs(d) > 1e5) or np.all(np.abs(d) < 1e-5)
                    or float(g @ d) > -prog_tol):
                w_eig, V = np.linalg.eigh(0.5 * (H + H.T))
                dn = np.maximum(
                    np.abs(w_eig), max(float(np.max(np.abs(w_eig))), 1.0) * 1e-12
                )
                d = -V @ ((V.T @ g) / dn)
            H = None
        else:  # pragma: no cover
            raise AssertionError(method)

        if not np.all(np.isfinite(d)):
            d = -g
        gtd = float(g @ d)
        if gtd > -prog_tol:
            status = "no_descent"
            break

        # ---- line search ----
        t0 = min(1.0, 1.0 / np.sum(np.abs(g))) if it == 0 else 1.0
        if method == "csd" and not use_armijo:
            t0 = 1.0
        if scaled_init and it > 0:
            # LS_init=4 (ref minFunc.m:1001-1017): exact Newton step along d
            # from a numerical Hessian-vector product; quadratic init from
            # the previous f decrease when curvature is non-positive
            dHd = float(d @ numerical_hvp(fg, x, d))
            evals += 2
            t0 = -gtd / dHd if dHd > 0 else min(1.0, 2.0 * (f - f_prev) / gtd)
            if not np.isfinite(t0) or t0 <= 0:
                t0 = 1.0
        if use_armijo:
            # the first-iteration min(1, 1/sum|g|) scaling applies to every
            # method in the reference (minFunc.m:983-1023), Armijo included
            t, f_new, g_new, ls_evals, failed = armijo_backtrack(
                fg, x, f, g, d, t0, c1, max_ls, prog_tol)
        else:
            t, f_new, g_new, ls_evals, failed = _wolfe(
                fg, x, f, g, d, t0, c1, c2, max_ls, prog_tol)
        evals += ls_evals
        if failed:
            status = "ls_failed"
            break

        g_old, d_old = g, d
        f_prev = f
        step = t * d
        x = x + step
        df = abs(f - f_new)
        f, g = f_new, np.asarray(g_new, np.float64)
        # newton re-evaluates the Hessian at the new iterate; mnewton reuses
        # it for hessian_iter iterations (ref minFunc.m:1041-1049)
        h_age += 1
        if h_age >= hessian_iter:
            H = None
        opt_cond = float(np.max(np.abs(g)))
        trace.append((f, opt_cond))
        if callback is not None and callback(x, f, g, it):
            status = "callback_stop"
            break
        if opt_cond <= opt_tol:
            status = "optimal"
            break
        if np.max(np.abs(step)) <= prog_tol or df < prog_tol:
            status = "prog_tol"
            break

    return HostResult(x, f, len(trace) - 1, evals, status, trace)
