"""Host-resident L-BFGS — the minFunc-equivalent for arbitrary Python
objectives (ref minFunc/minFunc.m L-BFGS path + WolfeLineSearch.m); a copy of
gpz_tpu.optim.host_lbfgs, so the same callable gives the same bits.

Training on the GPU uses the optimizer whose iterate and history are device
tensors (optim/lbfgs.py); this one drives objectives that live on the host
(NumPy models, external simulators, scipy-style callables, or a device
objective behind a closure that copies x in and (f, g) out as float64 NumPy)
with the hot kernels — two-loop recursion and in-place curvature insertion —
in native C++ (gpz_tpu_torch.native, parity with ref mex/lbfgsProdC.c,
lbfgsAddC.c), falling back to NumPy when no compiler is available.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from gpz_tpu_torch import native


@dataclasses.dataclass
class HostResult:
    x: np.ndarray
    f: float
    iterations: int
    fun_evals: int
    status: str
    trace: list


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """2-point cubic interpolation minimizer (ref polyinterp.m)."""
    if not (np.isfinite(f1) and np.isfinite(f2)):
        return 0.5 * (lo + hi)
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    rad = d1 * d1 - g1 * g2
    if rad < 0:
        return 0.5 * (lo + hi)
    sq = np.sqrt(rad) * (1 if x2 >= x1 else -1)
    denom = g2 - g1 + 2 * sq
    if abs(denom) < 1e-30:
        return 0.5 * (lo + hi)
    t = x2 - (x2 - x1) * (g2 + sq - d1) / denom
    if not np.isfinite(t):
        return 0.5 * (lo + hi)
    return float(np.clip(t, lo, hi))


def _wolfe(fun, x, f0, g0, d, t0, c1, c2, max_ls, prog_tol):
    """Strong-Wolfe bracket + zoom (ref WolfeLineSearch.m:50-241)."""
    gtd0 = float(g0 @ d)
    evals = 0

    def ev(t):
        nonlocal evals
        f, g = fun(x + t * d)
        evals += 1
        if not np.isfinite(f):
            f = np.inf
        return float(f), g

    t = t0
    t_prev, f_prev, g_prev = 0.0, f0, g0
    gtd_prev = gtd0
    f_new, g_new = ev(t)
    ls_iter = 1
    bracket = None

    while ls_iter < max_ls:
        gtd_new = float(g_new @ d)
        if f_new > f0 + c1 * t * gtd0 or (ls_iter > 1 and f_new >= f_prev):
            bracket = [(t_prev, f_prev, g_prev), (t, f_new, g_new)]
            break
        if abs(gtd_new) <= -c2 * gtd0:
            return t, f_new, g_new, evals, False
        if gtd_new >= 0:
            bracket = [(t_prev, f_prev, g_prev), (t, f_new, g_new)]
            break
        min_step = t + 0.01 * (t - t_prev)
        max_step = t * 10
        t_next = _cubic_min(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                            min_step, max_step)
        t_prev, f_prev, g_prev, gtd_prev = t, f_new, g_new, gtd_new
        t = t_next
        f_new, g_new = ev(t)
        ls_iter += 1

    if bracket is None:
        if f_new < f0:
            return t, f_new, g_new, evals, False
        bracket = [(0.0, f0, g0), (t, f_new, g_new)]

    # zoom
    (t_lo, f_lo, g_lo), (t_hi, f_hi, g_hi) = bracket
    if f_hi < f_lo:
        (t_lo, f_lo, g_lo), (t_hi, f_hi, g_hi) = (
            (t_hi, f_hi, g_hi), (t_lo, f_lo, g_lo))
    while ls_iter < max_ls:
        lo_b, hi_b = min(t_lo, t_hi), max(t_lo, t_hi)
        width = hi_b - lo_b
        t = _cubic_min(t_lo, f_lo, float(g_lo @ d), t_hi, f_hi,
                       float(g_hi @ d), lo_b, hi_b)
        t = float(np.clip(t, lo_b + 0.1 * width, hi_b - 0.1 * width))
        f_new, g_new = ev(t)
        ls_iter += 1
        gtd_new = float(g_new @ d)
        if f_new > f0 + c1 * t * gtd0 or f_new >= f_lo:
            t_hi, f_hi, g_hi = t, f_new, g_new
        else:
            if abs(gtd_new) <= -c2 * gtd0:
                return t, f_new, g_new, evals, False
            if gtd_new * (t_hi - t_lo) >= 0:
                t_hi, f_hi, g_hi = t_lo, f_lo, g_lo
            t_lo, f_lo, g_lo = t, f_new, g_new
        if abs(gtd_new) * abs(t_hi - t_lo) < prog_tol:
            break

    if f_lo < f0 and t_lo > 0:
        return t_lo, f_lo, g_lo, evals, False
    return 0.0, f0, g0, evals, True


def minimize_host(
    fun: Callable,
    x0: np.ndarray,
    *,
    history: int = 100,
    max_iter: int = 200,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 25,
    callback: Optional[Callable] = None,
) -> HostResult:
    """Minimize fun(x) -> (f, g) with L-BFGS + strong Wolfe on the host."""
    x = np.asarray(x0, dtype=np.float64).copy()
    p = x.shape[0]
    f, g = fun(x)
    f = float(f)
    g = np.asarray(g, dtype=np.float64)
    evals = 1

    S = np.zeros((history, p))
    Y = np.zeros((history, p))
    count, pos, hdiag = 0, 0, 1.0
    trace = [(f, float(np.max(np.abs(g))))]
    status = "max_iter"

    if np.max(np.abs(g)) <= opt_tol:
        return HostResult(x, f, 0, evals, "optimal", trace)

    for it in range(max_iter):
        if count == 0:
            d = -g
        else:
            d = native.lbfgs_direction(S, Y, count, pos, hdiag, g)
        if not np.all(np.isfinite(d)):
            d = -g
        gtd = float(g @ d)
        if gtd > -prog_tol:
            status = "no_descent"
            break

        t0 = min(1.0, 1.0 / np.sum(np.abs(g))) if it == 0 else 1.0
        t, f_new, g_new, ls_evals, failed = _wolfe(
            fun, x, f, g, d, t0, c1, c2, max_ls, prog_tol
        )
        evals += ls_evals
        if failed:
            status = "ls_failed"
            break

        s = t * d
        y = g_new - g
        count, pos, hdiag, _ = native.lbfgs_add(S, Y, count, pos, hdiag, s, y)

        x = x + s
        df = abs(f - f_new)
        f, g = f_new, np.asarray(g_new, dtype=np.float64)
        opt_cond = float(np.max(np.abs(g)))
        trace.append((f, opt_cond))
        if callback is not None and callback(x, f, g, it):
            status = "callback_stop"
            break
        if opt_cond <= opt_tol:
            status = "optimal"
            break
        if np.max(np.abs(s)) <= prog_tol or df < prog_tol:
            status = "prog_tol"
            break

    return HostResult(x, f, len(trace) - 1, evals, status, trace)
