"""The optimizer that GPz training specifies, written plainly: L-BFGS over a
history of curvature pairs (minFunc's lbfgsProd / lbfgsAdd: pairs with
y's > 1e-10, initial scaling y's / y'y), a first step of min(1, 1/|g|_1)
along -g, and minFunc's strong-Wolfe search (bracketing by cubic
extrapolation in [t + 0.01 (t - t_prev), 10 t], then zoom by cubic
interpolation kept a tenth of the bracket inside it), with the
conventions of the port's gpz_tpu: the second and later bracketing trials
are also rejected when they do not improve on the previous one, a
non-finite trial reads as +inf with a zero gradient, and the zoom gives
up once |g'd| times the bracket's width is under prog_tol.

`minimize` runs a given number of iterations and keeps every iterate, so
a check can follow a training run's first steps.
"""

from __future__ import annotations

import math

import torch


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    d1 = g1 + g2 - 3.0 * (f1 - f2) / (x1 - x2)
    rad = d1 * d1 - g1 * g2
    sq = math.sqrt(max(rad, 0.0))
    if x2 < x1:
        sq = -sq
    denom = g2 - g1 + 2.0 * sq
    try:
        t = x2 - (x2 - x1) * (g2 + sq - d1) / denom
    except ZeroDivisionError:
        t = math.nan
    if rad < 0 or not math.isfinite(t) or abs(denom) < 1e-30:
        t = 0.5 * (lo + hi)
    return min(max(t, lo), hi)


def _trial(fun, x, d, t):
    f, g = fun(x + t * d)
    if not (math.isfinite(f) and bool(torch.isfinite(g).all())):
        return math.inf, torch.zeros_like(g), 0.0
    return f, g, float(g @ d)


def wolfe(fun, x, f0, g0, d, gtd0, t, c1, c2, max_ls, prog_tol):
    """(t, f, g, evaluations, failed, saw a finite trial)."""
    f_new, g_new, gtd_new = _trial(fun, x, d, t)
    ls = 1
    saw = math.isfinite(f_new)
    prev = (0.0, f0, gtd0, g0)
    lo = (0.0, f0, gtd0, g0)
    hi = (t, f0, gtd0)
    bracketed = done = failed = False
    while True:
        armijo = f_new > f0 + c1 * t * gtd0
        wolfe_ok = abs(gtd_new) <= -c2 * gtd0
        newly = False
        if not bracketed:
            rejected = armijo or (ls > 1 and f_new >= prev[1])
            if rejected or (not wolfe_ok and gtd_new >= 0):
                lo, hi, newly = prev, (t, f_new, gtd_new), True
            elif wolfe_ok:
                done = True
        else:
            rejected = armijo or f_new >= lo[1]
            done = not rejected and wolfe_ok
            flip = gtd_new * (hi[0] - lo[0]) >= 0
            old_lo = lo
            if rejected:
                hi = (t, f_new, gtd_new)
            elif flip:
                hi = old_lo[:3]
            if not rejected:
                lo = (t, f_new, gtd_new, g_new)
            stall = (math.isfinite(f_new)
                     and abs(gtd_new) * abs(hi[0] - lo[0]) < prog_tol)
            failed = not done and stall
        was_bracketing = not bracketed
        bracketed = bracketed or newly
        if bracketed:
            a, b = min(lo[0], hi[0]), max(lo[0], hi[0])
            t_next = _cubic_min(lo[0], lo[1], lo[2], hi[0], hi[1], hi[2],
                                a, b)
            t_next = min(max(t_next, a + 0.1 * (b - a)), b - 0.1 * (b - a))
            if not math.isfinite(hi[1]):
                t_next = 0.5 * (a + b)
        else:
            t_next = _cubic_min(prev[0], prev[1], prev[2], t, f_new, gtd_new,
                                t + 0.01 * (t - prev[0]), 10.0 * t)
            if not math.isfinite(f_new):
                t_next = 0.5 * t
        if was_bracketing and not newly and not done:
            prev = (t, f_new, gtd_new, g_new)
        if done or failed or ls >= max_ls:
            break
        t = t_next
        f_new, g_new, gtd_new = _trial(fun, x, d, t)
        ls += 1
        saw = saw or math.isfinite(f_new)
        if not bracketed and ls >= max_ls:
            break
    if done:
        return t, f_new, g_new, ls, False, saw
    if lo[1] < f0 and lo[0] > 0:
        return lo[0], lo[1], lo[3], ls, False, saw
    return 0.0, f0, g0, ls, True, saw


def _direction(g, S, Y, hdiag):
    if not S:
        return -hdiag * g
    rho = [1.0 / float(s @ y) if float(s @ y) > 1e-30 else 0.0
           for s, y in zip(S, Y)]
    q = g.clone()
    al = [0.0] * len(S)
    for j in reversed(range(len(S))):
        al[j] = rho[j] * float(S[j] @ q)
        q = q - al[j] * Y[j]
    r = hdiag * q
    for j in range(len(S)):
        b = rho[j] * float(Y[j] @ r)
        r = r + (al[j] - b) * S[j]
    return -r


def minimize(fun, x0, iterations, *, c1=1e-4, c2=0.9, max_ls=25,
             prog_tol=1e-9, opt_tol=1e-5, history=100):
    """`iterations` iterations from x0 (a float64 device tensor), or fewer
    where the optimizer stops: (iterates x_0.., values f_0.., the
    gradient at x0, evaluations)."""
    x = x0
    f, g = fun(x)
    xs, fs, g0, evals = [x], [f], g, 1
    S, Y, hdiag, restarted = [], [], 1.0, False
    for it in range(iterations):
        d = _direction(g, S, Y, hdiag)
        gtd = float(g @ d)
        bad = not bool(torch.isfinite(d).all()) or gtd >= 0
        fallback = bad and bool(S)
        if bad:
            d, gtd = -g, -float(g @ g)
        if fallback:
            S, Y, hdiag = [], [], 1.0
        if gtd >= 0:
            break
        t0 = (min(1.0, 1.0 / float(g.abs().sum()))
              if it == 0 or restarted or fallback else 1.0)
        t, f_new, g_new, n_ls, failed, saw = wolfe(
            fun, x, f, g, d, gtd, t0, c1, c2, max_ls, prog_tol)
        evals += n_ls
        s = t * d
        y = g_new - g
        ys = float(y @ s)
        if ys > 1e-10 and not failed:
            S.append(s)
            Y.append(y)
            S, Y = S[-history:], Y[-history:]
            hdiag = ys / float(y @ y)
        soft = failed and bool(S)
        if soft:
            S, Y, hdiag = [], [], 1.0
        x_new = x + s
        stop = ((not soft and (abs(f - f_new) < prog_tol
                               or float(s.abs().max()) <= prog_tol))
                or float(g_new.abs().max()) <= opt_tol
                or (failed and not soft))
        x, f, g, restarted = x_new, f_new, g_new, soft
        xs.append(x)
        fs.append(f)
        if stop:
            break
    return xs, fs, g0, evals
