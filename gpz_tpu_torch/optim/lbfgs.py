"""L-BFGS with strong-Wolfe line search and early stopping
(gpz_tpu.optim.lbfgs): a host loop around device evaluations.

The iterate, the gradient and the curvature history are tensors on the
objective's device; the control flow and every scalar of the search (steps,
function values, directional derivatives) live on the host as float64, so a
float64 run takes the branches gpz_tpu's compiled loop takes:

  * two-loop recursion over a fixed-size circular history buffer
    (ref minFunc/lbfgsProd.m, lbfgsAdd.m)
  * curvature-pair skip rule y's > 1e-10 and Hdiag = ys/yy scaling
    (ref lbfgsAdd.m:5-29)
  * strong-Wolfe bracketing + zoom with cubic interpolation
    (ref minFunc/WolfeLineSearch.m:50-241, polyinterp.m), with non-finite
    trial values treated as +inf so the search backtracks, the role of the
    reference's Armijo fallback (WolfeLineSearch.m:53-69)
  * termination on max|g| <= optTol, step/function progress <= progTol,
    maxIter (ref minFunc.m:96-97,1118-1147)
  * validation-score early stopping with best-iterate tracking
    (ref GPz/callBack.m:26-34, train.m:5-9)

The objective `fun` maps a flat parameter vector to (f, grad, aux); `score_fn`
maps (x, aux) to (score, extras) where higher score is better (the
reference's validation log-likelihood). Per-iteration scalars are recorded in
trace arrays (the reference's printed iteration table, callBack.m:16-46).

One optimization is a lane: a generator (`_lane`) that holds the whole
L-BFGS state machine and, instead of calling anything, yields its requests
to a driver: a point to evaluate, the raw (score, extras) of a point to
score, or a bundle of 0-d tensors to read to the host. `minimize` drives one
lane and answers each request as it comes. `minimize_batched` drives R lanes
in lockstep (gpz_tpu's `jax.vmap(minimize)`): it answers every lane's read
in one transfer, scores every lane that ends an iteration together in one
call, and evaluates every unfinished lane's pending trial in one call of a
batched objective, so a run makes max(fun_evals) objective calls. A lane
computes exactly what it computes alone, so its result is that of
`minimize` on its start; a finished lane leaves the batch.

Each objective evaluation reads three scalars from the device in one
transfer (f, whether the gradient is finite, the directional derivative);
each iteration reads two more small bundles (direction test, curvature pair)
and, with a score, one more.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from gpz_tpu_torch.trace import count, span

# status codes
STATUS_RUNNING = 0
STATUS_OPTIMAL = 1          # max|g| <= opt_tol
STATUS_STEP_TOO_SMALL = 2   # progress below prog_tol
STATUS_MAX_ITER = 3
STATUS_EARLY_STOP = 4       # validation attempts exhausted
STATUS_LS_FAILED = 5        # line search could not find a step
STATUS_NO_DESCENT = 6       # directional derivative above -prog_tol
STATUS_PLATEAU = 7          # gpz_tpu's patience exit; never returned here

_F = np.float64

# the requests a lane makes of its driver, and the span of each answer
_EVAL, _READ, _SCORE = "eval", "read", "score"
_SPANS = {_EVAL: "gpz.lbfgs.eval", _READ: "gpz.lbfgs.read",
          _SCORE: "gpz.lbfgs.score"}


@dataclasses.dataclass
class MinimizeResult:
    x: torch.Tensor            # final iterate
    f: float
    x_best: torch.Tensor       # best-scoring iterate (== x if no score_fn)
    best_score: float
    iterations: int
    fun_evals: int
    status: int
    trace: dict                # per-iteration arrays of length iterations + 1


def _scalars(*tensors) -> list:
    """0-d tensors (or host numbers) to float64 host scalars, in one
    transfer from the device of the first tensor among them."""
    count("reads.lbfgs")
    dev = next((t.device for t in tensors if isinstance(t, torch.Tensor)),
               "cpu")
    return [_F(v) for v in torch.stack(
        [torch.as_tensor(t, device=dev).detach().to(torch.float64).reshape(())
         for t in tensors]).tolist()]


def _cubic_min(x1, f1, g1, x2, f2, g2, lo, hi):
    """Minimizer of the cubic interpolating (x, f, f') at two points,
    clamped to [lo, hi]; bisects when the interpolation is ill-posed
    (ref minFunc/polyinterp.m closed form for the 2-point case)."""
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2)
    rad = d1 * d1 - g1 * g2
    sq = np.sqrt(np.maximum(rad, 0.0))
    sq = -sq if x2 < x1 else sq
    denom = g2 - g1 + 2 * sq
    t = x2 - (x2 - x1) * (g2 + sq - d1) / denom
    if rad < 0 or not np.isfinite(t) or abs(denom) < 1e-30:
        t = 0.5 * (lo + hi)
    return np.minimum(np.maximum(t, lo), hi)


def wolfe_line_search(x, f0, g0, d, gtd0, t0, c1, c2, max_ls, prog_tol,
                      aux0):
    """Strong-Wolfe line search (ref minFunc/WolfeLineSearch.m), as a
    generator of a lane's requests (module docstring).

    Returns (t, f, g, aux, n_evals, failed, saw_finite). On failure t == 0
    and the initial point is returned.

    One loop with a single objective call site, as in gpz_tpu: each pass
    classifies the previously evaluated trial under the rules of the current
    phase (bracketing: WolfeLineSearch.m:50-119; zoom: :135-241), proposes
    the next trial (cubic extrapolation / safeguarded cubic interpolation)
    and evaluates it. A bracketing trial evaluated on the last budgeted
    iteration is left unclassified (minFunc's bracket loop exits on LSiter
    before processing it), while zoom trials are always classified.
    `gtd0` is the directional derivative g0 . d, as a host scalar.
    """
    f0, t0, gtd0 = _F(f0), _F(t0), _F(gtd0)

    def eval_at(t):
        f, g, aux = yield _EVAL, x + float(t) * d
        # non-finite trial f OR g reads as +inf with a zeroed gradient: the
        # search then backtracks, playing the role of minFunc's isLegal +
        # Armijo fallback (WolfeLineSearch.m:53 checks BOTH f and g)
        f, g_ok, gtd = yield _READ, (f, torch.isfinite(g).all(),
                                     torch.dot(g, d))
        if not np.isfinite(f) or not g_ok:
            return _F(np.inf), torch.zeros_like(g), aux, _F(0.0)
        return f, g, aux, gtd

    zero = _F(0.0)
    t = t0
    f_new, g_new, aux_new, gtd_new = f0, g0, aux0, gtd0   # placeholders
    t_prev, f_prev, gtd_prev, g_prev, aux_prev = zero, f0, gtd0, g0, aux0
    ls_iter = 0
    done = bracketed = failed = saw_finite = unprocessed = False
    pending = True
    t_lo, f_lo, gtd_lo, g_lo, aux_lo = zero, f0, gtd0, g0, aux0
    t_hi, f_hi, gtd_hi = t0, f0, gtd0

    while (not done) and (not failed) and (
        pending or (unprocessed and (bracketed or ls_iter < max_ls))
    ):
        proc = not pending            # there is an eval to classify
        in_brk = not bracketed

        # ---- classify the last trial under the current phase's rules ----
        armijo0 = f_new > f0 + c1 * t * gtd0
        wolfe_ok = abs(gtd_new) <= -c2 * gtd0

        # bracketing rules (WolfeLineSearch.m:50-119)
        af_b = armijo0 or (ls_iter > 1 and f_new >= f_prev)
        newly = proc and in_brk and (af_b or (not wolfe_ok and gtd_new >= 0))
        done_b = proc and in_brk and not af_b and wolfe_ok

        # zoom rules (WolfeLineSearch.m:135-241)
        af_z = armijo0 or f_new >= f_lo
        zoom_proc = proc and not in_brk
        done_z = zoom_proc and not af_z and wolfe_ok
        flip = gtd_new * (t_hi - t_lo) >= 0

        done = done_b or done_z

        # bracket set on the bracketing->zoom transition: [prev, new]
        old_lo = (t_lo, f_lo, gtd_lo)
        if newly:
            t_lo, f_lo, gtd_lo, g_lo, aux_lo = (
                t_prev, f_prev, gtd_prev, g_prev, aux_prev)
            t_hi, f_hi, gtd_hi = t, f_new, gtd_new

        # zoom bracket updates: hi <- t on Armijo failure, else old lo when
        # the derivative sign flips; lo <- t unless Armijo failed
        if zoom_proc and af_z:
            t_hi, f_hi, gtd_hi = t, f_new, gtd_new
        elif zoom_proc and flip:
            t_hi, f_hi, gtd_hi = old_lo
        if zoom_proc and not af_z:
            t_lo, f_lo, gtd_lo, g_lo, aux_lo = (
                t, f_new, gtd_new, g_new, aux_new)

        # zoom give-up when the bracket can no longer make progress, only on
        # a finite trial: a non-finite trial carries a zeroed gradient, and
        # |0|*width < prog_tol would abort instantly
        stall = bool(np.isfinite(f_new)) and (
            abs(gtd_new) * abs(t_hi - t_lo) < prog_tol)
        failed = zoom_proc and not done_z and stall

        bracketed = bracketed or newly

        # ---- propose the next trial ----
        if pending:
            t_next = t
        elif bracketed:
            # zoom: safeguarded cubic interpolation on the updated bracket,
            # kept strictly interior; midpoint when hi is non-finite
            lo_b = np.minimum(t_lo, t_hi)
            hi_b = np.maximum(t_lo, t_hi)
            width = hi_b - lo_b
            t_next = _cubic_min(t_lo, f_lo, gtd_lo, t_hi, f_hi, gtd_hi,
                                lo_b, hi_b)
            t_next = np.minimum(np.maximum(t_next, lo_b + 0.1 * width),
                                hi_b - 0.1 * width)
            if not np.isfinite(f_hi):
                t_next = 0.5 * (lo_b + hi_b)
        else:
            # bracketing: cubic extrapolation in [t + 0.01 (t - t_prev), 10 t]
            min_step = t + 0.01 * (t - t_prev)
            max_step = t * 10.0
            t_next = _cubic_min(t_prev, f_prev, gtd_prev, t, f_new, gtd_new,
                                min_step, max_step)
            if not np.isfinite(f_new):
                t_next = t * 0.5

        # bracketing shift prev <- current when continuing the extrapolation
        if proc and in_brk and not newly and not done:
            t_prev, f_prev, gtd_prev, g_prev, aux_prev = (
                t, f_new, gtd_new, g_new, aux_new)

        # ---- the single objective call site ----
        do_eval = (not done) and (not failed) and ls_iter < max_ls
        if do_eval:
            t = _F(t_next)
            f_new, g_new, aux_new, gtd_new = yield from eval_at(t)
            ls_iter += 1
            saw_finite = saw_finite or bool(np.isfinite(f_new))
        pending = False
        unprocessed = do_eval

    # the Wolfe point if done; else bracket-lo if it improves on f0; else fail
    if done:
        return t, f_new, g_new, aux_new, ls_iter, False, saw_finite
    if f_lo < f0 and t_lo > 0:
        return t_lo, f_lo, g_lo, aux_lo, ls_iter, False, saw_finite
    return zero, f0, g0, aux0, ls_iter, True, saw_finite


def _lbfgs_direction(g, S, Yb, count, pos, hdiag, history):
    """Two-loop recursion on the circular (history, p) buffers
    (ref minFunc/lbfgsProd.m:19-32, mex/lbfgsProdC.c:46-88)."""
    if count == 0:
        return -(hdiag * g)
    sy = (S * Yb).sum(dim=1)
    rho = torch.where(sy > 1e-30, 1.0 / sy, torch.zeros_like(sy))
    q = g
    al = [None] * history
    for i in range(count):
        j = (pos - 1 - i) % history
        al[j] = rho[j] * torch.dot(S[j], q)
        q = q - al[j] * Yb[j]
    r = hdiag * q
    for i in range(count):
        j = (pos - count + i) % history
        b = rho[j] * torch.dot(Yb[j], r)
        r = r + (al[j] - b) * S[j]
    return -r


def minimize(
    fun: Callable,
    x0: torch.Tensor,
    *,
    history: int = 100,
    max_iter: int = 200,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 25,
    score_fn: Optional[Callable] = None,
    max_attempts: Optional[int] = None,
    init_best_score: Optional[float] = None,
    x_best0: Optional[torch.Tensor] = None,
    iter_callback: Optional[Callable] = None,
) -> MinimizeResult:
    """Minimize fun(x) -> (f, g, aux) by L-BFGS with strong-Wolfe search.

    score_fn(x, aux) -> (score, extras): higher-is-better model-selection
    score (the reference's validation LL), extras a dict of scalars.
    `x_best` tracks the argmax-score iterate; `max_attempts` successive
    non-improving iterations trigger early stopping (ref GPz/callBack.m:26-34;
    improvement uses >=, matching the reference).

    `init_best_score` / `x_best0`: continuation (ref train.m:8-11 +
    callBack.m:26-34). A caller that provides the previous best score
    provides the matching previous best parameters too; otherwise a run that
    never beats the old score would return x0 as "best" while keeping the old
    (better) score.

    `iter_callback(it, f, opt_cond, step, score, improved, extras)` is called
    once per iteration, iteration 0 included (the live version of the
    reference's per-iteration table, ref GPz/callBack.m:16-46).
    """
    lane = _lane(x0, int(history), int(max_iter), opt_tol, prog_tol, c1, c2,
                 int(max_ls), score_fn is not None, _cap(max_attempts),
                 init_best_score, x_best0, iter_callback)
    with torch.no_grad(), np.errstate(all="ignore"):
        request = next(lane)
        while True:
            kind = request[0]
            with span(_SPANS[kind]):
                if kind == _EVAL:
                    reply = fun(request[1])
                elif kind == _SCORE:
                    reply = score_fn(request[1], request[2])
                else:
                    reply = _scalars(*request[1])
            try:
                request = lane.send(reply)
            except StopIteration as stop:
                return stop.value


def minimize_batched(
    fun: Callable,
    x0s: torch.Tensor,
    *,
    history: int = 100,
    max_iter: int = 200,
    opt_tol: float = 1e-5,
    prog_tol: float = 1e-9,
    c1: float = 1e-4,
    c2: float = 0.9,
    max_ls: int = 25,
    score_fn: Optional[Callable] = None,
    max_attempts=None,
    init_best_score=None,
    x_best0: Optional[torch.Tensor] = None,
) -> List[MinimizeResult]:
    """`minimize` of R starts x0s (R, p) at once, the counterpart of
    gpz_tpu's `jax.vmap(minimize)`: a list of R MinimizeResults, lane r's
    equal to `minimize` from x0s[r] with a single-point objective that
    computes what fun computes for a row.

    fun(X (B, p)) -> (f (B,), g (B, p), aux), aux a tensor, a dataclass, a
    tuple or a list whose tensors carry a leading axis B (objective.Aux of
    nlog_ml_batched); score_fn(X (B, p), aux) -> (score (B,), extras {name:
    (B,)}). Every call covers the lanes that want one: fun is called once
    per round with the pending trial of every unfinished lane, max(fun_evals)
    times in all; a finished lane is not evaluated again. score_fn is called
    once for the lanes that end an iteration in the same round. X's rows
    start on 512-byte boundaries (`_rows`), as a lone point's storage does.

    `max_attempts` and `init_best_score`: None, one value for every lane, or
    a sequence of R; `x_best0`: None or (R, p). Each as in `minimize`, per
    lane.
    """
    R = x0s.shape[0]
    caps = [_cap(a) for a in _per_lane(max_attempts, R)]
    floors = _per_lane(init_best_score, R)
    bests = [None] * R if x_best0 is None else list(x_best0)
    lanes = [_lane(x0s[r], int(history), int(max_iter), opt_tol, prog_tol,
                   c1, c2, int(max_ls), score_fn is not None, caps[r],
                   floors[r], bests[r], None) for r in range(R)]
    results = [None] * R
    requests = {}

    def advance(r, reply):
        try:
            requests[r] = lanes[r].send(reply)
        except StopIteration as stop:
            results[r] = stop.value
            del requests[r]

    with torch.no_grad(), np.errstate(all="ignore"):
        for r in range(R):
            requests[r] = next(lanes[r])
        while requests:
            # reads first, then scores: lanes ending an iteration in the same
            # round reach their score together, and every lane's next
            # request is then an evaluation
            kind = next(k for k in (_READ, _SCORE, _EVAL)
                        if any(q[0] == k for q in requests.values()))
            ids = [r for r, q in requests.items() if q[0] == kind]
            with span(_SPANS[kind]):
                replies = _answer(kind, [requests[r] for r in ids], fun,
                                  score_fn)
            for r, reply in zip(ids, replies):
                advance(r, reply)
    return results


def _answer(kind, requests, fun, score_fn) -> list:
    """The replies to lanes' requests of one kind: their reads in one
    transfer, their points in one call of fun or score_fn."""
    if kind == _READ:
        vals = _scalars(*(t for q in requests for t in q[1]))
        replies, at = [], 0
        for q in requests:
            replies.append(vals[at:at + len(q[1])])
            at += len(q[1])
        return replies
    X = _rows([q[1] for q in requests])
    if kind == _SCORE:
        score, extras = score_fn(X, _tree(lambda *ts: torch.stack(ts),
                                          *(q[2] for q in requests)))
        return [(score[j], {k: v[j] for k, v in extras.items()})
                for j in range(len(requests))]
    f, g, aux = fun(X)
    # a lane's gradient in storage of its own, as alone
    return [(f[j], g[j].clone(), _tree(lambda t: t[j], aux))
            for j in range(len(requests))]


def _rows(vectors) -> torch.Tensor:
    """The lanes' (p,) vectors as the rows of a (B, p) tensor whose rows
    start on 512-byte boundaries, as a vector allocated alone does: a CUDA
    kernel's vectorized loads, and with them its order of summation, depend
    on the alignment of its operands, so a lane's slices of the batch must
    be aligned as its own vector would be."""
    p = vectors[0].shape[0]
    per = max(1, 512 // vectors[0].element_size())
    buf = vectors[0].new_empty((len(vectors), -(-p // per) * per))
    buf[:, :p] = torch.stack(vectors)
    return buf[:, :p]


def _cap(max_attempts) -> int:
    return 2**31 - 1 if max_attempts is None else int(max_attempts)


def _per_lane(value, R: int) -> list:
    """None or one value for every lane, else a sequence of R."""
    if value is None or np.ndim(value) == 0:
        return [value] * R
    value = list(value)
    if len(value) != R:
        raise ValueError(f"{len(value)} values for {R} lanes")
    return value


def _tree(fn, *trees):
    """fn over the tensors at the same place in `trees` (tensors,
    dataclasses, tuples and lists of them); anything else is taken from the
    first tree."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            fl.name: _tree(fn, *(getattr(t, fl.name) for t in trees))
            for fl in dataclasses.fields(first)})
    if isinstance(first, (tuple, list)):
        return type(first)(_tree(fn, *items) for items in zip(*trees))
    return first


def _lane(x0, history, max_iter, opt_tol, prog_tol, c1, c2, max_ls, scored,
          attempts_cap, init_best_score, x_best0, iter_callback):
    """One optimization as a generator of requests (module docstring):
    (_EVAL, x) is answered by fun(x)'s (f, g, aux), (_SCORE, x, aux) by
    score_fn(x, aux)'s (score, extras), (_READ, tensors) by their values as
    float64 host scalars. Returns the MinimizeResult."""
    def score_of(x, f, aux):
        if not scored:
            return -f, {}
        score, extras = yield _SCORE, x, aux
        names = list(extras)
        vals = yield _READ, (score, *(extras[n] for n in names))
        return vals[0], dict(zip(names, vals[1:]))

    p = x0.shape[0]
    x = x0.detach()
    f, g, aux = yield _EVAL, x
    g = g.detach()
    f, g_ok, opt_cond = yield _READ, (f, torch.isfinite(g).all(),
                                      g.abs().max())
    score, extras = yield from score_of(x, f, aux)
    if init_best_score is None:
        init_best_score = -np.inf
    init_best_score = _F(init_best_score)
    if x_best0 is None:
        x_best0 = x

    trace = {"f": [], "opt_cond": [], "step": [], "score": [], "fevals": [],
             "extras": {name: [] for name in extras}}

    def record(f, opt_cond, step, score, fevals, extras, it, improved):
        trace["f"].append(f)
        trace["opt_cond"].append(opt_cond)
        trace["step"].append(step)
        trace["score"].append(score)
        trace["fevals"].append(fevals)
        for name, v in extras.items():
            trace["extras"][name].append(v)
        if iter_callback is not None:
            iter_callback(it, f, opt_cond, step, score, improved, extras)

    # best tracking starts from the provided floor (model.best.LL,
    # train.m:8-9)
    improved0 = bool(score >= init_best_score)
    record(f, opt_cond, _F(0.0), score, 1, extras, 0, improved0)
    best_x = x if improved0 else x_best0.detach()
    best_score = score if improved0 else init_best_score

    S = torch.zeros((history, p), dtype=x.dtype, device=x.device)
    Yb = torch.zeros((history, p), dtype=x.dtype, device=x.device)
    count = pos = it = attempts = 0
    hdiag = _F(1.0)
    fevals = 1
    restarted = False

    status = STATUS_RUNNING
    if opt_cond <= opt_tol:
        status = STATUS_OPTIMAL
    # a non-finite objective at the starting point poisons every Armijo /
    # curvature comparison (NaN compares false), so the search would burn its
    # whole max_ls budget learning nothing: exit immediately. Trial-point
    # non-finiteness stays handled inside the line search (backtracking).
    if not np.isfinite(f) or not g_ok:
        status = STATUS_LS_FAILED

    while status == STATUS_RUNNING and it < max_iter:
        d = _lbfgs_direction(g, S, Yb, count, pos, float(hdiag), history)
        # fall back to steepest descent when the quasi-Newton direction is
        # non-finite (minFunc isLegal, minFunc.m:963) or fails the descent
        # test (minFunc.m:972-980), and reset the curvature memory. ">= 0"
        # and not "> -prog_tol": a direction with tiny-but-negative gtd is
        # the normal near-convergence regime, not a breakdown.
        d_ok, gtd, g_l1, g_sq = yield _READ, (
            torch.isfinite(d).all(), torch.dot(g, d), g.abs().sum(),
            torch.dot(g, g))
        d_bad = (not d_ok) or bool(gtd >= 0)
        fallback = d_bad and count > 0
        if d_bad:
            d, gtd = -g, -g_sq
        if fallback:
            count, pos, hdiag = 0, 0, _F(1.0)
        # terminal only when even steepest descent is non-descent (g zero or
        # non-finite)
        no_descent = bool(gtd >= 0)

        # step init (minFunc.m:983-1023): first iter t = min(1, 1/sum|g|);
        # same rescale after a memory reset
        if it == 0 or restarted or fallback:
            t0 = np.minimum(_F(1.0), _F(1.0) / g_l1)
        else:
            t0 = _F(1.0)

        t, f_new, g_new, aux_new, ls_evals, ls_failed, saw_finite = (
            yield from wolfe_line_search(x, f, g, d, gtd, t0, c1, c2, max_ls,
                                         prog_tol, aux))
        g_new = g_new.detach()
        sk = float(t) * d
        x_new = x + sk

        # a failed search with curvature memory in play: discard the memory
        # and retry from steepest descent next iteration. Terminal only when
        # steepest descent itself cannot find a step, and then the code says
        # why: finite trials that never improved mean the function is flat
        # along -g at working precision; all-non-finite trials are a genuine
        # line-search pathology.
        soft_fail = ls_failed and count > 0
        hard_fail = ls_failed and count == 0

        # curvature update with skip rule (lbfgsAdd.m:5)
        yk = g_new - g
        ys, yy, opt_cond, step_max = yield _READ, (
            torch.dot(yk, sk), torch.dot(yk, yk), g_new.abs().max(),
            sk.abs().max())
        if ys > 1e-10 and not ls_failed:
            S[pos] = sk
            Yb[pos] = yk
            pos = (pos + 1) % history
            count = min(count + 1, history)
            hdiag = ys / yy
        if soft_fail:
            count, pos, hdiag = 0, 0, _F(1.0)

        # scoring / early stopping, skipped on a soft-failed iteration
        # (x unchanged: re-scoring the same point must not reset `attempts`)
        score, extras = yield from score_of(x_new, f_new, aux_new)
        improved = bool(score >= best_score) and not soft_fail
        if improved:
            best_x, best_score = x_new, score
        if not soft_fail:
            attempts = 0 if improved else attempts + 1

        it += 1
        status = STATUS_RUNNING
        if attempts >= attempts_cap:
            status = STATUS_EARLY_STOP
        # progress-based termination only applies to a real accepted step
        if not soft_fail and (abs(f - f_new) < prog_tol
                              or step_max <= prog_tol):
            status = STATUS_STEP_TOO_SMALL
        if opt_cond <= opt_tol:
            status = STATUS_OPTIMAL
        if hard_fail and saw_finite:
            status = STATUS_STEP_TOO_SMALL
        if hard_fail and not saw_finite:
            status = STATUS_LS_FAILED
        if no_descent:
            status = STATUS_NO_DESCENT
        if it >= max_iter and status == STATUS_RUNNING:
            status = STATUS_MAX_ITER

        fevals += ls_evals
        record(f_new, opt_cond, t, score, fevals, extras, it, improved)
        x, f, g, aux = x_new, f_new, g_new, aux_new
        restarted = soft_fail

    if status == STATUS_RUNNING:
        status = STATUS_MAX_ITER
    # with no score_fn, "best" mirrors the reference's trainingOnly callback
    # path: best == last (callBack.m:20-22)
    if not scored:
        best_x, best_score = x, -f
    return MinimizeResult(
        x=x, f=float(f), x_best=best_x, best_score=float(best_score),
        iterations=it, fun_evals=fevals, status=status,
        trace={
            "f": np.asarray(trace["f"], np.float64),
            "opt_cond": np.asarray(trace["opt_cond"], np.float64),
            "step": np.asarray(trace["step"], np.float64),
            "score": np.asarray(trace["score"], np.float64),
            "fevals": np.asarray(trace["fevals"], np.int32),
            "extras": {name: np.asarray(v, np.float64)
                       for name, v in trace["extras"].items()},
        },
    )
