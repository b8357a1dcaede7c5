"""Training jobs: whole `gpz_tpu_torch.model.train` runs, one after
another, each from the same initial model on the same data, so every job
does the same work. The window runs until the job in progress when it
expires has ended.

The mix's file gives each job's iteration cap (`max_iter`, null: the
configuration's). Set-up draws the problem from the seed, builds the
initial model with `init`, and drives it through its first iterations by
the window's own call (a job capped at the cell's `steps`). Every job,
set-up's and the window's, has each evaluation the optimizer asks for
recorded. The check holds the initial model to the reference's `init`,
and each job's first `steps` iterations (for a job of no more iterations,
the whole job): its values, its first gradient and its parameters'
change, to the reference's objective and optimizer followed from the
same start.
"""

from __future__ import annotations

import time
import types

import numpy as np
import torch

from gpzbench import data, faults
from gpzbench.reference import gpz as ref, lbfgs as ref_lbfgs

#: a leaf whose reference gradient is under this share of the median
#: leaf's moves by round-off alone, and is left out of the step's gap
STILL_LEAF = 1e-3


class _Recorder:
    """The optimizer's requests of the objective that model.train builds:
    each evaluation's point, value and gradient, on the host."""

    def __init__(self):
        self.x, self.f, self.g = [], [], []

    def __call__(self, real):
        def make(*args):
            fun = real(*args)

            def recorded(flat):
                f, g, aux = fun(flat)
                self.x.append(flat.detach().to("cpu", torch.float64).numpy())
                self.f.append(float(f))
                self.g.append(g.detach().to("cpu", torch.float64).numpy())
                return f, g, aux
            return recorded
        return make


def _job(state, max_iter):
    c = state.cfg
    X, Y, psi, tr, va = state.problem
    return state.train(state.model0, X, Y, training=tr, validation=va,
                       psi=psi, max_iter=max_iter,
                       max_attempts=c["max_attempts"], verbose=False)


def setup(ctx):
    import gpz_tpu_torch as g
    from gpz_tpu_torch.ops import vc_phi

    cfg, mix = ctx.cell.cfg, ctx.cell.traffic
    problem = data.training_problem(cfg, ctx.seed)
    X, Y, psi, tr, va = problem
    if ctx.device.type == "cuda":
        vc_phi.library()
    model0 = g.init(X, Y, cfg["method"], cfg["m"], heteroscedastic=True,
                    training=tr, psi=psi, seed=data.init_seed(ctx.seed),
                    dtype=cfg["param_dtype"],
                    solve_dtype=(faults.TRAIN_CONTROL_SOLVE if ctx.control
                                 else "auto"),
                    device=ctx.device)
    state = types.SimpleNamespace(
        ctx=ctx, cfg=cfg, problem=problem, model0=model0, train=g.train,
        x0=ref.flatten(model0.last.params.to_numpy()),
        max_iter=mix["max_iter"] or cfg["max_iter"])
    state.first = _recorded_job(state, ctx.cell.spec["steps"])[1]
    return state


def _iterates(rec, trace, x0):
    """The job's iterates x_0.. from its recorded evaluations: the iterate
    of step k is the last evaluation of the step whose value the trace
    kept."""
    f, fevals = np.asarray(trace["f"]), np.asarray(trace["fevals"])
    xs = [x0]
    for k in range(1, len(f)):
        hit = [e for e in range(int(fevals[k]))
               if rec.f[e] == f[k]] if k < len(fevals) else []
        xs.append(rec.x[hit[-1]] if hit else xs[-1])
    return xs


def _recorded_job(state, max_iter):
    """One job with its evaluations recorded: (its fit, and what the check
    reads of it: values f_0..f_k, the parameters x_k after k = min(steps,
    max_iter) iterations, the first gradient)."""
    from gpz_tpu_torch import model as gm

    k = min(state.ctx.cell.spec["steps"], max_iter)
    rec = _Recorder()
    real = gm._objective
    gm._objective = rec(real)
    try:
        fit = _job(state, max_iter)
    finally:
        gm._objective = real
    trace = fit.fit_info["trace"]
    xs = _iterates(rec, trace, state.x0)
    seen = types.SimpleNamespace(
        k=k, f=np.asarray(trace["f"][:k + 1], np.float64),
        x=xs[min(k, len(xs) - 1)], g0=rec.g[0] if rec.g else None)
    return fit, seen


def window(state, seconds, span):
    cuda = state.ctx.device.type == "cuda"
    rec = types.SimpleNamespace(jobs=[], seen=[], attempted=0, failed=0,
                                window_s=0.0, iterations=0, fun_evals=0)
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        rec.attempted += 1
        with span("gpzbench.job"):
            fit, seen = _recorded_job(state, state.max_iter)
            if cuda:
                torch.cuda.synchronize()
        info = fit.fit_info
        rec.jobs.append({"iterations": info["iterations"],
                         "fun_evals": info["fun_evals"],
                         "status": info["status"],
                         "seconds": info["seconds"]})
        rec.seen.append(seen)
        rec.iterations += info["iterations"]
        rec.fun_evals += info["fun_evals"]
        del fit
    rec.window_s = time.perf_counter() - t0
    if cuda:
        rec.peak_bytes = torch.cuda.max_memory_allocated()
    return rec


def end_to_end(state, rec):
    out = {"train_iters_per_s": rec.iterations / rec.window_s}
    if hasattr(rec, "peak_bytes"):
        out["train_peak_gib"] = rec.peak_bytes / 2**30
    return out


def _by_leaf(got, want, slices, keep=None):
    """The worst leaf's | |got_leaf| - |want_leaf| |, each over the larger
    of |want_leaf| and the median leaf's |want|; leaves in `keep` only."""
    norms = {n: np.linalg.norm(want[s]) for n, s in slices.items()}
    median = float(np.median(list(norms.values())))
    gaps = [abs(np.linalg.norm(got[s]) - norms[n]) / max(norms[n], median)
            for n, s in slices.items() if keep is None or n in keep]
    return float(max(gaps))


def check(state, rec):
    """init_gap: the worst leaf's largest |x0 - x0_ref| over its largest
    |x0_ref|, the reference's init stored in the configuration's type;
    and, over set-up's job and every job of the window, each followed for
    its first `steps` iterations (the whole job where it has no more):
    loss_gap, the largest |f_k - f_ref_k| / |f_ref_k| of its steps;
    grad_gap, its first gradient by the worst leaf; step_gap, its
    parameters' change over those steps by the worst leaf, leaves that
    the reference's gradient leaves still (STILL_LEAF) left out."""
    cfg, spec = state.cfg, state.ctx.cell.spec
    device = state.ctx.device
    X, Y, psi, tr, _ = state.problem
    del state.model0
    if device.type == "cuda":
        torch.cuda.empty_cache()
    m, d, k = cfg["m"], cfg["d"], 1
    slices = ref.leaf_slices(m, d, k)
    p_ref, stats = ref.init_vc(X, Y, psi, tr, m, data.init_seed(state.ctx.seed),
                               device)
    x0_ref = ref.flatten(p_ref).astype(cfg["param_dtype"]).astype(np.float64)
    init_gap = max(
        float(np.max(np.abs(state.x0[s] - x0_ref[s])))
        / max(float(np.max(np.abs(x0_ref[s]))), 1e-300)
        for s in slices.values())
    prob = ref.Problem(X, Y, psi, tr, stats, device)
    steps = spec["steps"]
    xs, fs, g0, _ = ref_lbfgs.minimize(
        lambda x: ref.nlml_grad(x, prob, m, d, k),
        torch.as_tensor(state.x0, dtype=torch.float64, device=device), steps)
    fs = np.asarray(fs)
    g0 = g0.cpu().numpy()
    median = float(np.median([np.linalg.norm(g0[s])
                              for s in slices.values()]))
    moving = {n for n, s in slices.items()
              if np.linalg.norm(g0[s]) >= STILL_LEAF * median}
    loss_gap = grad_gap = step_gap = 0.0
    for seen in [state.first] + rec.seen:
        # a job that stopped before step k keeps its last value and point
        f = np.concatenate([seen.f, np.full(seen.k + 1 - len(seen.f),
                                            seen.f[-1])])
        n = min(len(f), len(fs))
        loss_gap = max(loss_gap, float(np.max(np.abs(f[:n] - fs[:n])
                                              / np.abs(fs[:n]))))
        grad_gap = max(grad_gap, _by_leaf(seen.g0, g0, slices)
                       if seen.g0 is not None else float("inf"))
        x_ref = xs[min(seen.k, len(xs) - 1)].cpu().numpy()
        step_gap = max(step_gap, _by_leaf(seen.x - state.x0,
                                          x_ref - state.x0, slices, moving))
    limits = spec["limits"]
    return [("init_gap", init_gap, limits["init_gap"]),
            ("loss_gap", loss_gap, limits["loss_gap"]),
            ("grad_gap", grad_gap, limits["grad_gap"]),
            ("step_gap", step_gap, limits["step_gap"])]
