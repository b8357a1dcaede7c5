"""Catalogue serving: one client in a closed loop sends requests of rows
of a catalogue to `gpz_tpu_torch.model.predict` and waits for each.

The mix's file gives the catalogue (pool_rows rows drawn from the seed,
bands lost by `missing`), the request sizes (a fixed cycle of
sizes_cycle sizes evenly spread over request_rows, in an order drawn from
the seed, so every seed sends the same sizes) and the warm-up requests.
Set-up trains the served model to convergence on the configuration's
training problem. Where the cell's file sets `served_model`, a trained
model with a degenerate basis (a precision gamma_j' gamma_j whose
condition number passes `max_basis_cond`) is not served: set-up draws the
training problem again from the seed, at most `draws` times, so that every
seed serves a model of one difficulty. On such a basis the moments are
not determined in float64 (the program and the reference read apart from
each other and from the exact moments alike). The check compares a sample
of the window's answers, drawn from the seed, with the plain reference's
moments.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
import types

import numpy as np
import torch

from gpzbench import data, faults
from gpzbench.reference import gpz as ref


def basis_condition(gamma) -> float:
    """The largest condition number of a basis's precision gamma_j' gamma_j
    over the bases of gamma (m, d, d)."""
    s = np.linalg.svd(np.asarray(gamma, np.float64), compute_uv=False)
    return float(np.max((s[:, 0] / s[:, -1]) ** 2))


def _train_served_model(ctx):
    """(model, training problem, draws made, its basis condition)."""
    import gpz_tpu_torch as g
    from gpz_tpu_torch.ops import vc_phi

    cfg = ctx.cell.cfg
    rule = ctx.cell.spec.get("served_model")
    draws = rule["draws"] if rule else 1
    if ctx.device.type == "cuda":
        vc_phi.library()
    for draw in range(draws):
        X, Y, psi, tr, va = data.training_problem(cfg, ctx.seed, draw)
        model0 = g.init(X, Y, cfg["method"], cfg["m"], heteroscedastic=True,
                        training=tr, psi=psi,
                        seed=data.init_seed(ctx.seed, draw),
                        dtype=cfg["param_dtype"], device=ctx.device)
        model = g.train(model0, X, Y, training=tr, validation=va, psi=psi,
                        max_iter=cfg["max_iter"],
                        max_attempts=cfg["max_attempts"], verbose=False)
        cond = basis_condition(model.best.params.to_numpy()["gamma"])
        if rule is None or cond <= rule["max_basis_cond"]:
            return model, (X, Y, psi, tr), draw + 1, cond
        print(f"served model: draw {draw} has a basis of condition "
              f"{cond:.3e}; drawing again", file=sys.stderr)
    raise RuntimeError(f"no served model within {draws} draws")


def setup(ctx):
    import gpz_tpu_torch as g

    cfg, mix = ctx.cell.cfg, ctx.cell.traffic
    if ctx.control:
        os.environ.update(faults.SERVE_CONTROL_ENV)
    model, problem, draws, cond = _train_served_model(ctx)
    pool_X, pool_psi = data.catalogue(cfg, mix["pool_rows"], mix["missing"],
                                      ctx.seed)
    lo, hi = mix["request_rows"]
    K = mix["sizes_cycle"]
    sizes = lo + (np.arange(K) * (hi - lo)) // (K - 1)
    rng = data.rng_for(ctx.seed, 6)
    state = types.SimpleNamespace(
        ctx=ctx, model=model, problem=problem, pool_X=pool_X,
        pool_psi=pool_psi, sizes=sizes[rng.permutation(K)],
        order=rng.permutation(mix["pool_rows"]),
        best=model.best.params.to_numpy(),
        predict=g.predict, model_draws=draws, basis_cond=cond)
    for size in (hi, lo, (lo + hi) // 2)[:mix["warmup_requests"]]:
        idx = state.order[-size:]
        g.predict(pool_X[idx], model, psi=pool_psi[idx])
    return state


def window(state, seconds, span):
    n_pool = len(state.order)
    rec = types.SimpleNamespace(starts=[], sizes=[], latency=[], mu=[],
                                sigma=[], attempted=0, failed=0, rows=0,
                                observed={}, window_s=0.0,
                                model_draws=state.model_draws,
                                basis_cond=state.basis_cond)
    pos, i = 0, 0
    t0 = time.perf_counter()
    deadline = t0 + seconds
    while time.perf_counter() < deadline:
        size = int(state.sizes[i % len(state.sizes)])
        idx = state.order[(pos + np.arange(size)) % n_pool]
        Xr, pr = state.pool_X[idx], state.pool_psi[idx]
        rec.attempted += 1
        t_send = time.perf_counter()
        try:
            with span("gpzbench.request"):
                pred = state.predict(Xr, state.model, psi=pr)
        except Exception:     # the loop goes on; the request failed
            traceback.print_exc(file=sys.stderr)
            rec.failed += 1
            pred = None
        rec.latency.append(time.perf_counter() - t_send)
        rec.starts.append(pos)
        rec.sizes.append(size)
        rec.mu.append(None if pred is None else pred.mu)
        rec.sigma.append(None if pred is None else pred.sigma)
        if pred is not None:
            rec.rows += size
            obs = np.bincount((~np.isnan(Xr)).sum(axis=1))
            for k, c in enumerate(obs):
                if c:
                    rec.observed[k] = rec.observed.get(k, 0) + int(c)
        pos += size
        i += 1
    rec.window_s = time.perf_counter() - t0
    return rec


def end_to_end(state, rec):
    return {"serve_rows_per_s": rec.rows / rec.window_s,
            "serve_p95_ms": float(np.percentile(rec.latency, 95)) * 1e3}


def check(state, rec):
    """The numbers the cell's limits name, of the sampled rows: mu_err, the
    largest |mu - mu_ref| over the larger of |mu_ref| and the sample's
    median |mu_ref|; sigma_err, the largest |sigma - sigma_ref| /
    sigma_ref."""
    spec = state.ctx.cell.spec
    device = state.ctx.device
    n_pool = len(state.order)
    where = np.concatenate([
        np.stack([np.full(s, r), (p + np.arange(s)) % n_pool, np.arange(s)])
        for r, (p, s) in enumerate(zip(rec.starts, rec.sizes))], axis=1)
    pick = data.rng_for(state.ctx.seed, 5).choice(
        where.shape[1], min(spec["sample_rows"], where.shape[1]),
        replace=False)
    req, pool_pos, at = where[:, pick]
    rows = state.order[pool_pos]
    if any(rec.mu[r] is None for r in req):
        raise RuntimeError("a sampled request returned no answer")
    mu = np.array([rec.mu[r][a, 0] for r, a in zip(req, at)])
    sigma = np.array([rec.sigma[r][a, 0] for r, a in zip(req, at)])
    del state.model
    if device.type == "cuda":
        torch.cuda.empty_cache()
    X, Y, psi, tr = state.problem
    muX, sdX, muY, _, _ = ref.normalise(X, Y[:, None], psi, tr)
    prob = ref.Problem(X, Y, psi, tr, (muX, sdX, muY), device)
    f64 = torch.float64
    best = {k: torch.as_tensor(v, dtype=f64, device=device)
            for k, v in state.best.items()}
    w, iSw, prior = ref.posterior(best, prob)
    Xs = state.pool_X[rows]
    Psi = np.zeros(Xs.shape + (Xs.shape[1],))
    d = np.arange(Xs.shape[1])
    Psi[:, d, d] = state.pool_psi[rows] / sdX ** 2
    out = ref.predict(best, w, iSw, prior, muY,
                      torch.as_tensor((Xs - muX) / sdX, dtype=f64,
                                      device=device),
                      torch.as_tensor(Psi, dtype=f64, device=device))
    mu_r, sigma_r = out["mu"][:, 0], out["sigma"][:, 0]
    floor = np.median(np.abs(mu_r))
    numbers = {
        "mu_err": float(np.max(np.abs(mu - mu_r)
                               / np.maximum(np.abs(mu_r), floor))),
        "sigma_err": float(np.max(np.abs(sigma - sigma_r) / sigma_r)),
    }
    return [(name, numbers[name], limit)
            for name, limit in spec["limits"].items()]
