"""No-U-Turn Sampler (NUTS), iterative formulation (gpz_tpu.inference.nuts).

Multinomial NUTS (Hoffman & Gelman 2014, with multinomial progressive
sampling and biased trajectory merging a la Stan), as gpz_tpu's:

  * per-depth subtree construction is a loop over 2^depth leapfrog leaves
  * within-subtree U-turn checks use the balanced-binary-tree checkpoint
    scheme: at leaf i, levels j with i % 2^j == 0 store (x, p) checkpoints;
    levels with (i+1) % 2^j == 0 check the original position-difference
    criterion (x_end - x_start) . M^-1 p < 0 against their checkpoint
  * progressive multinomial sampling inside subtrees, biased merge across
    doublings, divergence guard at dH > 1000
  * warmup reuses the dual-averaging + diagonal mass adaptation of mcmc

The chains move in lockstep, one batched evaluation per leaf. Each chain has
its own direction bits, its own U-turn and divergence guards and its own
`done`; a leaf of a chain that has stopped leaves its state unchanged.
gpz_tpu under vmap evaluates every one of the 2^max_depth - 1 leaves; here a
doubling, or the transition, ends once every chain has stopped, which reads
the host once per leaf at most and changes no result. Each chain carries the
value and gradient at its proposal, so a leaf is one evaluation and the
transition needs none at its end.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from gpz_tpu_torch.inference.mcmc import (
    _leapfrog, _refuse_axis, _run_chains, collective_mcmc,
)

_DIVERGENCE = 1000.0


class _SubtreeState(NamedTuple):
    x: torch.Tensor           # (C, p) current endpoint position
    p: torch.Tensor           # current endpoint momentum
    grad: torch.Tensor        # grad log p at endpoint
    x_prop: torch.Tensor      # subtree proposal, its logp and gradient
    logp_prop: torch.Tensor   # (C,)
    grad_prop: torch.Tensor
    log_sum_w: torch.Tensor   # log sum of leaf weights in subtree
    sum_accept: torch.Tensor  # sum of min(1, exp(-dH)) for DA
    n_visited: torch.Tensor   # leaves actually evaluated (for the DA average)
    ckpt_x: tuple             # per level j <= depth, (C, p)
    ckpt_p: tuple
    turning: torch.Tensor
    diverged: torch.Tensor


class _Carry(NamedTuple):
    x_left: torch.Tensor
    p_left: torch.Tensor
    grad_left: torch.Tensor
    x_right: torch.Tensor
    p_right: torch.Tensor
    grad_right: torch.Tensor
    x_prop: torch.Tensor
    logp_prop: torch.Tensor
    grad_prop: torch.Tensor
    log_sum_w: torch.Tensor
    sum_accept: torch.Tensor
    n_leaves: torch.Tensor
    depth: torch.Tensor
    done: torch.Tensor
    diverged: torch.Tensor


def _select(keep, old, new):
    """Field by field: where `keep` (C,) the old value, else the new."""
    def sel(a, b):
        if isinstance(a, tuple):
            return tuple(sel(u, v) for u, v in zip(a, b))
        return torch.where(keep.reshape(-1, *(1,) * (a.dim() - 1)), a, b)

    return type(old)(*(sel(a, b) for a, b in zip(old, new)))


def _vdot(a, b):
    return torch.sum(a * b, dim=-1)


def _leaf(logp_fn, s: _SubtreeState, i, n_leaf, eps, inv_mass, h0, u):
    """Leaf i of a subtree of n_leaf leaves, u (C,) its uniforms."""
    x, p, grad, logp = _leapfrog(logp_fn, s.x, s.p, s.grad, eps, inv_mass)
    h = -logp + 0.5 * torch.sum(p * p * inv_mass, dim=-1)
    dh = h - h0
    dh = torch.where(torch.isfinite(dh), dh, math.inf)
    diverged = s.diverged | (dh > _DIVERGENCE)
    log_w = -dh

    # progressive multinomial sampling within the subtree
    log_sum_new = torch.logaddexp(s.log_sum_w, log_w)
    take = torch.log(u) < (log_w - log_sum_new)
    t = take[:, None]

    # checkpoint store: levels j with i % 2^j == 0 record (x, p)
    ckpt_x = tuple(x if i % 2**j == 0 else c for j, c in enumerate(s.ckpt_x))
    ckpt_p = tuple(p if i % 2**j == 0 else c for j, c in enumerate(s.ckpt_p))

    # U-turn checks: levels j with (i+1) % 2^j == 0 and 2^j <= leaves built
    # so far compare against their checkpoint
    turning = s.turning
    v = inv_mass * p
    for j in range(1, len(ckpt_x)):
        if (i + 1) % 2**j == 0 and 2**j <= n_leaf:
            dx = x - ckpt_x[j]
            v0 = inv_mass * ckpt_p[j]
            turning = turning | (_vdot(dx, v0) < 0) | (_vdot(dx, v) < 0)

    return _SubtreeState(
        x=x, p=p, grad=grad,
        x_prop=torch.where(t, x, s.x_prop),
        logp_prop=torch.where(take, logp, s.logp_prop),
        grad_prop=torch.where(t, grad, s.grad_prop),
        log_sum_w=log_sum_new,
        sum_accept=s.sum_accept + torch.clamp(torch.exp(-dh), max=1.0),
        n_visited=s.n_visited + 1,
        ckpt_x=ckpt_x, ckpt_p=ckpt_p,
        turning=turning, diverged=diverged,
    )


def _merge(c: _Carry, sub: _SubtreeState, go_right, u, inv_mass, depth):
    """Join a finished subtree to the trajectory; u (C,) the merge
    uniforms. A chain that was done before the subtree keeps its carry."""
    bad = sub.turning | sub.diverged
    # biased progressive merge (Stan): accept subtree proposal with
    # prob min(1, w_sub / w_tree)
    take = (torch.log(u) < (sub.log_sum_w - c.log_sum_w)) & ~bad
    t, r = take[:, None], go_right[:, None]
    x_left = torch.where(r, c.x_left, sub.x)
    p_left = torch.where(r, c.p_left, sub.p)
    x_right = torch.where(r, sub.x, c.x_right)
    p_right = torch.where(r, sub.p, c.p_right)
    # top-level U-turn across the merged trajectory
    dx = x_right - x_left
    turning_top = ((_vdot(dx, inv_mass * p_left) < 0)
                   | (_vdot(dx, inv_mass * p_right) < 0))
    new = _Carry(
        x_left=x_left, p_left=p_left,
        grad_left=torch.where(r, c.grad_left, sub.grad),
        x_right=x_right, p_right=p_right,
        grad_right=torch.where(r, sub.grad, c.grad_right),
        x_prop=torch.where(t, sub.x_prop, c.x_prop),
        logp_prop=torch.where(take, sub.logp_prop, c.logp_prop),
        grad_prop=torch.where(t, sub.grad_prop, c.grad_prop),
        log_sum_w=torch.where(bad, c.log_sum_w,
                              torch.logaddexp(c.log_sum_w, sub.log_sum_w)),
        sum_accept=c.sum_accept + sub.sum_accept,
        n_leaves=c.n_leaves + sub.n_visited,
        depth=torch.full_like(c.depth, depth + 1),
        done=bad | turning_top,
        diverged=c.diverged | sub.diverged,
    )
    return _select(c.done, c, new)


def _nuts_step(logp_fn, x0, logp0, grad0, eps, inv_mass, z, go_right,
               leaf_u, merge_u, max_depth):
    """One NUTS transition of every chain, in lockstep.

    x0 (C, p) with its logp0 (C,) and grad0 (C, p); eps (C,); inv_mass
    (C, p); the draws: z (C, p) standard normal, and per depth d <
    max_depth the direction bits go_right[d] (C,) bool, the leaf uniforms
    leaf_u[2^d - 1 + i] (C,) of leaf i, and the merge uniforms merge_u[d]
    (C,), all uniform in [0, 1). Returns (x, logp, grad, accept_stat,
    depth, diverged), the last two (C,) int and bool.
    """
    p0 = z / torch.sqrt(inv_mass)
    h0 = -logp0 + 0.5 * torch.sum(p0 * p0 * inv_mass, dim=-1)
    zero = torch.zeros_like(logp0)
    no = torch.zeros_like(logp0, dtype=torch.bool)
    c = _Carry(
        x_left=x0, p_left=p0, grad_left=grad0,
        x_right=x0, p_right=p0, grad_right=grad0,
        x_prop=x0, logp_prop=logp0, grad_prop=grad0,
        log_sum_w=zero, sum_accept=zero,
        n_leaves=torch.zeros_like(logp0, dtype=torch.int64),
        depth=torch.zeros_like(logp0, dtype=torch.int64),
        done=no, diverged=no,
    )
    for depth in range(max_depth):
        r = go_right[depth][:, None]
        eps_d = torch.where(go_right[depth], eps, -eps)
        x_e = torch.where(r, c.x_right, c.x_left)
        p_e = torch.where(r, c.p_right, c.p_left)
        # the subtree's proposal starts as the trajectory's: its first leaf
        # always replaces it unless the subtree diverges, and a diverged
        # subtree is discarded at the merge
        sub = _SubtreeState(
            x=x_e, p=p_e, grad=torch.where(r, c.grad_right, c.grad_left),
            x_prop=c.x_prop, logp_prop=c.logp_prop, grad_prop=c.grad_prop,
            log_sum_w=torch.full_like(zero, -math.inf), sum_accept=zero,
            n_visited=torch.zeros_like(c.n_leaves),
            ckpt_x=(torch.zeros_like(x0),) * (depth + 1),
            ckpt_p=(torch.zeros_like(x0),) * (depth + 1),
            turning=no, diverged=no,
        )
        n_leaf = 2**depth
        for i in range(n_leaf):
            stop = sub.turning | sub.diverged | c.done
            # the one host read of a leaf (none before the first, when no
            # chain can have stopped): which chains go on
            stopped = stop.tolist() if depth or i else [False]
            if all(stopped):
                break
            new = _leaf(logp_fn, sub, i, n_leaf, eps_d, inv_mass, h0,
                        leaf_u[n_leaf - 1 + i])
            sub = _select(stop, sub, new) if any(stopped) else new
        else:
            i = n_leaf
        if i == 0:
            break        # every chain was done before this doubling
        c = _merge(c, sub, go_right[depth], merge_u[depth], inv_mass, depth)

    accept_stat = c.sum_accept / torch.clamp(c.n_leaves.to(x0.dtype),
                                             min=1.0)
    return c.x_prop, c.logp_prop, c.grad_prop, accept_stat, c.depth, \
        c.diverged


def nuts_sample(
    logp_fn: Callable,
    x0: torch.Tensor,
    generator: torch.Generator,
    *,
    num_warmup: int = 300,
    num_samples: int = 300,
    num_chains: int = 4,
    max_depth: int = 8,
    target_accept: float = 0.8,
    init_jitter: float = 0.01,
    eps0: float = 0.01,
    collective_adapt: bool = False,
    axis_name=None,
):
    """Run `num_chains` NUTS chains from jittered copies of x0 (p,), on x0's
    device, drawing from `generator`; returns (samples (C, S, p), info).

    info: accept_rate (C,), step_size, mean_tree_depth (C,) and divergences
    (per chain; with `collective_adapt`, as gpz_tpu reports it, the sum over
    chains of each chain's fraction of divergent draws). `collective_adapt`
    co-adapts ONE shared step size and mass matrix from chain-pooled
    statistics (see mcmc.collective_mcmc). `axis_name` must be None.
    """
    _refuse_axis(axis_name)
    C, p = num_chains, x0.shape[0]
    kw = dict(dtype=x0.dtype, device=x0.device, generator=generator)
    x_init = x0[None, :] + init_jitter * torch.randn((C, p), **kw)

    def step(x, logp, grad, eps, inv_mass):
        z = torch.randn((C, p), **kw)
        go_right = torch.rand((max_depth, C), **kw) < 0.5
        leaf_u = torch.rand((2**max_depth - 1, C), **kw)
        merge_u = torch.rand((max_depth, C), **kw)
        x, logp, grad, acc, depth, div = _nuts_step(
            logp_fn, x, logp, grad, eps, inv_mass, z, go_right, leaf_u,
            merge_u, max_depth)
        return x, logp, grad, acc, (depth, div)

    run = dict(num_warmup=num_warmup, num_samples=num_samples,
               target_accept=target_accept, eps0=eps0)
    if collective_adapt:
        samples, accept, eps_final, (mean_depth, divs) = collective_mcmc(
            step, logp_fn, x_init, **run)
        divergences = torch.sum(divs)
    else:
        samples, accept, eps_final, (depths, divs) = _run_chains(
            step, logp_fn, x_init, collective=False, **run)
        mean_depth = depths.to(x0.dtype).mean(0)
        divergences = divs.sum(0)
    return samples, {
        "accept_rate": accept,
        "step_size": eps_final,
        "mean_tree_depth": mean_depth,
        "divergences": divergences,
    }
