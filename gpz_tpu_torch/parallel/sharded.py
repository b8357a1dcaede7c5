"""Row-sharded objective and distributed training (gpz_tpu.parallel.sharded).

The scale axis of GPz is n (training samples): every sample-indexed term of
the objective is a sum over rows (SURVEY §5 "long-context"), so each rank of
the mesh's data group evaluates the objective on its own rows, and only the
sums cross ranks: objective.nlog_ml applies its `reducer` to every partial
sum over rows (the Gram, rhs, sum ob*y^2, the ln beta and omega sums, and
the fit metrics), and here that reducer is an all-reduce over the data group
(`sum_over`). Everything after the sums is computed on every rank from the
same bits, so the value, the posterior weights and every host decision of
the optimizer (the line search, the jitter ladder) are equal on all ranks
and they make the same collective calls in the same order.

The gradient. The loss L(theta) = g(theta, S(theta)) with S = sum_r f_r is
replicated, and autograd on rank r sees only its own f_r. With c = dL/dS
(replicated, since it is computed from the reduced sums), the gradient is
dg/dtheta + sum_r c f_r'. The reducer's backward returns W c (W ranks in
the group; no collective: the all-reduce of W equal cotangents would give
the same), so rank r's autograd gradient is dg/dtheta + W c f_r', and
`mean_grad`, an identity on the parameters whose backward averages the
gradient over the group (one all-reduce of the flat p-vector), turns that
into dg/dtheta + sum_r c f_r' on every rank: the gradient, bit-equal on all
ranks. (The all-reduce in the backward that torch's deprecated
torch.distributed.nn.functional.all_reduce does, without the average,
leaves each rank with W c f_r' + dg/dtheta: neither rank holds the
gradient.) This holds while the reduced sums feed only replicated terms,
as they do in nlog_ml.

Padding: shards must be equal-sized, so datasets are zero-padded with
omega == 0 rows, exact no-ops in every reduction (dataset.pad_dataset), and
`n_eff` carries the true sample count into the 1/(n k) normalization.

Collectives are all_reduce only, so that CUDA tensors pass through gloo
(which takes them for all_reduce and broadcast alone). Each call of one adds
one to COLLECTIVES.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

from gpz_tpu_torch.config import ModelConfig, TrainConfig
from gpz_tpu_torch.dataset import Dataset, pad_dataset
from gpz_tpu_torch.objective import holdout_metrics, nlog_ml, nlog_ml_batched
from gpz_tpu_torch.optim import minimize
from gpz_tpu_torch.params import FIELDS, GPzParams
from gpz_tpu_torch.parallel.mesh import DATA_AXIS, RESTART_AXIS, Mesh

# all_reduce calls made by this module since the count was last set to 0
COLLECTIVES = 0


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum t over the ranks of `group`, in place; returns t."""
    global COLLECTIVES
    COLLECTIVES += 1
    dist.all_reduce(t, group=group)
    return t


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.size = dist.get_world_size(group)
        return all_reduce(x.clone(memory_format=torch.contiguous_format),
                          group)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.size, None


class _MeanGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.clone(memory_format=torch.contiguous_format),
                       ctx.group)
        return g / dist.get_world_size(ctx.group), None


def sum_over(group) -> Callable:
    """The objective's `reducer` for rows split over `group`: the sum over
    its ranks, whose backward scales the cotangent by the group's size (see
    the module docstring; pair it with mean_grad on the parameters)."""
    return lambda x: _SumOver.apply(x, group)


def mean_grad(x: torch.Tensor, group) -> torch.Tensor:
    """x itself, whose gradient is averaged over the ranks of `group`."""
    return _MeanGrad.apply(x, group)


def _replicated(params: GPzParams, group) -> GPzParams:
    """params, through one mean_grad of their flat vector."""
    flat, unravel = params.flatten()
    return unravel(mean_grad(flat, group))


def _flag_device(group) -> torch.device:
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _agree_complete(complete: bool, group) -> bool:
    """The logical AND of every rank's `complete` hint: one shard may have
    missing values where another has none, and every rank must take the
    same path of the design matrix."""
    t = torch.tensor([0.0 if complete else 1.0], dtype=torch.float64,
                     device=_flag_device(group))
    return float(all_reduce(t, group)) == 0.0


def shard_dataset(data: Dataset, mesh: Mesh) -> Tuple[Dataset, float]:
    """Pad rows to a multiple of the data group's size and keep this rank's
    contiguous share. Returns (local shard, n_eff = the real row count)."""
    n_dev = mesh.size(DATA_AXIS)
    n_pad = -(-data.n // n_dev) * n_dev
    per = n_pad // n_dev
    lo = mesh.get_local_rank(DATA_AXIS) * per
    return pad_dataset(data, n_pad)[lo:lo + per], float(data.n)


def sharded_nlog_ml(params: GPzParams, data: Dataset, cfg: ModelConfig,
                    mesh: Mesh, n_eff, complete: bool = False):
    """nlog_ml with rows split over the data group: (nlml, Aux), equal on
    every rank, and autograd's gradient of nlml in `params` is the gradient
    on every rank."""
    group = mesh.get_group(DATA_AXIS)
    return nlog_ml(_replicated(params, group), data, cfg, n_eff=n_eff,
                   complete=_agree_complete(complete, group),
                   reducer=sum_over(group))


def sharded_holdout_metrics(params: GPzParams, w: torch.Tensor,
                            data: Dataset, cfg: ModelConfig, mesh: Mesh,
                            n_eff, complete: bool = False):
    """holdout_metrics (rmse, ll) with rows split over the data group."""
    group = mesh.get_group(DATA_AXIS)
    return holdout_metrics(params, w, data, cfg, n_eff=n_eff,
                           complete=_agree_complete(complete, group),
                           reducer=sum_over(group))


def sharded_value_and_grad(unravel: Callable, cfg: ModelConfig, mesh: Mesh,
                           complete: bool = False) -> Callable:
    """Flat-vector objective for the L-BFGS optimizer, with the loss summed
    over the data group: fun(flat, data, n_eff) -> (nlml, flat gradient,
    aux), each equal on every rank, the gradient that of the whole dataset.
    The `complete` hint is agreed over the group once, here. The dataset is
    an argument of fun, so one fun serves same-shaped datasets."""
    group = mesh.get_group(DATA_AXIS)
    complete = _agree_complete(complete, group)
    r = sum_over(group)

    def fun(flat, data, n_eff):
        flat = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            nlml, aux = nlog_ml(unravel(mean_grad(flat, group)), data, cfg,
                                n_eff=n_eff, complete=complete, reducer=r)
            grad, = torch.autograd.grad(nlml, flat)
        return nlml.detach(), grad, aux

    return fun


def sharded_value_and_grad_batched(unravel: Callable, cfg: ModelConfig,
                                   mesh: Mesh,
                                   complete: bool = False) -> Callable:
    """sharded_value_and_grad for B parameter sets at once, the objective
    that optim.minimize_batched takes: fun(flats (B, p), data, n_eff) ->
    (nlml (B,), flat gradients (B, p), Aux with a leading B), each equal on
    every rank of the data group: one nlog_ml_batched call on this rank's
    rows (one launch of each kernel of the pair), its sums all-reduced, and
    one mean_grad of the (B, p) gradient."""
    group = mesh.get_group(DATA_AXIS)
    complete = _agree_complete(complete, group)
    r = sum_over(group)

    def fun(flats, data, n_eff):
        flats = flats.detach().requires_grad_(True)
        with torch.enable_grad():
            nlml, aux = nlog_ml_batched(mean_grad(flats, group), unravel,
                                        data, cfg, complete, n_eff=n_eff,
                                        reducer=r, lanes=True)
            grad, = torch.autograd.grad(nlml.sum(), flats)
        return nlml.detach(), grad, aux

    return fun


def train_sharded(
    params0: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    mesh: Mesh,
    *,
    valid_data: Optional[Dataset] = None,
    tc: Optional[TrainConfig] = None,
    complete: bool = False,
):
    """Distributed L-BFGS training: every rank runs optim.minimize on the
    whole dataset `data` (and `valid_data`), of which it evaluates its own
    rows; the ranks move in lockstep. Returns (MinimizeResult, unravel),
    equal on every rank."""
    tc = tc or TrainConfig()
    group = mesh.get_group(DATA_AXIS)
    complete = _agree_complete(complete, group)
    sdata, n_eff = shard_dataset(data, mesh)
    flat0, unravel = params0.flatten()
    fun = sharded_value_and_grad(unravel, cfg, mesh, complete)

    score_fn = None
    if valid_data is not None:
        svalid, n_eff_v = shard_dataset(valid_data, mesh)
        r = sum_over(group)

        def score_fn(flat, aux):
            rmse, ll = holdout_metrics(unravel(flat), aux.w, svalid, cfg,
                                       n_eff=n_eff_v, complete=complete,
                                       reducer=r)
            return ll, {"valid_rmse": rmse, "valid_ll": ll}

    res = minimize(
        lambda flat: fun(flat, sdata, n_eff),
        flat0,
        history=tc.history,
        max_iter=tc.max_iter,
        opt_tol=tc.opt_tol,
        prog_tol=tc.prog_tol,
        c1=tc.c1,
        c2=tc.c2,
        max_ls=tc.max_ls,
        score_fn=score_fn,
        max_attempts=tc.max_attempts,
    )
    return res, unravel


def ensemble_grad_step(stacked_params: GPzParams, data: Dataset,
                       cfg: ModelConfig, mesh: Mesh, n_eff, lr=1e-2,
                       complete: bool = False) -> GPzParams:
    """One gradient step for R independent restarts on the 2-D mesh.

    stacked_params: GPzParams whose every field has a leading restart axis
    R, divisible by the restart group's size, the same on every rank; data:
    this rank's rows (shard_dataset). Restarts are split over the restart
    group and rows over the data group; a rank's restarts are one
    nlog_ml_batched evaluation (one launch of each kernel of the pair).
    Returns the stepped (R, ...) parameters, equal on every rank.
    """
    present = [f for f in FIELDS if getattr(stacked_params, f) is not None]
    R = getattr(stacked_params, present[0]).shape[0]
    n_r = mesh.size(RESTART_AXIS)
    if R % n_r:
        raise ValueError(f"{R} restarts not divisible by the restart "
                         f"group's {n_r} ranks")
    per = R // n_r
    lo = mesh.get_local_rank(RESTART_AXIS) * per
    group = mesh.get_group(DATA_AXIS)
    _, unravel = GPzParams(**{f: getattr(stacked_params, f)[0]
                              for f in present}).flatten()
    flat = torch.cat([getattr(stacked_params, f).reshape(R, -1)
                      for f in present], dim=1)
    local = flat[lo:lo + per].detach().requires_grad_(True)
    with torch.enable_grad():
        nlml = nlog_ml_batched(mean_grad(local, group), unravel, data, cfg,
                               complete=_agree_complete(complete, group),
                               n_eff=n_eff, reducer=sum_over(group))
        grad, = torch.autograd.grad(nlml.sum(), local)
    # the whole (R, p) on every rank: each restart group holds each restart
    # once, and adding zeros keeps its bits
    out = torch.zeros_like(flat)
    out[lo:lo + per] = local.detach() - lr * grad
    return unravel(all_reduce(out, mesh.get_group(RESTART_AXIS)))
