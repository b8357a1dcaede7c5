"""Mixture-prior EM over basis responsibilities (gpz_tpu.prior; ref
GPz/getPrior.m).

The densities do not depend on the prior, so lnN is computed once and the
fixed point runs on the (n, m) matrix: a host loop on device tensors, which
reads one scalar per iteration for the stopping rule.
"""

from __future__ import annotations

import math

import torch

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.dataset import Dataset
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.phi import log_phi
from gpz_tpu_torch.trace import count, span


def get_prior(
    params: GPzParams,
    data: Dataset,
    cfg: ModelConfig,
    complete: bool = False,
    max_iter: int = 100,
    tol: float = 1e-10,
) -> torch.Tensor:
    """EM fixed point for mixture weights over the m bases, (m,)."""
    with span("gpz.prior.em"), torch.no_grad():
        ln_n = log_phi(params, cfg, data.X, data.mask, data.psi,
                       complete)[1]
        # log-sum-exp stabilized responsibilities; only N stays held through
        # the loop (each (n, m) tensor is 8 GB at n = 10**6, m = 1000)
        N = torch.exp(ln_n - ln_n.max(dim=1, keepdim=True).values)
        del ln_n
        prior = torch.full((cfg.m,), 1.0 / cfg.m, dtype=data.X.dtype,
                           device=data.X.device)
        it, delta = 0, math.inf
        while it < max_iter and delta >= tol:
            w = N * prior[None, :]
            w = w / w.sum(dim=1, keepdim=True)
            new = w.mean(dim=0)
            delta = float(torch.linalg.norm(prior - new)
                          / torch.linalg.norm(prior + new))
            prior = new
            it += 1
            count("prior.em_iterations")
    return prior
