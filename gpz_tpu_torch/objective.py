"""Posterior state of a trained model (gpz_tpu.objective.Posterior).

The log marginal likelihood and its gradient come with the training slice;
prediction needs only the stored posterior.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Posterior:
    """Posterior state stored per parameter set (ref train.m:53-58)."""

    w: torch.Tensor          # (m, k)
    iSigma_w: torch.Tensor   # (k, m, m) inverse of the Gram SIGMA
    logdet: torch.Tensor     # (k,)
