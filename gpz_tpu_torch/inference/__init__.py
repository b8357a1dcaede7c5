"""Posterior inference over GPz hyperparameters (gpz_tpu.inference): HMC,
NUTS and mean-field ADVI on a batch of chains, and the model-level
`sample_posterior` / `predictive_draws`."""

from gpz_tpu_torch.inference.mcmc import (
    hmc_sample, gpz_log_posterior, split_rhat,
)
from gpz_tpu_torch.inference.nuts import nuts_sample
from gpz_tpu_torch.inference.vi import advi_fit
from gpz_tpu_torch.inference.api import sample_posterior, predictive_draws

__all__ = [
    "hmc_sample",
    "gpz_log_posterior",
    "split_rhat",
    "nuts_sample",
    "advi_fit",
    "sample_posterior",
    "predictive_draws",
]
