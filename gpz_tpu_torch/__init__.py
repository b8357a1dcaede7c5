"""gpz_tpu_torch — GPz sparse heteroscedastic Gaussian processes in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of gpz_tpu (JAX), which stays the reference: module for module,
gpz_tpu/X.py corresponds to gpz_tpu_torch/X.py, and the tests hold each
against its JAX counterpart. This package imports neither jax nor gpz_tpu.

Ported so far: `init` -> `train` -> `predict`, checkpoints and serving a
checkpoint, for the six covariance methods (GL, VL, GD, VD, GC, VC), with or
without input noise (psi (n, d) for the diagonal family, (n, d, d) for the full
one), on rows with or without missing values (NaN), with cost weights. `init`
builds a model, `train` fits it in float64 by L-BFGS on `nlog_ml` with
validation early stopping, `load_model` reads a gpz_tpu checkpoint (format v1),
and `predict` gives mu and sigma = nu + beta_i + gamma. `init` and `load_model`
place the model on the CUDA device unless given another; `train` and `predict`
run where the model is. On CUDA tensors the full-covariance design-matrix
function on complete rows and its gradient run as the kernels in
csrc/vc_phi.cu (built with nvcc at first use), in training and at every site
of prediction, the mixture sums of missing-data prediction included; on CPU
tensors they run as the same functions in plain PyTorch.

Also ported: multi-restart ensembles (`fit_ensemble`, restarts trained one
after another on one device, `device=None` the CUDA device), the command line (`python -m gpz_tpu_torch
train|predict|bench`, cli.py and bench.py), the native C++ host kernels
(native/: the CSV reader, the host L-BFGS recursion, the modified Cholesky;
built with g++ at first use) and the host optimizers (optim: `minimize_host`,
`minimize_any` with its twelve methods, `check_gradient`).
"""

from gpz_tpu_torch.config import ModelConfig, PredictConfig, TrainConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.model import (
    GPzModel, Prediction, init, predict, sample_weights, train,
)
from gpz_tpu_torch.objective import nlog_ml
from gpz_tpu_torch.optim import minimize
from gpz_tpu_torch.checkpoint import (
    load_model, save_model, train_with_checkpoints,
)
from gpz_tpu_torch.ensemble import fit_ensemble

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "PredictConfig",
    "GPzParams",
    "GPzModel",
    "Prediction",
    "init",
    "train",
    "predict",
    "sample_weights",
    "nlog_ml",
    "minimize",
    "load_model",
    "save_model",
    "train_with_checkpoints",
    "fit_ensemble",
]
