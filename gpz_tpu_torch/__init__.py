"""gpz_tpu_torch — GPz sparse heteroscedastic Gaussian processes in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of gpz_tpu (JAX), which stays the reference: module for module,
gpz_tpu/X.py corresponds to gpz_tpu_torch/X.py, and the tests hold each
against its JAX counterpart. This package imports neither jax nor gpz_tpu.

Ported so far, for the full-covariance family (GC/VC) on complete rows, with
or without full input noise: `init` -> `train` -> `predict`, and serving a
checkpoint. `init` builds a model, `train` fits it in float64 by L-BFGS on
`nlog_ml` with validation early stopping, `load_model` reads a gpz_tpu
checkpoint (format v1), and `predict` gives mu and
sigma = nu + beta_i + gamma. `init` and `load_model` place the model on the
CUDA device unless given another; `train` and `predict` run where the model
is. On CUDA tensors the design-matrix function and its gradient run as the
kernels in csrc/vc_phi.cu (built with nvcc at first use); on CPU tensors they
run as the same functions in plain PyTorch.
"""

from gpz_tpu_torch.config import ModelConfig, TrainConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.model import GPzModel, Prediction, init, predict, train
from gpz_tpu_torch.objective import nlog_ml
from gpz_tpu_torch.optim import minimize
from gpz_tpu_torch.checkpoint import load_model, save_model

__all__ = [
    "ModelConfig",
    "TrainConfig",
    "GPzParams",
    "GPzModel",
    "Prediction",
    "init",
    "train",
    "predict",
    "nlog_ml",
    "minimize",
    "load_model",
    "save_model",
]
