"""gpz_tpu_torch — GPz sparse heteroscedastic Gaussian processes in PyTorch,
with hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of gpz_tpu (JAX), which stays the reference: module for module,
gpz_tpu/X.py corresponds to gpz_tpu_torch/X.py, and the tests hold each
against its JAX counterpart. This package imports neither jax nor gpz_tpu.

Ported so far: serving a trained model. `load_model` reads a gpz_tpu
checkpoint (format v1) onto a device, and `predict` gives mu and
sigma = nu + beta_i + gamma for complete rows of the full-covariance family
with full input noise. On CUDA tensors the design-matrix function runs as the
kernel in csrc/vc_phi.cu (built with nvcc at first use); on CPU tensors it
runs as the same function in plain PyTorch.
"""

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams
from gpz_tpu_torch.model import GPzModel, Prediction, predict
from gpz_tpu_torch.checkpoint import load_model, save_model

__all__ = [
    "ModelConfig",
    "GPzParams",
    "GPzModel",
    "Prediction",
    "predict",
    "load_model",
    "save_model",
]
