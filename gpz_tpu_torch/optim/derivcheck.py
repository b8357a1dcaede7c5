"""Gradient checking utilities (gpz_tpu.optim.derivcheck) — parity with the
reference's derivative-check harness (ref minFunc/autoDif/derivativeCheck.m:
28-41, autoGrad.m), which was the only correctness tool the 263-line hand
gradient ever had. Here the roles are reversed: torch.autograd is the trusted
reference and these utilities validate custom kernels / hand-written VJPs
(the CUDA backward of ops/vc_phi.py among them) against finite differences.

`f` maps a tensor to a scalar tensor. It is called on float64 tensors on the
device of `x` (the CPU when `x` is not a tensor).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def _device(x):
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def numerical_gradient(
    f: Callable, x, eps: float = 1e-6, order: int = 2
) -> np.ndarray:
    """Finite-difference gradient (order 1 = forward, 2 = central; the
    reference's autoGrad types 1/2)."""
    dev = _device(x)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x, dtype=np.float64)
    g = np.zeros_like(x)

    def at(v):
        with torch.no_grad():
            return float(f(torch.as_tensor(v, device=dev)))

    f0 = at(x) if order == 1 else None
    for i in range(x.size):
        e = np.zeros_like(x)
        e.flat[i] = eps
        fp = at(x + e)
        if order == 1:
            g.flat[i] = (fp - f0) / eps
        else:
            fm = at(x - e)
            g.flat[i] = (fp - fm) / (2 * eps)
    return g


def check_gradient(
    f: Callable,
    x,
    eps: float = 1e-6,
    rtol: float = 1e-4,
    atol: float = 1e-7,
    verbose: bool = False,
) -> Tuple[bool, float]:
    """Compare torch.autograd's gradient of f against central differences
    at x.

    Returns (ok, max_abs_err). The tolerance default mirrors the reference's
    1e-4 threshold (derivativeCheck.m:35).
    """
    xt = torch.as_tensor(x, device=_device(x)).detach().clone()
    xt.requires_grad_(True)
    with torch.enable_grad():
        g, = torch.autograd.grad(f(xt), xt)
    g = g.detach().cpu().numpy().astype(np.float64)
    gn = numerical_gradient(f, x, eps=eps)
    err = np.abs(g - gn)
    scale = np.maximum(np.abs(gn), 1.0)
    ok = bool(np.all(err <= rtol * scale + atol))
    if verbose:
        print(f"max abs err {err.max():.3e}; max rel err {(err / scale).max():.3e}")
    return ok, float(err.max())
