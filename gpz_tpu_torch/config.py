"""Typed configuration objects.

The reference passes MATLAB name/value pairs parsed at each API entry
(ref GPz/init.m:6-10, GPz/predict.m:5-8); here they are explicit frozen
dataclasses with the same names and defaults as gpz_tpu.config.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

METHODS = ("GL", "VL", "GD", "VD", "GC", "VC")

#: methods with full (d x d) covariance per basis — the 'C' family
FULL_COV_METHODS = ("GC", "VC")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static model structure (ref GPz/init.m:16-20 `model` struct fields).

    Field for field the same as gpz_tpu.config.ModelConfig, so a checkpoint
    header's "cfg" builds either package's config.
    """

    m: int                      # number of basis functions
    d: int                      # input dimensionality
    k: int = 1                  # output dimensionality
    method: str = "VL"          # one of GL/VL/GD/VD/GC/VC
    heteroscedastic: bool = True
    normalize: bool = True
    dtype: str = "float32"      # parameter / contraction dtype
    # dtype of the reduced quantities (Gram, rhs, the m x m solve, every
    # scalar evidence term): "auto" is float64, an explicit "float32" is
    # honoured (objective.solve_dtype).
    solve_dtype: str = "auto"
    # gpz_tpu's schedule for obtaining float64 reductions on a TPU, which
    # emulates float64. Checkpoint headers carry it; it is accepted,
    # validated and written back, and nothing here reads it: CUDA and the
    # CPU compute float64 natively, so the reductions are always "strict".
    solve_mode: str = "auto"

    def __post_init__(self):
        if self.method not in METHODS:
            raise ValueError(f"method must be one of {METHODS}, got {self.method!r}")
        if self.m <= 0 or self.d <= 0 or self.k <= 0:
            raise ValueError("m, d, k must be positive")
        if self.solve_dtype not in ("auto", "float32", "float64"):
            raise ValueError(f"bad solve_dtype {self.solve_dtype!r}")
        if self.solve_mode not in ("auto", "strict", "mixed", "mixed_strict"):
            raise ValueError(f"bad solve_mode {self.solve_mode!r}")

    @property
    def full_cov(self) -> bool:
        return self.method in FULL_COV_METHODS

    @property
    def gamma_shape(self) -> tuple:
        """Canonical storage shape of the length-scale parameter Gamma,
        chosen so that broadcasting expands it to the working shape and
        autograd sums the gradient over the broadcast axes (ref
        GPz/GPz.m:215-225). Degrees of freedom match ref GPz/init.m:65-86:
        GL=1, VL=m, GD=d, VD=m*d, GC=d*d, VC=m*d*d."""
        m, d = self.m, self.d
        return {
            "GL": (1, 1),
            "VL": (m, 1),
            "GD": (1, d),
            "VD": (m, d),
            "GC": (1, d, d),
            "VC": (m, d, d),
        }[self.method]

    @property
    def gamma_expanded_shape(self) -> tuple:
        m, d = self.m, self.d
        return (m, d, d) if self.full_cov else (m, d)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimization options (ref GPz/train.m:25-28 + minFunc defaults)."""

    max_iter: int = 200
    max_attempts: Optional[int] = None   # None == inf (ref maxAttempts=inf)
    # minFunc L-BFGS defaults (ref minFunc.m:96-101,178)
    history: int = 100                   # L-BFGS correction pairs (Corr=100)
    opt_tol: float = 1e-5
    prog_tol: float = 1e-9
    c1: float = 1e-4
    c2: float = 0.9
    max_ls: int = 25
    verbose: bool = True


@dataclasses.dataclass(frozen=True)
class PredictConfig:
    """Prediction options (ref GPz/predict.m:5-8)."""

    which_set: str = "best"      # "best" | "last"
    batch_size: int = 4096       # host-side chunking of the O(n m^2) moment pass
