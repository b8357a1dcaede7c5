"""Typed configuration objects.

The reference passes MATLAB name/value pairs parsed at each API entry
(ref GPz/init.m:6-10, GPz/predict.m:5-8); here they are explicit frozen
dataclasses with the same names and defaults as gpz_tpu.config.
"""

from __future__ import annotations

import dataclasses

METHODS = ("GL", "VL", "GD", "VD", "GC", "VC")

#: methods with full (d x d) covariance per basis — the 'C' family
FULL_COV_METHODS = ("GC", "VC")


def not_ported(what: str) -> NotImplementedError:
    """The error for a path of gpz_tpu that this package does not have yet."""
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1: "
        "'Prediction beyond the slice')")


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
    # gpz_tpu's training precision schedule (how the TPU, which emulates
    # float64, obtains float64 reductions). Checkpoint headers carry both;
    # they are accepted, validated and written back, and nothing here reads
    # them: CUDA and the CPU compute float64 natively.
    solve_dtype: str = "auto"
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
    def gamma_expanded_shape(self) -> tuple:
        m, d = self.m, self.d
        return (m, d, d) if self.full_cov else (m, d)
