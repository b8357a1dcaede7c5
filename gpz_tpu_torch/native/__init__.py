"""Native host kernels (C++, ctypes): the host L-BFGS recursion, the
Gill–Murray modified Cholesky and the CSV reader (gpz_tpu.native)."""

from gpz_tpu_torch.native.ffi import (
    available,
    lbfgs_direction,
    lbfgs_add,
    modified_cholesky,
    read_csv,
)

__all__ = [
    "available",
    "lbfgs_direction",
    "lbfgs_add",
    "modified_cholesky",
    "read_csv",
]
