from gpz_tpu_torch.optim.lbfgs import (
    MinimizeResult,
    minimize,
    minimize_batched,
)
from gpz_tpu_torch.optim.host_lbfgs import minimize_host
from gpz_tpu_torch.optim.solvers import (
    METHODS,
    armijo_backtrack,
    conj_grad,
    minimize_any,
    numerical_hvp,
)
from gpz_tpu_torch.optim.derivcheck import check_gradient, numerical_gradient

__all__ = [
    "minimize",
    "minimize_batched",
    "MinimizeResult",
    "minimize_host",
    "minimize_any",
    "METHODS",
    "armijo_backtrack",
    "conj_grad",
    "numerical_hvp",
    "check_gradient",
    "numerical_gradient",
]
