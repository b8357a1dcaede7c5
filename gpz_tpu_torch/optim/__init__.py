from gpz_tpu_torch.optim.lbfgs import MinimizeResult, minimize

__all__ = ["MinimizeResult", "minimize"]
