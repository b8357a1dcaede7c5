"""The backward kernel's (with its reduce pass) share of its roofline over
the training window."""
from gpzbench.readers import kernel_roofline


def read(r):
    return kernel_roofline(r, "bwd")
