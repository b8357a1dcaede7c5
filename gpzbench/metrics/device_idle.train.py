"""The device's idle share of the traced training window."""
from gpzbench.readers import idle


def read(r):
    return idle(r)
