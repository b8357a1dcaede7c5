"""Milliseconds of one objective evaluation (value and gradient, to the
end of its device work), the mean over the window's evaluations."""


def read(r):
    s = r.probes.eval_s
    return None if not s else 1e3 * sum(s) / len(s)
