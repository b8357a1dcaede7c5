"""Objective evaluations per L-BFGS iteration (fit_info's fun_evals over
iterations), over the window's jobs."""


def read(r):
    its = r.record.iterations
    return None if not its else r.record.fun_evals / its
