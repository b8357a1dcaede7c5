"""Percent of the rows of the objective's design matrices that take the
masked pass: the program's phi.rows_masked over phi.rows_total, counted
inside the window's gpz.lbfgs.eval spans; nothing where the program
counts no design-matrix rows."""
from gpzbench import spans


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    evals = spans.named(recs, "gpz.lbfgs.eval")
    total = spans.counted(evals, "phi.rows_total")
    if not total:
        return None
    return 100.0 * spans.counted(evals, "phi.rows_masked") / total
