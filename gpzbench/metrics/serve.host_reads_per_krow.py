"""Transfers of device values to the host (the program's reads.* counters)
inside model.predict, per 1,000 rows served, over the window's first
cycle of request sizes (the mix's sizes_cycle requests, or every request
of a shorter window). The requests of that cycle, and so the reading, are
the same on every run of one seed; over the whole window they would
depend on how many requests the window's seconds held."""
from gpzbench import spans
from gpzbench.readers import per_krow


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    roots, rows = spans.predict_calls(recs, r.cell.traffic["sizes_cycle"])
    return per_krow(spans.counted(roots, "reads."), rows)
