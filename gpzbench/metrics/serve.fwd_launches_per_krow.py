"""Launches of the design-matrix forward kernel (ops.vc_phi.LAUNCHES_FWD)
per 1,000 rows served."""
from gpzbench.readers import per_krow


def read(r):
    return per_krow(r.probes.launches["fwd"], r.record.rows)
