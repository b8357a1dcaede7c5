"""Batches that the mixture's coverage guard sent to the exact sum (calls
of predict_moments_full with mix_topl = m), per 1,000 rows served."""
from gpzbench.readers import per_krow


def read(r):
    return per_krow(r.probes.escalations, r.record.rows)
