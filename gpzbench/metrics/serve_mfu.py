"""The served rows' least FLOPs (roofline.served_row_flops: a complete
row one component, a row with unobserved bands SERVE_MIX_COMPONENTS, no
escalation) over the traced window at the peak of the configuration's
variance type."""
from gpzbench import roofline
from gpzbench.readers import mfu


def read(r):
    cfg = r.cell.cfg
    flops = sum(
        rows * roofline.served_row_flops(
            cfg["m"], cfg["d"], 1,
            1 if obs == cfg["d"] else roofline.SERVE_MIX_COMPONENTS, obs)
        for obs, rows in r.record.observed.items())
    return mfu(r, flops, cfg["variance_dtype"]) if flops else None
