"""The FLOPs of every objective evaluation and validation score of the
window (roofline.evaluation_flops, score_flops) over the traced window at
the peak of the configuration's training type."""
from gpzbench import roofline
from gpzbench.readers import mfu


def read(r):
    cfg = r.cell.cfg
    m, d = cfg["m"], cfg["d"]
    flops = (len(r.probes.eval_s)
             * roofline.evaluation_flops(cfg["n_train"], m, d, 1)
             + sum(roofline.score_flops(n, m, d, 1)
                   for n in r.probes.score_rows))
    return mfu(r, flops, cfg["train_dtype"]) if flops else None
