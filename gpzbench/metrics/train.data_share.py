"""Percent of model.train's time (gpz.train spans) spent building its
data: normalisation, psi, the training and validation datasets
(gpz.train.data)."""
from gpzbench import spans


def read(r):
    return spans.share("gpz.train.data", "gpz.train")
