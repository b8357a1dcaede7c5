"""Percent of model.train's time (gpz.train spans) spent in its two
resolves (gpz.train.resolve: the posterior, unsynchronised, and the
prior's EM to its last stopping read)."""
from gpzbench import spans


def read(r):
    return spans.share("gpz.train.resolve", "gpz.train")
