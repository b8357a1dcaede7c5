"""The prior's EM iterations (the program's prior.em_iterations counter)
per resolve (gpz.train.resolve span)."""
from gpzbench import spans


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    resolves = spans.named(recs, "gpz.train.resolve")
    if not resolves:
        return None
    return spans.counted(spans.named(recs, "gpz.train"),
                         "prior.em_iterations") / len(resolves)
