"""Milliseconds per 1,000 rows served in gpz.predict.moments spans: the
host enqueueing the moment chain's launches (an escalation's exact re-run
included)."""
from gpzbench import spans


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    _, rows = spans.predict_calls(recs)
    return spans.per_krow_ms(
        spans.seconds(spans.named(recs, "gpz.predict.moments")), rows)
