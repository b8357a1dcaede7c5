"""Milliseconds per 1,000 rows served that the host waits on the card:
the gpz.predict.readback and gpz.predict.guard spans (host reads), less
the guard's gpz.predict.moments children."""
from gpzbench import spans


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    _, rows = spans.predict_calls(recs)
    secs = (spans.seconds(spans.named(recs, "gpz.predict.readback"))
            + spans.self_seconds(recs, spans.named(recs,
                                                   "gpz.predict.guard")))
    return spans.per_krow_ms(secs, rows)
