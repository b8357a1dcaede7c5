"""Host milliseconds of model.predict per 1,000 rows served outside the
moment chain and the waits on the card: grouping rows by pattern, each
batch's upload, the finish, and the self time of gpz.predict and of its
batches (the program's spans)."""
from gpzbench import spans


def read(r):
    recs = spans.window()
    if recs is None:
        return None
    _, rows = spans.predict_calls(recs)
    secs = (spans.seconds(spans.named(recs, "gpz.predict.group",
                                      "gpz.predict.upload",
                                      "gpz.predict.finish"))
            + spans.self_seconds(recs, spans.named(recs, "gpz.predict",
                                                   "gpz.predict.batch")))
    return spans.per_krow_ms(secs, rows)
