"""What the readers of the program's own spans share: the span records
that gpz_tpu_torch.trace kept while the traced window's profiler ran (its
records(): name, start_ns, end_ns, id, parent, root, attrs, counts), and
sums over them. A program without that module, or one that recorded no
span, gives nothing to read."""

from __future__ import annotations


def window():
    """The program's span records of the traced window, or None."""
    try:
        from gpz_tpu_torch import trace
    except ImportError:
        return None
    return trace.records() or None


def named(recs, *names) -> list:
    return [r for r in recs if r["name"] in names]


def seconds(spans) -> float:
    return sum(r["end_ns"] - r["start_ns"] for r in spans) * 1e-9


def self_seconds(recs, spans) -> float:
    """The spans' time less the time of their children."""
    ids = {r["id"] for r in spans}
    inner = [r for r in recs if r["parent"] in ids]
    return seconds(spans) - seconds(inner)


def counted(spans, prefix: str) -> int:
    """The spans' counts of every counter whose name starts with
    `prefix`."""
    return sum(k for r in spans for name, k in r["counts"].items()
               if name.startswith(prefix))


def predict_calls(recs, first=None):
    """(the gpz.predict spans, the rows they served); the `first` of them
    by start where given."""
    roots = named(recs, "gpz.predict")
    if first is not None:
        roots = sorted(roots, key=lambda r: r["start_ns"])[:first]
    return roots, sum(r["attrs"].get("rows", 0) for r in roots)


def per_krow_ms(secs: float, rows: int):
    return None if not rows else secs * 1e6 / rows


def share(part: str, whole: str):
    """Percent of the time in `whole` spans spent in `part` spans."""
    recs = window()
    if recs is None:
        return None
    total = seconds(named(recs, whole))
    return None if total <= 0 else 100.0 * seconds(named(recs, part)) / total
