"""The readers of the program's spans and counters, on synthetic records
(gpz_tpu_torch.trace.records() replaced), on a program without the tracing
module (nothing to read), and in a traced tiny run of each cell."""

import os
import sys
import types

import pytest

import tiny
from gpzbench import harness

MS = 1_000_000
SERVE = ("serve.host_ms_per_krow", "serve.enqueue_ms_per_krow",
         "serve.wait_ms_per_krow", "serve.host_reads_per_krow")
TRAIN = ("train.data_share", "train.resolve_share",
         "train.em_iters_per_resolve")


def _spans(*tree):
    """Records from (name, start ms, end ms, attrs, counts, children)."""
    out, next_id = [], [0]

    def walk(node, parent, root):
        name, t0, t1, attrs, counts, kids = node
        next_id[0] += 1
        me = next_id[0]
        root = me if root is None else root
        for kid in kids:
            walk(kid, me, root)
        out.append({"name": name, "start_ns": t0 * MS, "end_ns": t1 * MS,
                    "id": me, "parent": parent, "root": root,
                    "attrs": attrs, "counts": counts})

    for node in tree:
        walk(node, None, None)
    return out


def _leaf(name, t0, t1, kids=()):
    return (name, t0, t1, {}, {}, list(kids))


PREDICT = _spans((
    "gpz.predict", 0, 100, {"rows": 2000, "patterns": 2, "batches": 2},
    {"reads.readback": 10, "reads.coverage": 1, "predict.escalations": 1},
    [_leaf("gpz.predict.group", 0, 10),
     ("gpz.predict.batch", 10, 50, {"rows": 1000}, {}, [
         _leaf("gpz.predict.upload", 10, 12),
         _leaf("gpz.predict.moments", 12, 30),
         _leaf("gpz.predict.guard", 30, 40,
               [_leaf("gpz.predict.moments", 32, 38)]),
         _leaf("gpz.predict.readback", 40, 48)]),
     ("gpz.predict.batch", 50, 90, {"rows": 1000}, {}, [
         _leaf("gpz.predict.upload", 50, 51),
         _leaf("gpz.predict.moments", 51, 70),
         _leaf("gpz.predict.readback", 70, 89)]),
     _leaf("gpz.predict.finish", 90, 98)]))

TRAINING = _spans(
    ("gpz.train", 0, 200, {"rows": 10, "m": 4},
     {"prior.em_iterations": 30}, [
         _leaf("gpz.train.data", 0, 20),
         _leaf("gpz.train.minimize", 20, 100, [_leaf("gpz.lbfgs.eval",
                                                     20, 60)]),
         _leaf("gpz.train.resolve", 100, 150),
         _leaf("gpz.train.resolve", 150, 198)]),
    ("gpz.train", 300, 400, {"rows": 10, "m": 4},
     {"prior.em_iterations": 10}, [
         _leaf("gpz.train.data", 300, 310),
         _leaf("gpz.train.resolve", 320, 340),
         _leaf("gpz.train.resolve", 340, 360)]))


def _read(name, cycle=64):
    """The reader's value; a serving mix of `cycle` request sizes."""
    r = types.SimpleNamespace(
        cell=types.SimpleNamespace(traffic={"sizes_cycle": cycle}))
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"),
        "gpzbench_metric_" + name).read(r)


@pytest.fixture
def recorded(monkeypatch):
    from gpz_tpu_torch import trace

    def use(recs):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
    return use


def test_serving_readers(recorded):
    recorded(PREDICT)
    got = {name: _read(name) for name in SERVE}
    # 26 ms of host work, 43 enqueueing, 31 waiting, over 2,000 rows
    assert got == pytest.approx({
        "serve.host_ms_per_krow": 13.0, "serve.enqueue_ms_per_krow": 21.5,
        "serve.wait_ms_per_krow": 15.5, "serve.host_reads_per_krow": 5.5})
    assert sum(got[n] for n in SERVE[:3]) == pytest.approx(50.0)


def test_host_reads_count_the_first_cycle_of_requests(recorded):
    """Over the window's first sizes_cycle requests by start, whatever
    else the window held and in whatever order the spans closed."""
    later = _spans(("gpz.predict", 200, 300, {"rows": 1000},
                    {"reads.readback": 50}, []))
    for r in later:
        r["id"] += 100
        r["root"] += 100
    recorded(later + PREDICT)
    assert _read("serve.host_reads_per_krow", cycle=1) == pytest.approx(5.5)
    assert _read("serve.host_reads_per_krow", cycle=2) == pytest.approx(
        (11 + 50) / 3.0)


def test_training_readers(recorded):
    recorded(TRAINING)
    assert {name: _read(name) for name in TRAIN} == pytest.approx({
        "train.data_share": 10.0, "train.resolve_share": 46.0,
        "train.em_iters_per_resolve": 10.0})


@pytest.mark.parametrize("name", SERVE + TRAIN)
def test_nothing_to_read(recorded, monkeypatch, name):
    recorded([])
    assert _read(name) is None
    # a program without the tracing module: nothing, and no error
    monkeypatch.setitem(sys.modules, "gpz_tpu_torch.trace", None)
    monkeypatch.delattr("gpz_tpu_torch.trace", raising=False)
    assert _read(name) is None


@pytest.mark.parametrize("cell, names", [("photoz_m100.serve_nan", SERVE),
                                         ("deep_m1000.train", TRAIN)])
def test_traced_tiny_run_reports_them(cell, names):
    from gpz_tpu_torch import trace

    trace.reset()
    result = tiny.run(tiny.tiny_cell(cell, {k: 1.0 for k in
                      harness.find_cell(tiny.bench(), cell).spec["limits"]}),
                      trace=True)
    trace.reset()
    for name in names:
        assert result["metrics"][name]["value"] > 0, name
