"""gpz_tpu_torch.trace: spans off unless a profiler session is active, and
then recorded at their sites with root, parent and counts, on the clock of
the profiler's own events; counters always on; outputs the same bits with
spans on and off.

One tiny VC model (m = 8, d = 3, psi (n, d, d), a third of the served rows
without band 0, a fifth without band 2) trains for 2 iterations and serves
under a CPU torch.profiler session, with MIX_TOPL = 3 so that the coverage
guard runs, once as it stands and once with every guarded batch escalated.
"""

import importlib
import threading

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gpz_tpu_torch
from gpz_tpu_torch import model as gmodel, trace
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.phi import log_phi
from gpz_tpu_torch.prior import get_prior

tpredict = importlib.import_module("gpz_tpu_torch.predict")

M, D, ROWS, TRAIN_ROWS, BATCH = 8, 3, 400, 250, 64
OUTPUTS = ("mu", "sigma", "nu", "beta_i", "gamma", "phi")
PREDICT_STAGES = ("gpz.predict.upload", "gpz.predict.moments",
                  "gpz.predict.guard", "gpz.predict.readback")


def _problem():
    mags, errs, z = synthetic_sdss(n=ROWS, filters=D, seed=4)
    psi = np.einsum("ni,ij->nij", errs ** 2, np.eye(D))
    X = mags.copy()
    X[::3, 0] = np.nan
    X[1::5, 2] = np.nan
    tr = np.arange(ROWS) < TRAIN_ROWS
    return mags, X, z, psi, tr


def _run(model0, problem):
    """(fit, prediction, escalated prediction) of the tiny problem."""
    mags, X, z, psi, tr = problem
    fit = gpz_tpu_torch.train(model0, mags, z, training=tr, validation=~tr,
                              psi=psi, max_iter=2, verbose=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpredict, "MIX_TOPL", 3)
        pred = gpz_tpu_torch.predict(X[~tr], fit, psi=psi[~tr],
                                     batch_size=BATCH)
        mp.setattr(tpredict, "MIX_COVERAGE_MIN", 2.0)
        escalated = gpz_tpu_torch.predict(X[~tr], fit, psi=psi[~tr],
                                          batch_size=BATCH)
    return fit, pred, escalated


@pytest.fixture(scope="module")
def runs():
    """The run with spans off, the same run traced, the traced run's
    records and the profiler's events of the same names."""
    problem = _problem()
    mags, _, z, psi, tr = problem
    model0 = gpz_tpu_torch.init(mags[tr], z[tr], "VC", M, psi=psi[tr],
                                seed=1, dtype="float64", device="cpu")
    off = _run(model0, problem)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _run(model0, problem)
    recs = trace.records()
    events = [(e.name(), e.start_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("gpz.")]
    trace.reset()
    return off, on, recs, events


def _tree(recs):
    by_id = {r["id"]: r for r in recs}
    kids = {r["id"]: [] for r in recs}
    for r in sorted(recs, key=lambda r: r["start_ns"]):
        if r["parent"] is not None:
            kids[r["parent"]].append(r)
    return by_id, kids


def _names(rs):
    return [r["name"] for r in rs]


def test_off_is_one_shared_null_and_counters_count(monkeypatch):
    def no_record_function(name):
        raise AssertionError("record_function called with spans off")

    monkeypatch.setattr(torch.profiler, "record_function",
                        no_record_function)
    trace.reset()
    before = trace.COUNTS.get("test.off", 0)
    with trace.span("gpz.predict", rows=3) as s:
        trace.count("test.off", 2)
        s.set(batches=1)
    assert trace.span("x") is trace.NULL and s is trace.NULL
    assert trace.COUNTS["test.off"] == before + 2
    mags, X, z, psi, tr = _problem()
    model0 = gpz_tpu_torch.init(mags[:60], z[:60], "VC", 4, psi=psi[:60],
                                seed=1, dtype="float64", device="cpu")
    gpz_tpu_torch.predict(X[:20], model0, psi=psi[:20])
    assert trace.records() == []


def test_span_tree(runs):
    *_, recs, _ = runs
    by_id, kids = _tree(recs)
    roots = sorted((r for r in recs if r["parent"] is None),
                   key=lambda r: r["start_ns"])
    assert _names(roots) == ["gpz.train", "gpz.predict", "gpz.predict"]
    for root in roots:
        # one root id per call, shared by every span under it
        under = [r for r in recs if r["root"] == root["id"]]
        for r in under:
            top = r
            while top["parent"] is not None:
                top = by_id[top["parent"]]
            assert top is root
        # children cover their root
        dur = root["end_ns"] - root["start_ns"]
        covered = sum(c["end_ns"] - c["start_ns"] for c in kids[root["id"]])
        assert dur - covered < 0.05 * dur, root["name"]

    train = roots[0]
    assert train["attrs"] == {"m": M, "rows": TRAIN_ROWS}
    assert _names(kids[train["id"]]) == [
        "gpz.train.data", "gpz.train.minimize", "gpz.train.resolve",
        "gpz.train.resolve"]
    minimize = kids[train["id"]][1]
    phases = _names(kids[minimize["id"]])
    assert set(phases) == {"gpz.lbfgs.eval", "gpz.lbfgs.score",
                           "gpz.lbfgs.read"}
    assert phases[0] == "gpz.lbfgs.eval"
    for resolve in kids[train["id"]][2:]:
        assert _names(kids[resolve["id"]]) == ["gpz.posterior",
                                               "gpz.prior.em"]

    for root, forced in zip(roots[1:], (False, True)):
        batches = [c for c in kids[root["id"]]
                   if c["name"] == "gpz.predict.batch"]
        assert _names(kids[root["id"]]) == (
            ["gpz.predict.group"] + ["gpz.predict.batch"] * len(batches)
            + ["gpz.predict.finish"])
        assert root["attrs"]["rows"] == ROWS - TRAIN_ROWS
        assert root["attrs"]["batches"] == len(batches)
        assert root["attrs"]["patterns"] == 4
        assert sum(b["attrs"]["rows"] for b in batches) == ROWS - TRAIN_ROWS
        for b in batches:
            stages = _names(kids[b["id"]])
            guarded = "gpz.predict.guard" in stages
            assert stages == [s for s in PREDICT_STAGES
                              if guarded or s != "gpz.predict.guard"]
            if guarded:
                # an escalation's exact re-run inside the guard
                guard = kids[b["id"]][2]
                assert _names(kids[guard["id"]]) == (
                    ["gpz.predict.moments"] if forced else [])


def test_counts_per_span(runs):
    *_, recs, _ = runs
    by_id, kids = _tree(recs)
    roots = sorted((r for r in recs if r["parent"] is None),
                   key=lambda r: r["start_ns"])
    train, pred, escalated = roots
    # reads: one per L-BFGS read span
    minimize = kids[train["id"]][1]
    reads = [c for c in kids[minimize["id"]] if c["name"] == "gpz.lbfgs.read"]
    assert all(c["counts"] == {"reads.lbfgs": 1} for c in reads)
    assert minimize["counts"]["reads.lbfgs"] == len(reads)
    for resolve in kids[train["id"]][2:]:
        em = kids[resolve["id"]][1]
        # its iterations, each ending in a read; log_phi's one factor and
        # its rows (complete: none through the masked pass)
        assert set(em["counts"]) == {"prior.em_iterations", "reads.cholesky",
                                     "phi.rows_total"}
        assert em["counts"]["prior.em_iterations"] >= 1
        assert em["counts"]["reads.cholesky"] == 1
        assert em["counts"]["phi.rows_total"] == TRAIN_ROWS
    # a span's counts hold its children's
    for r in recs:
        for name, k in r["counts"].items():
            assert k >= sum(c["counts"].get(name, 0) for c in kids[r["id"]])
    assert train["counts"]["prior.em_iterations"] == sum(
        kids[r["id"]][1]["counts"]["prior.em_iterations"]
        for r in kids[train["id"]][2:])
    # predict: five outputs read back a batch, one coverage read a guarded
    # batch, an escalation (forced) for each; the moment chain's tables
    # built where the first call first needs them (the basis and pair
    # tables, each of the three missing patterns'), and found by every
    # other call of predict_moments_full, the exact re-runs included
    for root, forced in ((pred, False), (escalated, True)):
        guarded = 0
        for b in kids[root["id"]][1:-1]:
            g = int("gpz.predict.guard" in _names(kids[b["id"]]))
            guarded += g
            want = {"reads.readback": 5}
            if g:
                want["reads.coverage"] = 1
                if forced:
                    want["predict.escalations"] = 1
            counts = dict(b["counts"])
            built = counts.pop("predict.tables_built", 0)
            reused = counts.pop("predict.tables_reused", 0)
            assert counts == want
            if built:
                assert root is pred and reused == 0
            else:
                assert reused == 1 + int(forced and g)
        assert guarded == 3    # the three patterns with a band missing
        assert root["counts"].get("predict.escalations", 0) == (
            guarded if forced else 0)
        assert root["counts"].get("predict.tables_built", 0) == (
            2 + 3 if root is pred else 0)


@pytest.mark.parametrize("max_iter, tol", [(3, 1e-10), (100, 1e-4)],
                         ids=["capped", "converged"])
def test_em_iterations_are_the_loops(max_iter, tol):
    """prior.em_iterations counts get_prior's iterations: the cap, or where
    the fixed point (the same recursion in NumPy) stops."""
    mags, _, z, psi, _ = _problem()
    model0 = gpz_tpu_torch.init(mags[:100], z[:100], "VC", M,
                                psi=psi[:100], seed=1, dtype="float64",
                                device="cpu")
    params, cfg = model0.last.params, model0.cfg
    Xn = (mags[:100] - model0.muX) / model0.sdX
    Yc = z[:100, None] - model0.muY
    psi_c = psi[:100] / np.outer(model0.sdX, model0.sdX)
    data = gmodel._make_dataset(Xn, Yc, psi_c, np.ones(100),
                                np.ones(100, bool), torch.float64, "cpu")
    before = trace.COUNTS.get("prior.em_iterations", 0)
    get_prior(params, data, cfg, max_iter=max_iter, tol=tol)
    got = trace.COUNTS["prior.em_iterations"] - before

    ln_n = log_phi(params, cfg, data.X, data.mask, data.psi)[1].numpy()
    N = np.exp(ln_n - ln_n.max(axis=1, keepdims=True))
    prior, it, delta = np.full(M, 1.0 / M), 0, np.inf
    while it < max_iter and delta >= tol:
        w = N * prior
        new = (w / w.sum(axis=1, keepdims=True)).mean(axis=0)
        delta = np.linalg.norm(prior - new) / np.linalg.norm(prior + new)
        prior, it = new, it + 1
    assert got == it
    assert it == max_iter if max_iter == 3 else it < max_iter


def test_records_are_on_the_profilers_clock(runs):
    """Each span starts within 1 ms of the profiler's event of that span."""
    *_, recs, events = runs
    assert len(events) == len(recs)
    for name in {r["name"] for r in recs}:
        mine = sorted(r["start_ns"] for r in recs if r["name"] == name)
        theirs = sorted(s for n, s in events if n == name)
        assert len(mine) == len(theirs), name
        assert max(abs(a - b) for a, b in zip(mine, theirs)) < 1e6, name


def test_outputs_are_the_same_bits_on_and_off(runs):
    off, on, _, _ = runs
    fit_off, fit_on = off[0], on[0]
    for pset in ("last", "best"):
        a = getattr(fit_off, pset).params.flatten()[0]
        b = getattr(fit_on, pset).params.flatten()[0]
        assert torch.equal(a, b)
        assert torch.equal(getattr(fit_off, pset).priors,
                           getattr(fit_on, pset).priors)
    np.testing.assert_array_equal(fit_off.fit_info["trace"]["f"],
                                  fit_on.fit_info["trace"]["f"])
    for p_off, p_on in zip(off[1:], on[1:]):
        for k in OUTPUTS:
            np.testing.assert_array_equal(getattr(p_off, k),
                                          getattr(p_on, k), err_msg=k)


def test_spans_nest_per_thread(monkeypatch):
    """Two threads with spans open at once, inside a span of the main
    thread: each thread's span is a root of its own and holds only the
    counts made on its thread."""
    monkeypatch.setattr(trace, "_enabled", lambda: True)
    both = threading.Barrier(2)

    def work(name):
        with trace.span(name):
            both.wait()
            trace.count("test.thread." + name)
            both.wait()

    trace.reset()
    with trace.span("test.main"):
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        trace.count("test.thread.main")
    recs = {r["name"]: r for r in trace.records()}
    trace.reset()
    for name in ("a", "b", "main"):
        r = recs["test.main" if name == "main" else name]
        assert r["parent"] is None and r["root"] == r["id"], name
        assert r["counts"] == {"test.thread." + name: 1}, name
