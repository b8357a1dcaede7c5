"""The full-covariance moment chain's per-model tables
(gpz_tpu_torch.predict: the basis, pair and pattern tables that
predict_moments_full builds once per parameter set), on the CPU.

(a) a call that builds its tables and a later one that finds them give the
    same bits, for VC and GC, every pattern of test_torch_predict_missing,
    with and without psi, the complete branch, a truncated call and its
    escalation, and budgets that tile the pairs into several blocks;
(b) both give the bits that the chain gave when it rebuilt every table on
    every call (tests/data/torch_port_predict_tables.npz, written by this
    file run as a script on that code from the repo's root: `PYTHONPATH=.
    python tests/test_torch_predict_tables.py`; run on a tree with the
    tables it would only compare the tree with itself);
(c) what the tables are built from changing between calls (another
    parameter set, astype, an in-place edit, two models in turn, the chain's
    dtypes) gives a cold call's result;
(d) the counters predict.tables_built and predict.tables_reused through
    model.predict;
(e) the tables go with the parameter set.
"""

import contextlib
import gc
import importlib
import os
import sys
import threading
import weakref

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu_torch
from gpz_tpu_torch import trace
from gpz_tpu_torch.model import ParamSet

from test_torch_predict_diag import as_models, both_sides
from test_torch_predict_missing import M, D, PATTERNS, rows, small_model

tpredict = importlib.import_module("gpz_tpu_torch.predict")

PARENT = os.path.join(os.path.dirname(__file__), "data",
                      "torch_port_predict_tables.npz")

#: budgets that give B = 2 of 12 basis indices at 16 rows in float64
BLOCKS = 800


def _cases():
    cases = {}
    for method in ("VC", "GC"):
        for pattern in PATTERNS:
            for psi in (False, True):
                name = f"{method}-{pattern}-{'psi' if psi else 'nopsi'}"
                cases[name] = dict(method=method, pattern=pattern, psi=psi)
        cases[f"{method}-complete"] = dict(method=method,
                                           pattern="all-observed", psi=True,
                                           complete=True)
    cases["VC-top4"] = dict(method="VC", pattern="one-missing", psi=True,
                            topl=[4])
    cases["VC-top4-escalated"] = dict(method="VC", pattern="one-missing",
                                      psi=True, topl=[4, M])
    cases["VC-blocks"] = dict(method="VC", pattern="two-missing", psi=True,
                              budgets=True)
    cases["VC-complete-blocks"] = dict(method="VC", pattern="all-observed",
                                       psi=True, complete=True, budgets=True)
    return cases


CASES = _cases()


def model_of(method, seed_shift=0):
    """Arrays of the case's model: VC one output, GC two."""
    if method == "VC":
        return small_model("VC", 1 + seed_shift)
    return small_model("GC", 3 + seed_shift, k=2)


def port_side(model):
    return both_sides(*model)[1]


@contextlib.contextmanager
def budgets(on):
    saved = tpredict.PAIR_BUDGET, tpredict.MISSING_PAIR_BUDGET
    if on:
        tpredict.PAIR_BUDGET = tpredict.MISSING_PAIR_BUDGET = BLOCKS
    try:
        yield
    finally:
        tpredict.PAIR_BUDGET, tpredict.MISSING_PAIR_BUDGET = saved


def run(case, side):
    """The case's calls on one port-side model (params, post, priors,
    cfg): its outputs as NumPy arrays, coverage last, each call's in
    turn."""
    tp, tpost, tpri, tcfg = side
    X, psi, mask = rows(2, case["psi"], PATTERNS[case["pattern"]])
    out = []
    with budgets(case.get("budgets", False)):
        for topl in case.get("topl", [None]):
            got = tpredict.predict_moments_full(
                tp, tpost, tpri, tcfg, torch.from_numpy(X),
                torch.from_numpy(mask), torch.from_numpy(psi),
                case.get("complete", False), mix_topl=topl,
                return_coverage=True)
            out += [g.numpy() for g in got]
    return out


def assert_bits(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"output {i}")


@pytest.mark.parametrize("case", list(CASES))
def test_warm_call_gives_the_cold_calls_bits(case):
    side = port_side(model_of(CASES[case]["method"]))
    cold = run(CASES[case], side)
    assert_bits(run(CASES[case], side), cold)
    assert_bits(run(CASES[case], side), cold)


@pytest.mark.parametrize("case", list(CASES))
def test_tables_give_the_rebuilding_chains_bits(case):
    with np.load(PARENT) as parent:
        want = [parent[f"{case}/{i}"]
                for i in range(6 * len(CASES[case].get("topl", [None])))]
    side = port_side(model_of(CASES[case]["method"]))
    assert_bits(run(CASES[case], side), want)      # cold
    assert_bits(run(CASES[case], side), want)      # warm


# --- (c) invalidation -----------------------------------------------------

CASE = CASES["VC-two-missing-psi"]


def cold(model):
    return run(CASE, port_side(model))


def edited(model, field, scale=1.1):
    """The model's arrays with one of P, gamma, w, iSigma_w scaled."""
    arrays, post, priors, cfg = model
    arrays, post = dict(arrays), dict(post)
    if field in arrays:
        arrays[field] = arrays[field] * scale
    else:
        post[field] = post[field] * scale
    return arrays, post, priors, cfg


@pytest.mark.parametrize("field", ["P", "gamma", "w", "iSigma_w"])
def test_in_place_edit_rebuilds(field):
    model = model_of("VC")
    want = cold(edited(model, field))
    side = port_side(model)
    run(CASE, side)
    tp, tpost = side[:2]
    tensor = getattr(tp, field) if hasattr(tp, field) else getattr(tpost,
                                                                  field)
    with torch.no_grad():
        tensor.mul_(1.1)
    assert_bits(run(CASE, side), want)


def test_another_parameter_set_rebuilds():
    """A parameter set made after another is freed (its tensors may take the
    freed ones' addresses) and a set that shares the params with another
    posterior."""
    first, second = model_of("VC"), model_of("VC", seed_shift=10)
    side = port_side(first)
    run(CASE, side)
    del side
    gc.collect()
    side = port_side(second)
    assert_bits(run(CASE, side), cold(second))
    tp, tpost, tpri, tcfg = side
    other = port_side(edited(second, "w", 0.5))[1]
    assert_bits(run(CASE, (tp, other, tpri, tcfg)),
                cold(edited(second, "w", 0.5)))


def test_astype_rebuilds():
    model = model_of("VC")
    tp, tpost, tpri, tcfg = port_side(model)
    pset = ParamSet(tp, tpost, tpri)
    run(CASE, (pset.params, pset.post, pset.priors, tcfg))
    p32 = pset.astype(torch.float32)
    got = run(CASE, (p32.params, p32.post, p32.priors, tcfg))
    fresh = ParamSet(*port_side(model)[:3]).astype(torch.float32)
    assert_bits(got, run(CASE, (fresh.params, fresh.post, fresh.priors,
                                tcfg)))
    assert got[0].dtype == np.float64        # the chain stays in float64
    assert_bits(run(CASE, (pset.params, pset.post, pset.priors, tcfg)),
                cold(model))


def test_two_models_in_turn():
    a, b = model_of("VC"), model_of("VC", seed_shift=20)
    sa, sb = port_side(a), port_side(b)
    want_a, want_b = cold(a), cold(b)
    for _ in range(2):
        assert_bits(run(CASE, sa), want_a)
        assert_bits(run(CASE, sb), want_b)


@pytest.mark.parametrize("env", ["GPZ_VARIANCE_DTYPE", "GPZ_MIX_DTYPE"])
def test_chain_dtype_flip_rebuilds(env, monkeypatch):
    model = model_of("VC")
    side = port_side(model)
    want64 = run(CASE, side)
    monkeypatch.setenv(env, "float32")
    got32 = run(CASE, side)
    assert_bits(got32, cold(model))
    assert np.abs(got32[4] - want64[4]).max() > 0
    monkeypatch.delenv(env)
    assert_bits(run(CASE, side), want64)


def test_block_size_change_rebuilds():
    """The pair tables hold blocks of one size: a call whose rows or budget
    give another B builds them again, and one with the first B again."""
    model = model_of("VC")
    side = port_side(model)
    want = run(CASE, side)
    blocks = dict(CASE, budgets=True)
    assert_bits(run(blocks, side), run(blocks, port_side(model)))
    assert_bits(run(CASE, side), want)


def test_threads_share_one_models_tables():
    """Four threads serve one model, in turns 16 rows (B = 2 under the
    budgets) and their first 8 (B = 4), so that the pair tables are built
    again while other threads use them: every result has the bits of a
    call on a model of its own."""
    model = model_of("VC")
    X, psi, mask = rows(2, True, PATTERNS["two-missing"])

    def call(side, n):
        tp, tpost, tpri, tcfg = side
        return [g.numpy() for g in tpredict.predict_moments_full(
            tp, tpost, tpri, tcfg, torch.from_numpy(X[:n]),
            torch.from_numpy(mask), torch.from_numpy(psi[:n]), False)]

    errors = []

    def work(k):
        try:
            for i in range(4):
                n = (16, 8)[(i + k) % 2]
                assert_bits(call(side, n), want[n])
        except Exception as e:        # reported by the main thread
            errors.append(e)

    with budgets(True):
        want = {n: call(port_side(model), n) for n in (16, 8)}
        side = port_side(model)
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(4)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-4)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


# --- (d) counters, (e) lifetime --------------------------------------------

def counts():
    return (trace.COUNTS.get("predict.tables_built", 0),
            trace.COUNTS.get("predict.tables_reused", 0))


def served_model():
    rng = np.random.default_rng(17)
    _, tm = as_models(*model_of("VC"), muX=rng.standard_normal(D),
                      sdX=0.5 + rng.random(D), muY=np.array([0.3]))
    X = rng.standard_normal((120, D))
    X[:40, 0] = np.nan                       # pattern 1: band 0 missing
    X[40:80, 2] = np.nan                     # pattern 2: band 2 missing
    A = rng.standard_normal((120, D, D)) * 0.2
    return tm, X, A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)


def test_counters_build_once_and_reuse_on_every_later_batch():
    """Three patterns of 40 rows in batches of 16, 16 and 8 rows (B = m at
    each): the first call builds the basis and pair tables in its first
    batch and each missing pattern's tables in the pattern's first batch,
    and reuses them in the other seven; the second call builds nothing and
    reuses its tables in all nine batches."""
    tm, X, psi = served_model()
    before = counts()
    first = gpz_tpu_torch.predict(X, tm, psi=psi, batch_size=16)
    mid = counts()
    assert (mid[0] - before[0], mid[1] - before[1]) == (4, 7)
    second = gpz_tpu_torch.predict(X, tm, psi=psi, batch_size=16)
    after = counts()
    assert (after[0] - mid[0], after[1] - mid[1]) == (0, 9)
    for key in ("mu", "sigma", "phi"):
        np.testing.assert_array_equal(getattr(second, key),
                                      getattr(first, key))


def test_tables_go_with_the_model():
    tm, X, psi = served_model()
    gpz_tpu_torch.predict(X, tm, psi=psi, batch_size=16)
    params = weakref.ref(tm.best.params)
    key = id(tm.best.params)
    tables = tpredict._TABLES[key]
    held = [weakref.ref(tables), weakref.ref(tables.Sigma),
            weakref.ref(tables.pairs[1][0].Cij)]
    held += [weakref.ref(t) for pat in tables.patterns.values() for t in pat]
    del tables
    del tm
    gc.collect()
    assert params() is None
    assert all(r() is None for r in held)
    assert key not in tpredict._TABLES


def parent_outputs():
    """Every case's outputs on a cold model, keyed '<case>/<output>'."""
    return {f"{case}/{i}": out
            for case, spec in CASES.items()
            for i, out in enumerate(run(spec, port_side(
                model_of(spec["method"]))))}


if __name__ == "__main__":
    np.savez_compressed(PARENT, **parent_outputs())
    print(f"wrote {PARENT}: {len(CASES)} cases")
