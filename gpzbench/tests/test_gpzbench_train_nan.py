"""The train_nan kind and its two readers: a tiny run of the
bands9_m100.train_nan cell in a fresh process is correct, reports the
masked pass's share of the rows when traced, and is not correct under
the control or any fault its generator declares; the readers on
synthetic records, and on a program that counts no design-matrix rows."""

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import tiny
from gpzbench import harness

CELL = "bands9_m100.train_nan"


def test_tiny_cell_in_a_fresh_process():
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{harness.ROOT!r}, {os.path.dirname(__file__)!r}]
import tiny
from gpzbench import faults, harness
gen = harness.generator("train_nan")
cases = [(None, False, True), (None, True, False)] + [
    (f, False, False) for f in faults.of_generator(gen)]
for fault, control, trace in cases:
    r = tiny.run(tiny.tiny_cell({CELL!r}), fault=fault, control=control,
                 trace=trace)
    print(json.dumps([fault, control, r["correct"],
                      {{k: v["value"] for k, v in r["metrics"].items()}}]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(x) for x in out.stdout.splitlines()[-4:]]
    assert [r[:3] for r in runs] == [
        [None, False, True], [None, True, False],
        ["state_unchanged", False, False], ["half_batch", False, False]]
    traced = runs[0][3]
    assert traced["train.masked_row_share"] == 100.0
    assert "train.masked_solve_share" not in traced      # no device here
    assert set(runs[1][3]) == {"train_iters_per_s", "setup_s"}


def test_one_sample_in_an_order_of_the_seed():
    """Every seed gets the configuration's one sample, bands lost by the
    mix's shares, its training rows and its validation rows each in an
    order of the seed's own."""
    cell = tiny.tiny_cell(CELL)
    gen = harness.generator("train_nan")
    draws = [gen.problem(cell.cfg, cell.traffic["missing"], seed)
             for seed in (2**31 + 77, 2**31 + 77, 2**31 + 78)]
    X, _, _, tr, va = draws[0]
    n = len(X)
    nan = np.isnan(X)
    assert X.shape[1] == 9 and not nan[:, 1:8].any()
    shares = cell.traffic["missing"]
    assert (nan[:, 0] & ~nan[:, 8]).sum() == round(shares["first"] * n)
    assert (nan[:, 8] & ~nan[:, 0]).sum() == round(shares["last"] * n)
    assert (nan[:, 0] & nan[:, 8]).sum() == round(shares["both"] * n)
    assert nan[tr].any() and nan[va].any()
    for a, b in zip(draws[0], draws[1]):
        assert np.array_equal(a, b, equal_nan=True)
    other = draws[2]
    assert not np.array_equal(X, other[0], equal_nan=True)
    for rows in (tr, va):
        for a, b in zip(draws[0][:3], other[:3]):
            key = np.lexsort(np.nan_to_num(a[rows].reshape(rows.sum(), -1),
                                           nan=-1e9).T)
            key2 = np.lexsort(np.nan_to_num(b[rows].reshape(rows.sum(), -1),
                                            nan=-1e9).T)
            assert np.array_equal(a[rows][key], b[rows][key2],
                                  equal_nan=True)


def _read(name, r=None):
    return harness.load_module(
        os.path.join(harness.HERE, "metrics", name + ".py"),
        "gpzbench_metric_" + name).read(r)


def _rec(name, counts, i):
    return {"name": name, "start_ns": i, "end_ns": i + 1, "id": i,
            "parent": None, "root": i, "attrs": {}, "counts": counts}


@pytest.fixture
def recorded(monkeypatch):
    from gpz_tpu_torch import trace

    def use(recs):
        monkeypatch.setattr(trace, "records", lambda: list(recs))
    return use


def test_masked_row_share(recorded):
    recorded([
        _rec("gpz.lbfgs.eval", {"phi.rows_masked": 700,
                                "phi.rows_total": 700}, 1),
        _rec("gpz.lbfgs.eval", {"phi.rows_masked": 280,
                                "phi.rows_total": 700}, 2),
        # a score's or a resolve's rows are not the objective's
        _rec("gpz.lbfgs.score", {"phi.rows_masked": 0,
                                 "phi.rows_total": 100}, 3),
        _rec("gpz.prior.em", {"phi.rows_masked": 700,
                              "phi.rows_total": 700}, 4)])
    assert _read("train.masked_row_share") == pytest.approx(70.0)


def test_masked_row_share_without_the_counters(recorded, monkeypatch):
    # the parent commit's program: spans, but no design-matrix counters
    recorded([_rec("gpz.lbfgs.eval", {"reads.cholesky": 3}, 1)])
    assert _read("train.masked_row_share") is None
    recorded([])
    assert _read("train.masked_row_share") is None
    monkeypatch.setitem(sys.modules, "gpz_tpu_torch.trace", None)
    monkeypatch.delattr("gpz_tpu_torch.trace", raising=False)
    assert _read("train.masked_row_share") is None


def test_masked_solve_share():
    device_s = {
        "void potrf_cta_lower_batch<double, double, 16>(int, int)": 2.0,
        "void potrf_set_info<256>(int, int, int*)": 0.1,
        "void batch_trsm_left_kernel<double, 64, 4, 3>(...)": 1.0,
        "void batch_trsm_right_kernel<double, 64, 4, 3>(...)": 0.5,
        "void trsm_batch_left_lower_kernel<double>(...)": 0.4,
        # the objective's m x m solve and everything else: not counted
        "void trsm_left_kernel<int, double, 256, 4>(...)": 0.3,
        "void cutlass::Kernel2<cutlass_80_tensorop_d884gemm>(...)": 4.0}
    r = types.SimpleNamespace(trace={"busy_s": 10.0, "device_s": device_s})
    assert _read("train.masked_solve_share", r) == pytest.approx(40.0)
    r.trace["device_s"] = {"cutlass gemm": 4.0}
    assert _read("train.masked_solve_share", r) is None
    r.trace.update(busy_s=0.0, device_s={})
    assert _read("train.masked_solve_share", r) is None
