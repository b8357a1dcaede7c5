"""The check can fail. At a tiny size on the CPU, with each cell's
committed limits: a sound run is correct; the program's lower-precision
path (the control) is not; nor is a run with any fault the cell can have
planted underneath its timed path (faults.FAULTS). The card test does the
same at the cells' own sizes with a short window."""

import pytest

import tiny
from gpzbench import faults, harness

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


def _cases():
    for name in CELLS:
        kind = harness.find_cell(tiny.bench(), name).traffic["kind"]
        yield name, None, None
        yield name, "control", None
        for fault in faults.FAULTS[kind]:
            yield name, None, fault


@pytest.mark.parametrize("name, control, fault", list(_cases()))
def test_tiny_run(name, control, fault):
    cell = tiny.tiny_cell(name, cfg=tiny.CHECK_CFG if "serve" in name
                          else None)
    if "sample_rows" in cell.spec:
        cell.spec["sample_rows"] = 10**9     # every answer of the window
    result = tiny.run(cell, control=bool(control), fault=fault)
    assert result["correct"] is (control is None and fault is None), \
        result["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    import time

    cell = harness.find_cell(tiny.bench(), name)
    for control in (False, True):
        ctx = harness.Context(cell=cell, seed=2**31 + 99, device=card,
                              trace=False, control=control)
        result = harness.run(cell, ctx, 5.0, time.perf_counter())
        assert result["correct"] is (not control), result["checks"]


def test_every_step_of_every_job_is_compared(monkeypatch):
    """A job that stops after three of its iterations, in set-up and in
    the window, fails the check: each job is followed for all of its
    first `steps` iterations, not its first three alone."""
    from gpz_tpu_torch import model as gm

    real = gm.minimize

    def three(fun, x0, *, max_iter=200, **kw):
        return real(fun, x0, max_iter=min(max_iter, 3), **kw)

    cell = tiny.tiny_cell("deep_m1000.train")
    assert cell.spec["steps"] > 3 and cell.traffic["max_iter"] > 3
    assert tiny.run(cell)["correct"] is True
    monkeypatch.setattr(gm, "minimize", three)
    result = tiny.run(cell)
    assert result["correct"] is False
    checks = result["checks"]
    assert checks["loss_gap"]["value"] > checks["loss_gap"]["limit"]
