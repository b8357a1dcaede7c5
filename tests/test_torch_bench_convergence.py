"""gpz_tpu_torch.bench_convergence against the root bench_convergence.py
(which imports no JAX at module level): the seeded problem, the time-to-
target attribution on seeded traces, the JSON records' keys, and the
--target refusal. On the CPU, at a small size; the full-size run is
chip_smoke.py's phase 8."""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread per test process)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_convergence as jax_bench  # noqa: E402
from gpz_tpu_torch import bench_convergence as bench  # noqa: E402

TARGET = -2.67041538
TOL = 1e-3 * abs(TARGET)


def seeded_trace(seed, n, hit_at=None):
    """A decreasing f trace of n + 1 points that first reaches the band at
    `hit_at` (never, if None), and its cumulative evaluation counts."""
    rng = np.random.default_rng(seed)
    f = TARGET + 1.0 + np.cumsum(-rng.random(n + 1) * 1e-3)
    if hit_at is not None:
        f[hit_at:] = TARGET + TOL * rng.uniform(-2.0, 1.0, n + 1 - hit_at)
        f[hit_at] = TARGET + TOL * 0.5
    fev = np.cumsum(rng.integers(1, 4, n + 1)).astype(np.int32)
    return f, fev


CASES = {
    "hit": dict(seed=0, n=200, hit_at=120),
    "hit-at-0": dict(seed=1, n=50, hit_at=0),
    "hit-at-end": dict(seed=2, n=80, hit_at=80),
    "no-hit": dict(seed=3, n=100, hit_at=None),
    "sentinel": dict(seed=4, n=150, hit_at=90, sentinel=40),
    "sentinel-after-hit": dict(seed=5, n=150, hit_at=30, sentinel=60),
    "short-fevals": dict(seed=6, n=150, hit_at=120, short=100),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_time_to_target_equals_jax(case):
    spec = dict(CASES[case])
    sentinel = spec.pop("sentinel", None)
    short = spec.pop("short", None)
    f, fev = seeded_trace(**spec)
    if sentinel is not None:
        fev[sentinel] = -1
    if short is not None:
        fev = fev[:short]
    total_s, total_evals = 37.25, int(fev[-1]) if fev[-1] > 0 else 300
    want = jax_bench.time_to_target(f, fev, total_s, total_evals, TARGET, TOL)
    got = bench.time_to_target(f, fev, total_s, total_evals, TARGET, TOL)
    if spec["hit_at"] is None:
        assert want is None and got is None
    else:
        assert want is not None and got == want


def test_constants_and_statuses_are_jax():
    for name in ("N_TRAIN", "N_VALID", "M", "SEED", "MAX_ITER",
                 "MAX_ATTEMPTS", "CONVERGED_STATUSES"):
        assert getattr(bench, name) == getattr(jax_bench, name), name
    assert os.path.samefile(bench.TARGET_FILE, jax_bench.TARGET_FILE)


def test_build_problem_bit_equal_to_jax():
    got, want = bench.build_problem(), jax_bench.build_problem()
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def small_problem(monkeypatch):
    """The module's constants cut to a CPU size."""
    for name, value in (("N_TRAIN", 600), ("N_VALID", 200), ("M", 6),
                        ("MAX_ITER", 4)):
        monkeypatch.setattr(bench, name, value)


def test_main_prints_the_jax_scripts_records(monkeypatch, capsys, tmp_path):
    """Both trainings and the metric line, on the CPU at a small size: the
    run records carry JAX's summarize keys (JAX's summarize applied to the
    same trained model gives the same record), and the record is written
    only to --out."""
    small_problem(monkeypatch)
    models = []
    real = bench.run_training

    def keep(*a, **kw):
        models.append(real(*a, **kw))
        return models[-1]

    monkeypatch.setattr(bench, "run_training", keep)
    out = tmp_path / "record.json"
    bench.main(["--device", "cpu", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    runs, metric, stamps = lines[:2], lines[2], lines[3]
    assert [r["label"] for r in runs] == ["fresh_process", "process_warm"]
    for rec, (model, secs) in zip(runs, models):
        fit = dict(model.fit_info)
        jax_model = types.SimpleNamespace(fit_info=fit, best=model.best)
        want, f, fev = jax_bench.summarize(jax_model, secs, rec["label"])
        t_hit = jax_bench.time_to_target(
            f, fev, want["train_seconds"], want["fun_evals"], TARGET, TOL)
        want["target_nlml"] = TARGET
        want["reached_target"] = t_hit is not None
        want["seconds_to_target"] = None if t_hit is None else round(t_hit, 2)
        assert list(rec) == list(want)
        assert rec == want
        assert rec["iterations"] == 4 and np.isfinite(rec["best_nlml"])
    assert list(metric) == ["metric", "value", "unit", "vs_baseline",
                            "process_warm_value"]
    assert metric["metric"] == "seconds_to_f64_logML_VC_m100_n70k"
    assert metric["value"] == runs[0]["seconds_to_target"]
    assert set(stamps["timestamps"]) >= {"import", "problem",
                                         "fresh_process_start",
                                         "process_warm_end"}
    assert stamps["launches"] == {"vc_lnphi_fwd": 0, "vc_lnphi_bwd": 0}
    saved = json.loads(out.read_text())
    assert saved["runs"] == runs and saved["target"]["target_nlml"] == TARGET


def fake_model(status):
    fit = {"trace": {"f": np.array([1.0, 0.5, 0.25]),
                     "fevals": np.array([1, 2, 3], np.int32)},
           "iterations": 2, "fun_evals": 3, "status": status,
           "seconds": 0.5}
    return types.SimpleNamespace(fit_info=fit,
                                 best=types.SimpleNamespace(score=1.5))


@pytest.mark.parametrize("status", [5, 6, 0])
def test_target_refuses_a_run_that_did_not_finish(monkeypatch, capsys,
                                                  tmp_path, status):
    monkeypatch.setattr(bench, "build_problem", lambda: None)
    monkeypatch.setattr(bench, "run_training",
                        lambda *a, **kw: (fake_model(status), 0.5))
    out = tmp_path / "target.json"
    with pytest.raises(SystemExit, match="REFUSING"):
        bench.main(["--target", "--device", "cpu", "--out", str(out)])
    rec = json.loads(capsys.readouterr().out.splitlines()[0])
    assert rec["status"] == status and not rec["converged"]
    assert not out.exists()


def test_target_writes_only_where_out_says(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(bench, "build_problem", lambda: None)
    seen = []

    def fake(problem, dtype="float32", device="cuda"):
        seen.append(dtype)
        return fake_model(4), 0.5

    monkeypatch.setattr(bench, "run_training", fake)
    before = os.stat(bench.TARGET_FILE).st_mtime_ns
    out = tmp_path / "target.json"
    bench.main(["--target", "--device", "cpu", "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert seen == ["float64"] and lines[0]["status_name"] == "early_stop"
    payload = lines[1]
    assert payload["target_nlml"] == 0.25 and payload["run"] == lines[0]
    assert list(payload) == ["target_nlml", "best_valid_ll", "config", "run"]
    assert json.loads(out.read_text()) == payload
    assert os.stat(bench.TARGET_FILE).st_mtime_ns == before


def test_defaults_to_the_gpu(monkeypatch):
    """run_training and main without a device go to the CUDA device: on a
    machine without one they raise torch's error."""
    small_problem(monkeypatch)
    if torch.cuda.is_available():
        model, _ = bench.run_training(bench.build_problem())
        assert model.best.params.P.device.type == "cuda"
        return
    for call in (lambda: bench.run_training(bench.build_problem()),
                 lambda: bench.main(["--fresh-only"])):
        with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
            call()
