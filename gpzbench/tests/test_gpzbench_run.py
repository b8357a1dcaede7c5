"""The run's contract: its last line's keys, its refusal without a card or
without the program, and the modules it may not load."""

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

import tiny
from gpzbench import harness

ROOT = harness.ROOT
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _ok_limits(cell_name):
    cell = tiny.tiny_cell(cell_name)
    return tiny.tiny_cell(cell_name, {k: 1.0 for k in cell.spec["limits"]})


@pytest.mark.parametrize("name, trace", [
    ("photoz_m100.serve_nan", False), ("photoz_m100.serve_nan", True),
    ("deep_m1000.train", False), ("deep_m1000.train", True)])
def test_last_line_keys(name, trace):
    cell = _ok_limits(name)
    result = tiny.run(cell, trace=trace)
    keys = list(result)
    assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    want = harness.reported(cell, "per_layer" if trace else "end_to_end")
    got = result["metrics"]
    if trace:
        assert set(got) <= {m["name"] for m in want}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(result["device"])
    else:
        # the card's peak memory is read on a card alone
        assert set(got) == {m["name"] for m in want} - {"train_peak_gib"}
    for m in want:
        if m["name"] in got:
            assert got[m["name"]]["unit"] == m["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    json.dumps(result)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "gpzbench/run.py", "--workload",
         "photoz_m100.serve_nan", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run(ROOT, env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "gpzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_loads_neither_jax_nor_the_jax_package():
    """Every module of gpzbench and a tiny run of a cell of each kind,
    in a fresh process: no top-level name jax, jaxlib, flax or gpz_tpu
    (gpz_tpu_torch, whose name begins with it, is compared whole)."""
    code = f"""
import sys, pkgutil, importlib
sys.path[:0] = [{ROOT!r}, {os.path.dirname(__file__)!r}]
import gpzbench
for mod in pkgutil.walk_packages(gpzbench.__path__, "gpzbench."):
    if ".tests" not in mod.name:
        importlib.import_module(mod.name)
import gpz_tpu_torch, tiny
from gpzbench import harness
for name in ("photoz_m100.serve_nan", "deep_m1000.train"):
    cell = tiny.tiny_cell(name)
    cell = tiny.tiny_cell(name, {{k: 1.0 for k in cell.spec["limits"]}})
    tiny.run(cell, seconds=0.2)
print(harness.forbidden_modules(), "gpz_tpu_torch" in sys.modules)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_host_threads_come_from_the_cell(monkeypatch):
    """A cell's host_threads caps the libraries' thread pools before they
    are imported; a cell without it leaves them as they are."""
    sys.path.insert(0, harness.HERE)
    import run

    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    assert harness.find_cell(tiny.bench(), "photoz_m100.serve_nan").spec[
        "host_threads"] == 1
    assert "host_threads" not in harness.find_cell(
        tiny.bench(), "deep_m1000.train").spec
    run._threads(1)
    assert all(os.environ[v] == "1" for v in
               ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"))


def test_forbidden_names_are_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gpz_tpu_torch_fake", object())
    assert "gpz_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "gpz_tpu.fake", object())
    assert "gpz_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    ref_dir = os.path.join(harness.HERE, "reference")
    for name in os.listdir(ref_dir):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, name)) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"gpz_tpu_torch", "gpz_tpu", "jax",
                                    "jaxlib"}, (name, tops)
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import gpzbench.reference.gpz, gpzbench.reference.lbfgs; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0].startswith('gpz_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
