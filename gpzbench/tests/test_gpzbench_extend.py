"""A cell, a configuration, a traffic mix, a per-layer metric and a traffic
kind join the benchmark by new files and new BENCHMARK.json entries
alone (the route in harness.py's docstring): a copy of the benchmark
gains a dummy of each, and a tiny run of the new cell in a fresh process
reports the new metric, or, for the new kind, fails under each fault the
kind declares."""

import json
import os
import shutil
import subprocess
import sys

from gpzbench import harness

#: a generator of a new kind: train.py's jobs, two shared faults and one
#: of its own
NEW_KIND = '''"""train.py's jobs under a kind of their own, which declares its
faults: two shared, and one with a plant of its own."""
import os

from gpzbench import harness

_train = harness.load_module(os.path.join(harness.HERE, "traffic",
                                          "train.py"), "train_reused")
setup, window = _train.setup, _train.window
end_to_end, check = _train.end_to_end, _train.check

FAULTS = ("state_unchanged", "half_batch", "loss_scaled")


def _loss_scaled(real):
    def fake(*args, **kw):
        nlml, aux = real(*args, **kw)
        return nlml * 1.001, aux
    return fake


PLANTS = {"loss_scaled": [("gpz_tpu_torch.model", "nlog_ml",
                           _loss_scaled)]}
'''


def _changed(copy):
    """The benchmark's files that the copy holds otherwise than they are."""
    changed = []
    for top, dirs, files in os.walk(harness.HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            rel = os.path.relpath(os.path.join(top, name), harness.HERE)
            with open(os.path.join(top, name), "rb") as fh:
                if (copy / rel).read_bytes() != fh.read():
                    changed.append(rel)
    return changed


def test_new_cell_by_new_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "gpzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    new = tmp_path / "gpzbench"
    cfg = harness.load_json(str(new / "configs" / "photoz_vc_m100.json"))
    cfg.update(name="dummy_vc_m8", m=8)
    (new / "configs" / "dummy_vc_m8.json").write_text(json.dumps(cfg))
    (new / "traffic" / "serve_tiny.json").write_text(json.dumps({
        "kind": "serve", "loop": "closed, one client", "pool_rows": 500,
        "request_rows": [20, 40], "sizes_cycle": 3,
        "missing": {"first": 0.2, "last": 0.0, "both": 0.0},
        "warmup_requests": 1}))
    (new / "workloads" / "dummy.serve_tiny.json").write_text(json.dumps({
        "sample_rows": 16, "limits": {"mu_err": 1.0, "sigma_err": 1.0}}))
    (new / "metrics" / "dummy.requests.py").write_text(
        "def read(r):\n    return float(r.record.attempted)\n")
    bench["configs"].append({
        "name": "dummy_vc_m8", "source": "a test's dummy",
        "file": "gpzbench/configs/dummy_vc_m8.json", "reduced": [],
        "why": "a test's dummy"})
    bench["workloads"].append({
        "name": "dummy.serve_tiny", "config": "dummy_vc_m8",
        "traffic": "serve_tiny", "chips": 1, "why": "a test's dummy"})
    for m in bench["end_to_end"]:
        if "workloads" in m and m["name"].startswith("serve_"):
            m["workloads"].append("dummy.serve_tiny")
    bench["per_layer"].append({
        "name": "dummy.requests", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "entry points",
        "moves": "serve_rows_per_s", "workloads": ["dummy.serve_tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{str(tmp_path)!r}, {harness.ROOT!r}]
from gpzbench import harness
assert harness.HERE.startswith({str(tmp_path)!r})
bench = harness.load_json({str(tmp_path / "BENCHMARK.json")!r})
cell = harness.find_cell(bench, "dummy.serve_tiny")
cell.cfg.update(n_train=800, n_valid=200, max_iter=10)
for trace in (False, True):
    ctx = harness.Context(cell=cell, seed=3, device=torch.device("cpu"),
                          trace=trace)
    print(json.dumps(harness.run(cell, ctx, 0.3, time.perf_counter())))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    plain, traced = (json.loads(x) for x in out.stdout.splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"serve_rows_per_s", "serve_p95_ms",
                                     "setup_s"}
    assert traced["metrics"]["dummy.requests"]["value"] == traced["attempted"]


def test_new_kind_by_new_files(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "gpzbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    new = tmp_path / "gpzbench"
    train = harness.find_cell(bench, "deep_m1000.train")
    (new / "traffic" / "train_kind.py").write_text(NEW_KIND)
    (new / "traffic" / "train_kind.json").write_text(json.dumps({
        "kind": "train_kind", "max_iter": 4}))
    (new / "workloads" / "photoz_m100.train_kind.json").write_text(
        json.dumps(train.spec))
    bench["workloads"].append({
        "name": "photoz_m100.train_kind", "config": "photoz_vc_m100",
        "traffic": "train_kind", "chips": 1, "why": "a test's dummy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "deep_m1000.train" in m.get("workloads", []):
            m["workloads"].append("photoz_m100.train_kind")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = f"""
import json, sys, time, torch
sys.path[:0] = [{str(tmp_path)!r}, {harness.ROOT!r}]
from gpzbench import faults, harness
assert harness.HERE.startswith({str(tmp_path)!r})
bench = harness.load_json({str(tmp_path / "BENCHMARK.json")!r})
cell = harness.find_cell(bench, "photoz_m100.train_kind")
cell.cfg.update(n_train=1500, n_valid=300, m=12, max_iter=25)
gen = harness.generator("train_kind")
for fault in (None,) + faults.of_generator(gen):
    ctx = harness.Context(cell=cell, seed=2**31 + 7, device=torch.device("cpu"),
                          trace=False, fault=fault)
    result = harness.run(cell, ctx, 0.3, time.perf_counter())
    print(json.dumps([fault, result["correct"], sorted(result["metrics"])]))
"""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), harness.ROOT]))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(x) for x in out.stdout.splitlines()[-4:]]
    assert runs == [
        [None, True, ["setup_s", "train_iters_per_s"]],
        ["state_unchanged", False, ["setup_s", "train_iters_per_s"]],
        ["half_batch", False, ["setup_s", "train_iters_per_s"]],
        ["loss_scaled", False, ["setup_s", "train_iters_per_s"]]], runs
    collected = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q",
         "-p", "no:cacheprovider", "gpzbench/tests/test_gpzbench_checks.py"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path, env=env)
    assert collected.returncode == 0, collected.stdout[-3000:]
    ids = collected.stdout
    for case in ("None-None", "control-None", "None-state_unchanged",
                 "None-half_batch", "None-loss_scaled"):
        assert f"photoz_m100.train_kind-{case}]" in ids, ids[-3000:]
    for name in ("faults.py", "harness.py"):
        with open(os.path.join(harness.HERE, name), "rb") as fh:
            assert (new / name).read_bytes() == fh.read(), name
    assert _changed(new) == []
