"""A cell, a configuration, a traffic mix and a per-layer metric join the
benchmark by new files and new BENCHMARK.json entries alone: a copy of
the benchmark gains a dummy of each, and a tiny run of the new cell in a
fresh process reports the new metric."""

import json
import os
import shutil
import subprocess
import sys

from gpzbench import harness


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
