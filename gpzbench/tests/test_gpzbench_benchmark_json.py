"""BENCHMARK.json keeps the benchmark's contract: its keys, the characters
of names and units, the counts and lengths, and a file for every name the
harness looks up."""

import json
import os
import re

import pytest

from gpzbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(harness.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return harness.load_json(path)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys_and_counts(bench):
    assert set(bench) == KEYS["top"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            extra = set(entry) - KEYS[kind]
            assert extra <= ({"workloads"} if kind in ("end_to_end",
                                                       "per_layer")
                             else set()), (kind, entry["name"], extra)
            assert KEYS[kind] <= set(entry), (kind, entry["name"])
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    cells = len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, cells // 4)


def test_command_and_paths(bench):
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert 1 <= len(bench["command"]) <= 32
    for word in bench["command"]:
        assert line(word)
    script = bench["command"][1]
    assert any(script.startswith(p + "/") for p in bench["paths"])


def test_names_and_units(bench):
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[kind]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((kind, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in entry and kind in ("configs", "workloads",
                                             "per_layer"):
                    assert line(entry[key]), (entry["name"], key)
    assert len(names) == len(set(names))
    metric_names = [n for k, n in names if k in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    for c in bench["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in bench["paths"])
        assert len(c["reduced"]) <= 16
        cfg = harness.load_json(os.path.join(harness.ROOT, c["file"]))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not key.endswith(("_dim", "_rank"))
            assert not any(w in key for w in WIDTH_WORDS)
            assert key in cfg


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")
    for w in cells:
        cell = harness.find_cell(bench, w)
        e = [m["name"] for m in harness.reported(cell, "end_to_end")]
        assert "setup_s" in e and len(e) >= 2
        assert harness.reported(cell, "per_layer")


def test_every_name_has_its_file(bench):
    here = harness.HERE
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        kind = cell.traffic["kind"]
        assert os.path.exists(os.path.join(here, "traffic", kind + ".py"))
        assert set(cell.spec["limits"])
    for m in bench["per_layer"]:
        assert os.path.exists(os.path.join(here, "metrics",
                                           m["name"] + ".py")), m["name"]


def test_limits_are_set(bench):
    for w in bench["workloads"]:
        cell = harness.find_cell(bench, w["name"])
        for name, limit in cell.spec["limits"].items():
            assert isinstance(limit, float) and limit > 0, (w["name"], name)


def test_json_round_trip(bench):
    assert json.loads(json.dumps(bench)) == bench
