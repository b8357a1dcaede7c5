"""One run of one cell, driven by the names in BENCHMARK.json: the cell's
file (workloads/<cell>.json), its configuration (the file BENCHMARK.json
names), its traffic mix (traffic/<traffic>.json), the generator of the
mix's kind (traffic/<kind>.py) and each per-layer metric's reader
(metrics/<metric>.py). A new cell, configuration, mix or metric is new
files and entries; nothing here names one.

A generator module has four functions:
  setup(ctx) -> state            data, model, warm-up (counted as set-up)
  window(state, seconds, span)   the measured loop; returns its record
  end_to_end(state, record)      {metric: value} of the cell's metrics
  check(state, record)           [(name, value, limit)] against the
                                 reference, run once the window closed
and may keep attributes on its record for the readers (`Reading`). It
declares the faults its cells can have (faults.py):
  FAULTS                         names of the faults, shared or its own
  PLANTS                         {name: [(module, attribute, wrapper)]},
                                 optional, for faults of its own

A new cell joins by these steps alone, none of which edits a file or an
entry that is there:
  1. new files: its configuration (configs/), its traffic mix
     (traffic/<traffic>.json), the generator of a new kind
     (traffic/<kind>.py), its own file (workloads/<cell>.json: the
     limits and sizes of its check) and the readers of new per-layer
     metrics (metrics/<metric>.py);
  2. new entries in BENCHMARK.json: the configuration, the cell and
     any new metric;
  3. its name appended to the `workloads` list of each end-to-end metric
     that its generator reports, and of each per-layer metric whose
     reader applies to it.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: top-level module names that no run may load: the JAX package and JAX
FORBIDDEN = ("jax", "jaxlib", "flax", "gpz_tpu")

#: the longest window a traced run measures: reading a profile of a
#: host-bound window costs about three times the window, and a traced run
#: has to end within 360 s
TRACE_WINDOW_S = 20.0


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict           # the configuration's file
    traffic: dict       # the traffic mix's file
    spec: dict          # the cell's file: limits and sizes of its check
    entry: dict         # the cell's entry in BENCHMARK.json
    bench: dict


def generator(kind: str):
    """The generator module of traffic kind `kind` (traffic/<kind>.py)."""
    return load_module(os.path.join(HERE, "traffic", kind + ".py"),
                       "gpzbench_traffic_" + kind)


def find_cell(bench: dict, name: str, root: str = ROOT) -> Cell:
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == entry["config"])
    return Cell(
        name=name, chips=entry["chips"],
        cfg=load_json(os.path.join(root, cfg_entry["file"])),
        traffic=load_json(os.path.join(HERE, "traffic",
                                       entry["traffic"] + ".json")),
        spec=load_json(os.path.join(HERE, "workloads", name + ".json")),
        entry=entry, bench=bench)


def reported(cell: Cell, kind: str) -> list:
    """The cell's metrics of `kind` ("end_to_end" or "per_layer"): an
    end-to-end metric without `workloads` is every cell's; a per-layer one
    without it is every cell's that reports the metric it moves."""
    e2e = [m["name"] for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if kind == "end_to_end":
        return [m for m in cell.bench["end_to_end"] if m["name"] in e2e]
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and m["moves"] in e2e]


@dataclasses.dataclass
class Context:
    cell: Cell
    seed: int
    device: object
    trace: bool
    control: bool = False
    fault: str = None


@dataclasses.dataclass
class Reading:
    """What a per-layer reader reads: the cell, the window's record (the
    generator's), the probes' records and the trace's summary."""
    cell: Cell
    record: object
    probes: object
    trace: dict


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def device_info(torch, device, peak: int) -> dict:
    info = {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        info.update(platform="gpu",
                    kind=torch.cuda.get_device_name(device),
                    count=1)
        info["power_limit"] = _power_limit()
    return info


def _power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=False).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return None
    return out.splitlines()[0] if out else None


def run(cell: Cell, ctx: Context, seconds: float, t_start: float) -> dict:
    """The run's result line (a dict), its checks printed to stderr. The
    environment is as it was afterwards (a control sets some of it)."""
    env = dict(os.environ)
    try:
        return _run(cell, ctx, seconds, t_start)
    finally:
        os.environ.clear()
        os.environ.update(env)


def _run(cell, ctx, seconds, t_start):
    import torch

    from gpzbench import faults, probes as probes_mod, trace as trace_mod

    gen = generator(cell.traffic["kind"])
    cuda = ctx.device.type == "cuda"
    probes = probes_mod.Probes(cell.cfg["m"]) if ctx.trace else None
    with faults.planted(ctx.fault, gen):
        state = gen.setup(ctx)
        gc.collect()
        peak = 0
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        if probes is not None:
            probes.install(lambda name: trace_mod.span(name, True))
        try:
            with trace_mod.profiled(ctx.trace) as prof:
                with trace_mod.span(trace_mod.WINDOW, ctx.trace):
                    record = gen.window(
                        state,
                        min(seconds, TRACE_WINDOW_S) if ctx.trace
                        else seconds,
                        lambda n: trace_mod.span(n, ctx.trace))
        finally:
            if probes is not None:
                probes.remove()
    if cuda:
        peak = max(peak, torch.cuda.max_memory_allocated())
    print("window", json.dumps(_describe(record)), file=sys.stderr)
    device = device_info(torch, ctx.device, peak)
    summary = None
    if ctx.trace:
        t_trace = time.perf_counter()
        summary = trace_mod.summarise(prof) if cuda else {
            "busy_s": 0.0, "window_s": record.window_s, "device_s": {},
            "breakdown": {"device_ops": [], "idle_gaps": []}}
        del prof
        print(f"trace read in {time.perf_counter() - t_trace:.1f} s",
              file=sys.stderr)
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        values = _per_layer(cell, Reading(cell, record, probes, summary))
    else:
        values = gen.end_to_end(state, record)
        values["setup_s"] = setup_s
    units = {m["name"]: m["unit"] for m in cell.bench["end_to_end"]
             + cell.bench["per_layer"]}
    kind = "per_layer" if ctx.trace else "end_to_end"
    metrics = {m["name"]: {"value": values[m["name"]],
                           "unit": units[m["name"]]}
               for m in reported(cell, kind) if m["name"] in values}
    checks, error = [], None
    try:
        checks = gen.check(state, record)
    except Exception as exc:   # a failed reference or comparison: not correct
        import traceback

        traceback.print_exc()
        error = f"{type(exc).__name__}: {exc}"
    correct = error is None and record.failed == 0 and bool(checks) and all(
        lim is not None and v == v and v <= lim for _, v, lim in checks)
    result = {"correct": correct, "attempted": record.attempted,
              "failed": record.failed, "metrics": metrics, "device": device}
    if summary is not None:
        result["breakdown"] = summary["breakdown"]
    # a number that is not finite fails, and is written as null (strict
    # JSON has no NaN)
    result["checks"] = {name: {"value": v if v == v and abs(v) != float("inf")
                               else None, "limit": lim}
                        for name, v, lim in checks}
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r}", file=sys.stderr)
    if error is not None:
        result["checks"]["error"] = error
        print(f"check failed to run: {error}", file=sys.stderr)
    return result


def _describe(record) -> dict:
    """The window's numbers and its jobs' (without their traces), for
    whoever reads the run's standard error."""
    out = {k: v for k, v in vars(record).items()
           if isinstance(v, (int, float, dict))}
    if hasattr(record, "jobs"):
        out["jobs"] = [{k: v for k, v in j.items() if k != "f"}
                       for j in record.jobs]
    return out


def _per_layer(cell, reading) -> dict:
    """{metric: value} of the cell's per-layer metrics whose reader found
    something to read."""
    values = {}
    for m in reported(cell, "per_layer"):
        reader = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                             "gpzbench_metric_" + m["name"])
        value = reader.read(reading)
        if value is not None:
            values[m["name"]] = value
    return values
