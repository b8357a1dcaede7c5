"""Cells of BENCHMARK.json cut to a size that the CPU runs in seconds, and
one run of such a cell through the harness with the chip's look skipped."""

from __future__ import annotations

import copy
import os
import time

import torch

from gpzbench import harness

#: the sizes a tiny cell takes in place of its files' (the keys that are
#: there); its limits stay the cell's own unless given
TINY_CFG = {"n_train": 1500, "n_valid": 300, "m": 12, "max_iter": 25}
TINY_TRAFFIC = {"pool_rows": 3000, "request_rows": [60, 180],
                "sizes_cycle": 4, "max_iter": 4}
TINY_SPEC = {"sample_rows": 96}
#: a served model trained far enough that its covariances are as
#: ill-conditioned as a deployment's in kind, so that the float32 control
#: fails the cells' limits as it does at full size
CHECK_CFG = {"n_train": 3000, "n_valid": 600, "m": 30, "max_iter": 120}


def bench():
    return harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))


def tiny_cell(name, limits=None, b=None, cfg=None):
    cell = harness.find_cell(b or bench(), name)
    cell = copy.deepcopy(cell)
    cell.cfg.update(cfg or TINY_CFG)
    for k, v in TINY_TRAFFIC.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    if "sample_rows" in cell.spec:
        cell.spec.update(TINY_SPEC)
    if limits is not None:
        cell.spec["limits"] = dict(limits)
    return cell


def run(cell, seed=2**31 + 12345, seconds=0.5, trace=False, control=False,
        fault=None):
    ctx = harness.Context(cell=cell, seed=seed, device=torch.device("cpu"),
                          trace=trace, control=control, fault=fault)
    return harness.run(cell, ctx, seconds, time.perf_counter())
