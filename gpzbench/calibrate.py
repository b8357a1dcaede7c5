"""The readings that a cell's limits are set from, many seeds in one
process: for each seed a run of the cell as it stands, of its control
(the program's lower-precision path) and of planted faults, each with its
check's numbers. The benchmark's own runs never call this.

    python3 gpzbench/calibrate.py --workload <cell> --seeds <s1,s2,...>
        [--seconds 3] [--variants sound,control,half_batch]

One JSON line a run on standard output.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gpzbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--variants", default="sound,control")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from gpzbench import harness

    if not torch.cuda.is_available():
        print("gpzbench: calibration needs a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    # no limit is judged here: every number is printed
    cell.spec["limits"] = {k: float("inf") for k in cell.spec["limits"]}
    for seed in (int(s) for s in args.seeds.split(",")):
        for variant in args.variants.split(","):
            ctx = harness.Context(
                cell=cell, seed=seed, device=torch.device("cuda", 0),
                trace=False, control=variant == "control",
                fault=None if variant in ("sound", "control") else variant)
            t0 = time.perf_counter()
            result = harness.run(cell, ctx, args.seconds, t0)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "variant": variant,
                "seconds": time.perf_counter() - t0,
                "correct": result["correct"],
                "checks": {k: v["value"] if isinstance(v, dict) else v
                           for k, v in result["checks"].items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "peak_gib": result["device"]["memory_peak_bytes"] / 2**30,
            }), flush=True)
            del result, ctx
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
