"""The benchmark of gpz_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 gpzbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the cell's data from the seed and builds, trains and warms
up what its traffic needs; the window then measures for --seconds, and
the last line of standard output is one JSON object: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics read from
a torch.profiler trace of the window, and in both whether what the window
produced agrees with the plain reference (`correct`), each compared
number beside its limit under "checks" (also the last lines of standard
error).

Needs a CUDA device and the gpz_tpu_torch package beside this folder; it
exits with a non-zero code and prints no result without either, or if
JAX or the JAX package was loaded. --control (the program's
lower-precision path) and --fault NAME (a planted fault, see faults.py)
show that the check can fail; the benchmark's own runs pass neither.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches():
    """The build and kernel caches of the run, at fixed paths inside the
    checkout (the program builds its kernels into gpz_tpu_torch/_build)."""
    cache = os.path.join(ROOT, ".gpzbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def _threads(n):
    """At most n host threads for the libraries the run loads: set before
    torch and numpy are imported (their pools read it then)."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(n)


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="gpzbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="run the program's lower-precision path")
    ap.add_argument("--fault", default=None,
                    help="plant this fault (its generator's FAULTS)")
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a non-negative integer")
    return args


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    _caches()
    from gpzbench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.find_cell(bench, args.workload)
    threads = cell.spec.get("host_threads")
    if threads:
        _threads(threads)

    import torch

    if threads:
        torch.set_num_threads(threads)
        torch.set_num_interop_threads(threads)

    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell.chips):
        print(f"gpzbench: {args.workload} needs {cell.chips} CUDA device(s);"
              f" found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Context(cell=cell, seed=args.seed,
                          device=torch.device("cuda", 0),
                          trace=bool(args.trace), control=args.control,
                          fault=args.fault)
    result = harness.run(cell, ctx, args.seconds, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"gpzbench: the run loaded {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
