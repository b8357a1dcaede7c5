"""North-star wall-clock benchmark (bench_convergence.py on gpz_tpu_torch):
the synthetic-SDSS VC m=100 heteroscedastic problem trained to the float64
log-ML of record, in seconds.

    python -m gpz_tpu_torch.bench_convergence [--device cuda]
    python -m gpz_tpu_torch.bench_convergence --fresh-only [--out PATH]
    python -m gpz_tpu_torch.bench_convergence --target [--out PATH]

The target is read from benchmarks/convergence_target.json (-2.67041538,
reached within 1e-3·|target|); nothing here writes it. By default two
identical trainings run in one process: the first pays the process's
first-use costs (cuBLAS and the kernel library's first calls), the second
is process-warm. Each prints one JSON line with the JAX script's keys, then
the metric line {"metric": "seconds_to_f64_logML_VC_m100_n70k", ...}.
`--fresh-only` runs one training labelled fresh_process. `--target` trains
on the given device in float64, prints the run, refuses one whose optimizer
status is not a genuine termination (CONVERGED_STATUSES), and prints the
target record. A record is written only where `--out` names a file.

The port trains float64 on one schedule, so the JAX script's solve modes,
its f32 ablation (--study) and its per-phase attribution have nothing to act
on: seconds_to_target pools the training's wall clock by objective
evaluations (`time_to_target`), and the phase_* keys are null. A last line
{"timestamps": ..., "launches": ...} gives the process's own clock
(time.time()) at this module's import, at the CUDA context, after the kernel
library's load and around each training, so a caller can break the
process's wall clock down, and the design-matrix kernels' launches
(ops.vc_phi's counters; 0 off the GPU).
"""

from __future__ import annotations

import argparse
import json
import os
import time

_T_IMPORT = time.time()

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gpz_tpu_torch.ops import vc_phi  # noqa: E402

TARGET_FILE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "convergence_target.json",
)

N_TRAIN = 70_000
N_VALID = 10_000
M = 100
SEED = 1
# iteration budget, not part of the metric: seconds_to_target attributes the
# wall clock up to the band crossing, and unused budget costs nothing
MAX_ITER = 320
MAX_ATTEMPTS = 50

#: terminal statuses that mean "the optimizer genuinely finished"
#: (optim.lbfgs codes: OPTIMAL, STEP_TOO_SMALL, MAX_ITER, EARLY_STOP).
#: LS_FAILED (5) / NO_DESCENT (6) runs never define a target
CONVERGED_STATUSES = {1: "optimal", 2: "step_too_small",
                      3: "max_iter", 4: "early_stop"}


def build_problem():
    """(X, Y, psi, training, validation): synthetic_sdss(N_TRAIN + N_VALID,
    seed SEED), psi = errs**2, the first N_TRAIN rows train and the rest
    validate; the JAX script's arrays, bit for bit."""
    from gpz_tpu_torch.data import synthetic_sdss

    mags, errs, z = synthetic_sdss(N_TRAIN + N_VALID, filters=5, seed=SEED)
    psi = errs**2                      # ref demo_photoz.m:54-62: Psi = e^2
    tr = np.zeros(len(z), bool)
    va = np.zeros(len(z), bool)
    tr[:N_TRAIN] = True
    va[N_TRAIN:] = True
    return mags, z, psi, tr, va


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_training(problem, dtype="float32", device="cuda"):
    """init, then train timed alone; returns (model, seconds). The port
    trains in float64 whatever `dtype` is, which sets only the dtype the
    trained model is stored in."""
    import gpz_tpu_torch

    X, Y, psi, tr, va = problem
    model = gpz_tpu_torch.init(X, Y, "VC", M, heteroscedastic=True,
                               training=tr, psi=psi, seed=SEED, dtype=dtype,
                               device=device)
    _sync(device)
    t0 = time.perf_counter()
    model = gpz_tpu_torch.train(
        model, X, Y, training=tr, validation=va, psi=psi,
        max_iter=MAX_ITER, max_attempts=MAX_ATTEMPTS, verbose=False,
    )
    _sync(device)
    return model, time.perf_counter() - t0


def summarize(model, seconds, label):
    """(the run's JSON record, f trace, fevals trace) with the JAX script's
    keys; the phase_* keys are None (one schedule)."""
    tr = model.fit_info["trace"]
    n_it = model.fit_info["iterations"]
    status = int(model.fit_info["status"])
    f = np.asarray(tr["f"][: n_it + 1], dtype=np.float64)
    fev = np.asarray(tr.get("fevals", np.full(n_it + 1, np.nan)))
    out = {
        "label": label,
        "final_nlml": float(f[n_it]),
        "best_nlml": float(np.nanmin(f)),
        "best_valid_ll": float(model.best.score),
        "iterations": int(n_it),
        "fun_evals": int(model.fit_info["fun_evals"]),
        "status": status,
        "status_name": CONVERGED_STATUSES.get(status, f"FAILED({status})"),
        "converged": status in CONVERGED_STATUSES,
        "seconds_total": round(seconds, 2),
        "train_seconds": round(model.fit_info["seconds"], 2),
        "phase_seconds": None,
        "phase_iterations": None,
        "phase1_iterations": None,
        "prep_seconds": None,
        "between_seconds": None,
        "finalize_seconds": None,
    }
    return out, f, fev


def time_to_target(f, fev, total_seconds, total_evals, target, tol):
    """Seconds until the trace first reaches target (+tol), attributing the
    wall clock by cumulative objective evaluations (the JAX script's pooled
    attribution); None if it never does. A fevals trace with the -1
    "unrecorded" sentinel, or shorter than the hit, falls back to the hit's
    share of the trace's indices."""
    hit = np.nonzero(f <= target + tol)[0]
    if len(hit) == 0:
        return None
    i = int(hit[0])
    if i < len(fev) and bool(np.all(np.asarray(fev[: i + 1]) >= 0)):
        evals_at = float(fev[i])
    else:
        evals_at = total_evals * (i / max(len(f) - 1, 1))
    return total_seconds * evals_at / max(total_evals, 1)


def _write(path, record):
    with open(path, "w") as fh:
        json.dump(record, fh, indent=1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gpz_tpu_torch.bench_convergence")
    ap.add_argument("--target", action="store_true",
                    help="train in float64 on --device and print the "
                    "target record (written only to --out)")
    ap.add_argument("--fresh-only", action="store_true",
                    help="one training in this (fresh) process")
    ap.add_argument("--out", default=None,
                    help="write the run's record (JSON) to this file")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: cuda)")
    args = ap.parse_args(argv)

    stamps = {"import": _T_IMPORT}
    if torch.device(args.device).type == "cuda":
        torch.zeros(1, device=args.device)
        torch.cuda.synchronize(args.device)
        stamps["cuda_context"] = time.time()
        vc_phi.library()
        stamps["kernel_library"] = time.time()
    problem = build_problem()
    stamps["problem"] = time.time()

    if args.target:
        model, secs = run_training(problem, dtype="float64",
                                   device=args.device)
        out, _, _ = summarize(model, secs,
                              f"f64_{torch.device(args.device).type}")
        print(json.dumps(out), flush=True)
        if not out["converged"]:
            raise SystemExit(
                f"REFUSING to write target: f64 run ended "
                f"{out['status_name']} after {out['iterations']} iterations "
                f"— a target must come from a genuinely finished run"
            )
        payload = {
            "target_nlml": out["best_nlml"],
            "best_valid_ll": out["best_valid_ll"],
            "config": {"n_train": N_TRAIN, "m": M, "seed": SEED,
                       "max_iter": MAX_ITER, "max_attempts": MAX_ATTEMPTS,
                       "dtype": "float64",
                       "platform": torch.device(args.device).type},
            "run": out,
        }
        print(json.dumps(payload), flush=True)
        if args.out:
            _write(args.out, payload)
        return

    with open(TARGET_FILE) as fh:
        target = json.load(fh)
    tgt = target["target_nlml"]
    # within 0.1% of the target: "converged to the same log-ML"
    tol = 1e-3 * abs(tgt)

    labels = ("fresh_process",) if args.fresh_only else (
        "fresh_process", "process_warm")
    results = []
    for label in labels:
        stamps[f"{label}_start"] = time.time()
        model, secs = run_training(problem, device=args.device)
        stamps[f"{label}_end"] = time.time()
        out, f, fev = summarize(model, secs, label)
        t_hit = time_to_target(f, fev, out["train_seconds"],
                               out["fun_evals"], tgt, tol)
        out["target_nlml"] = tgt
        out["reached_target"] = t_hit is not None
        out["seconds_to_target"] = None if t_hit is None else round(t_hit, 2)
        results.append(out)
        print(json.dumps(out), flush=True)
    if not args.fresh_only:
        fresh, warm = results
        print(json.dumps({
            "metric": "seconds_to_f64_logML_VC_m100_n70k",
            "value": fresh["seconds_to_target"],
            "unit": "s",
            "vs_baseline": (
                None if fresh["seconds_to_target"] is None
                else round(60.0 / fresh["seconds_to_target"], 3)
            ),
            "process_warm_value": warm["seconds_to_target"],
        }), flush=True)
    if args.out:
        _write(args.out, {"target": target, "runs": results})
    print(json.dumps({"timestamps": stamps, "launches": {
        "vc_lnphi_fwd": vc_phi.LAUNCHES_FWD,
        "vc_lnphi_bwd": vc_phi.LAUNCHES_BWD}}), flush=True)


if __name__ == "__main__":
    main()
