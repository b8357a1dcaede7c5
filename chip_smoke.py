"""Run the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py [--profile]

(`--parallel-rank r dir` is phase 18's rank r, started by the script.)

Phases, each printing its own lines; any failure exits non-zero:

1. device      the card's name and power limit (nvidia-smi), torch's name
2. build       gpz_tpu_torch/csrc/vc_phi.cu with nvcc (one library holding
               the forward and the backward kernel), timed, with ptxas'
               register and spill report
3. kernel      vc_lnphi_complete (the CUDA forward kernel) against
               vc_lnphi_plain (the same function in plain PyTorch), both on
               the card: random well-conditioned inputs at tests/test_ops.py's
               shapes in float64 and float32, and every shape that one real
               3,000-row request of phase 5 launches (recorded from that
               request; the shapes and their counts must be what the row
               batches and the budgets imply); max errors and median
               CUDA-event times. Also float32 at d=8
               with pivots ~1e-6 (the kernels take one logarithm of a product
               of reciprocal pivots, which must stay in range), a non-PD A
               and an exactly zero pivot (NaN exactly where the plain version
               has it, the zero pivot in the backward too)
4. kernel-bwd  vc_lnphi_bwd (the CUDA backward kernel) against
               vc_lnphi_bwd_plain and against autograd through
               vc_lnphi_plain: the same random shapes, and the trained PHI
               site with a seeded random cotangent; two launches must give
               the same bits; times at (4,096 x 100) and (70,000 x 100)
5. slice       benchmarks/photoz_trained_m100.npz (VC, m=100, d=5) loaded
               onto the card serves the 12,000 test rows of the photo-z
               parity data with psi = errs**2, as 4 requests of 3,000 rows;
               every output must be finite and every batch must have launched
               the kernel at both of its sites. The first 256 test rows are
               then held against JAX's outputs in
               tests/data/torch_port_golden_photoz.npz
6. objective   nlog_ml and its gradient on the first 4,096 training rows of
               the training problem, at the init point and at the trained
               checkpoint cast to float64, against JAX's values in
               tests/data/torch_port_golden_train.npz
7. train       bench_convergence.py's problem (synthetic_sdss(80,000), 70,000
               training and 10,000 validation rows, VC m=100, float64, seed
               1): init, 25 L-BFGS iterations, predict on the 12,000 test
               rows. Every trace value finite, f non-increasing, f at
               iterations 0..5 within TRAIN_TOL of JAX's float64 trace, and
               the forward / backward launch counts equal to what the path
               implies
8. north star  `python -m gpz_tpu_torch.bench_convergence` as a process,
               in its default mode: phase 7's problem trained twice from
               init (MAX_ITER 320, MAX_ATTEMPTS 50), fresh and process-warm.
               Both must reach the target -2.67041538 (a best nlml at or
               below target + 1e-3*|target|, the JAX script's
               reached_target) with a converged status; their best nlml
               against the target (below it once training goes past the
               200 iterations that defined it), their
               seconds_to_target, the process's wall clock broken down by
               its own timestamps (imports, CUDA context, kernel library,
               problem, each training, exit), and its launches held to what
               the two trainings imply. (This replaces the continuation of
               phase 7's model by 175 iterations in the same process, which
               reported an nlml and gated nothing.)

9. missing-serve  the same checkpoint serves 2 requests of 3,000 photo-z
               test rows with psi = errs**2 after NaNs are injected from a
               seed (25% of the rows lose band 0, 10% band 4, 5% both). Every
               output finite, nu and gamma >= 0; the forward launches equal
               what the calls imply (the mixture sums of the missing path go
               through the kernel at both of their sites); the coverage
               guard's readings and escalations; 64 rows, 16 of each pattern,
               within MISSING_TOL of JAX's float64-mixture outputs in
               tests/data/torch_port_golden_missing.npz; the kernel against
               its plain version at every shape that one real request
               launches, mixture sums included (recorded from that request);
               the mixture sums in float32 against float64 (GPZ_MIX_DTYPE)
10. missing-objective  VC m=100 initialized on the 70,000 training rows after
               injection: flat parameters, nlog_ml and its gradient on the
               first 4,096 training rows (the masked pass) within MISSING_TOL
               of JAX; one gradient evaluation at 70,000 rows timed, with its
               launches and peak memory
11. diag-train VD m=100 with psi (n, d), the injected NaNs and balanced cost
               weights: init, 25 iterations, predict on the 12,000 test rows
               with NaNs. Trace finite, f non-increasing, f at iterations
               0..5 within MISSING_TOL of JAX's float64 trace
12. cli        synthetic_sdss(100,000, seed=1) written as the CLI's CSV
               (m_1..m_5,e_1..e_5,z); gpz_tpu_torch.cli.main train (VC,
               m=100, 25 iterations, float64, seed 1; its 0.7 / 0.15 split
               trains on 69,999 rows) in this process, then predict on the
               15,001 rows the split leaves out. JSON lines parse, outputs
               finite, launches equal what init + train and the predict
               batches imply; the prediction CSV equals, byte for byte, the
               one written from predict(X, load_model(checkpoint)) here and
               the one `python -m gpz_tpu_torch predict` writes as a process;
               the native read_csv equals np.loadtxt bit for bit and the
               native library is in use. Times of read, train and predict
13. ensemble   fit_ensemble on phase 7's problem: VC m=100, 4 restarts of
               25 iterations, seed 1, float64, as one lockstep
               minimize_batched (each round evaluates the running restarts
               in one (70,000, A x 100) launch of the pair). Scores finite,
               best_restart their argmax; every restart trained alone by
               minimize from init(seed=1 + r) (the restarts in turn): equal
               iterations, evaluations and status, x and x_best within
               RESTART_TOL; the pair's launches and their shapes equal what
               the lanes imply (lockstep_sites); seconds per restart
               lockstep and in turn, rounds, launches per round, host syncs
               and launches under the profiler, peak memory; the pair
               against plain at every shape the lockstep run launched
14. host-lbfgs minimize_host (the native two-loop recursion) for 25 iterations
               on nlog_ml at 70,000 x 100 through a closure that copies x in
               and (f, g) out as float64 NumPy: native library in use, f
               finite and non-increasing, f at iteration 0 that of phase 7's
               device minimize; its trace beside phase 7's (a report); time
               per evaluation and the host copies' share
15. derivcheck check_gradient on z -> nlog_ml(flat0 + U z) at the init point
               on the first 4,096 training rows, U 32 seeded random unit
               directions: ok, through the kernel pair (65 forward, 1
               backward launches)
16. bench      `python -m gpz_tpu_torch bench` as a process: one JSON line
               with bench.py's keys and a finite positive value, printed
               beside the card's name and power limit (a report, not a gate
               on speed); then bench.main() in this process for its launches
17. inference  posterior inference over the hyperparameters of the checkpoint
               cast to float64 on its 4,000 training rows (p = 3,301):
               (a) one batched evaluation of 4 jittered points against the 4
               single nlog_ml evaluations in turn, here and at phase 7's
               70,000 rows with the trained parameters: equal within
               BATCH_TOL, 1 forward and 1 backward launch against 4 and 4,
               median times and host syncs; (b) the log posterior and its
               gradient at 4 points, one HMC and one NUTS transition given
               JAX's draws and 3 ADVI steps given JAX's eps, within
               INFERENCE_TOL of tests/data/torch_port_golden_inference.npz;
               (c) sample_posterior with HMC and (d) with NUTS, 4 chains:
               finite draws, acceptance, step size, split-Rhat, effective
               sizes, seconds per evaluation and per effective draw, the
               evaluations counted by wrapping the target and the launches
               equal to them; (e) predictive_draws on the 12,000 test rows,
               2 forward launches per draw, beside the MAP prediction; (f)
               advi_fit, 200 steps of 8 draws, one launch pair per step;
               (g) the kernel pair against its plain versions at every shape
               that (c)-(f) launched (recorded from that run, the shapes'
               counts held to what the run implies; the backward on the
               cotangent the run gave it), with times and bounds
18. parallel   gpz_tpu_torch.parallel at phase 7's problem and init point:
               (a) a world of one under NCCL in this process:
               sharded_nlog_ml and its gradient against nlog_ml's within
               TRAIN_TOL, train_sharded for 25 iterations against phase 7's
               trace, its all-reduces (counted and held to what the path
               implies, and timed between synchronizations) and seconds per
               evaluation; (b) two gloo ranks on the card, each a copy of
               this script (`--parallel-rank r dir`, waited on with a
               deadline): each loads its host_row_range of the 70,000 rows
               (global_dataset: n_eff 70,000), the sharded value and
               gradient against the one-process ones, train_sharded's trace,
               69,999 rows split 35,000 / 34,999 and padded,
               ensemble_grad_step on a (restart 2, data 1) mesh against each
               restart stepped alone, fit_ensemble(mesh) with 2 restarts
               against fit_ensemble(mesh=None) within RESTART_TOL, every
               replicated value bit-equal on both ranks; (c) HMC and NUTS, 2
               chains on each rank, the warmup pooled over the restart group
               (axis_name): the step size bit-equal on both ranks. Each
               rank's launches are held to what its path implies, and the
               kernel pair to plain at every shape the ranks launched
19. demos     gpz_tpu_torch.demos' run() at the JAX scripts' default
               sizes in float64: demo_sinc (VL, m=100, 7,500 rows), demo_2d
               (VD, m=50, 3,000 rows with one variable deleted from half of
               them; three trainings) and demo_photoz (VC, m=100, 60,000
               rows of synthetic_sdss, psi = errs**2, normal cost weights,
               12,000 training rows). Every trace finite and non-increasing
               in f; every number the JAX script prints within 1e-3 *
               max(1, |value|) of JAX's full-size value in
               tests/data/torch_port_golden_demos.npz; demo_sinc and
               demo_2d launch no VC kernel; demo_photoz's launches and the
               shapes of its kernel sites (training, validation scoring,
               predict's batches) equal what its evaluations and batches
               imply, and the pair is held to plain at every shape it
               launched
20. scale      BASELINE.json configs[4]'s per-card problem
               (make_torch_port_golden.scale_problem: synthetic_sdss(
               1,120,000, seed=3), psi = errs**2; 1,000,000 rows train,
               100,000 validate): VC m=1000, d=5, heteroscedastic, psi
               (n, d, d), float64. (a) init on the card: host seconds, peak
               RSS, device peak memory; the length scales against gpz_tpu's
               expression evaluated unblocked on the host; (b) the 20,000-row
               sub-problem against tests/data/torch_port_golden_scale.npz
               within SCALE_TOL: init, nlog_ml and its gradient on 8,192 rows,
               the predictions of 16 complete rows and 4 rows with NaNs (the
               coverage guard's readings and escalations as JAX's), 3
               training iterations; (c) train for SCALE_ITERS iterations at
               full size: every iteration's f, evaluations and seconds per
               evaluation, f finite and non-increasing, the device peak
               memory under the card's; (d) save_model / load_model, the
               loaded model serves the last 20,000 rows complete and 1,000
               of them with NaNs (inject_missing): rows/s, least coverage,
               escalations and their seconds; the launches of the pair by
               shape held to what the run and the budgets imply
               (expected_sites); (e) the kernel pair against plain at every
               shape (a)-(d) launched: at (10**6 x 1000) plain runs once in
               row chunks, out of the timing loop. Then one evaluation at
               full size under the profiler
21. bands    wide-band surveys: (a) the kernels' wide variant (d > 8,
               d a runtime argument) against plain: forward and backward at
               (70,000 x 100) for d = 9, 12, 16 and (4,000 x 100) for d =
               32, random well-conditioned float64 inputs, within
               KERNEL_TOL / KERNEL_BWD_TOL, two backward launches
               bit-identical, CUDA-event times against the bound; small
               shapes at d = 9..48 in float64 (against autograd too) and
               float32, NaN at a non-PD A, a two-set backward bit-equal to
               each set alone. (b) the nine-band configuration
               (make_torch_port_golden.bands_problem: configs[2]'s widths at
               d = 9, VC m=100, psi (n, 9, 9), float64): its 1,000-row
               sub-problem against tests/data/torch_port_golden_bands.npz
               within BANDS_TOL, then init on 70,000 rows, BANDS_ITERS
               iterations with 10,000 validation rows, save_model /
               load_model, and the loaded model serves 12,000 complete rows
               and 3,000 rows with NaNs (inject_missing): seconds per
               evaluation, the trace, rows/s, escalations, the launches by
               shape held to what the path implies, the kernel pair against
               plain at every shape launched. (c) phase 20's m=1000 model
               serves 250 rows without band 0, one batch, by the default
               guarded top-64 sum (it escalates) and under GPZ_MIX_TOPL=1000:
               bit-equal, with seconds and launches of each

With --profile, one warm gradient evaluation at the training shape is also
traced with torch.profiler and its kernel table printed.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. It never imports JAX.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(ROOT, "benchmarks", "photoz_trained_m100.npz")

# kernel vs plain on the card, (rtol, atol) on lnPHI. Random well-conditioned
# inputs: rounding only. At the trained point cond(Sigma) ~ 5e7, so rounding
# differences (the kernel's fused multiply-adds against PyTorch's separate
# operations) are amplified in the quadratic form: measured 9.7e-10 at most
# on an H100 (err/bound 0.03 under this tolerance).
KERNEL_TOL = {"float64": (1e-8, 1e-10), "float32": (1e-4, 1e-5),
              "trained": (1e-8, 1e-8)}
# backward kernel vs plain backward and vs autograd through the plain
# forward, (rtol, atol) against the largest magnitude of each output (dP,
# dSigma): every entry is a sum over rows of terms of that size. Random
# inputs: rounding only (tests/test_ops.py's 1e-7 / 1e-9; float32 sums of
# hundreds of terms of size ~1). At the trained point A^-1 has entries up to
# ~1e7 and the sums cancel, so rounding differences are amplified as in the
# forward: measured 1.4e-9 of the largest entry at most on an H100.
KERNEL_BWD_TOL = {"float64": (1e-7, 1e-9), "float32": (2e-3, 2e-4),
                  "trained": (1e-7, 0.0)}

REQUESTS = 4
REQUEST_ROWS = 3000

# the training problem (bench_convergence.py) and the depth this script runs
N_TRAIN = 70_000
N_VALID = 10_000
TRAIN_M = 100
TRAIN_ITERS = 25
MAX_ATTEMPTS = 50
TARGET_NLML = -2.67041538       # benchmarks/convergence_target.json

# phases 12-16: the CLI's catalog (its 0.7 / 0.15 split of it trains on
# 69,999 rows), restarts of the ensemble, directions of the gradient check
CLI_ROWS = 100_000
RESTARTS = 4
DERIV_DIRECTIONS = 32
# a restart of fit_ensemble against the same restart trained alone, (rtol,
# atol) on the parameters: tests/test_torch_train.py's TRACE
RESTART_TOL = (1e-7, 1e-9)

# phase 17: chains, depths of the two samplers' runs, ADVI's steps, and the
# draws predictive_draws takes from the HMC run
INF_CHAINS = 4
HMC_WARMUP, HMC_DRAWS = 100, 100
NUTS_WARMUP, NUTS_DRAWS, NUTS_MAX_DEPTH = 50, 50, 6
ADVI_FIT_STEPS, ADVI_FIT_MC = 200, 8
PREDICTIVE_DRAWS = 40
# one batched evaluation of C points against the C single nlog_ml
# evaluations on the card, (rtol, atol) on nlml and its flat gradient: the
# same float64 formulas through batched products instead of single ones, so
# rounding only, amplified by the conditioning of the m x m solve: the
# value as TRAIN_TOL's "trained.nlml" (3.9e-10 relative measured at 70,000
# rows on an H100), the gradient in gamma resolved to ~2e-6 absolute
# (TRAIN_TOL's "trained.grad"; batched against single differed by up to
# 1.4e-5 of 8.6e-2 in a CPU rehearsal at the checkpoint)
BATCH_TOL = {"nlml": (1e-9, 0.0), "grad": (1e-6, 5e-5)}

# phase 18: a world of one runs on this backend (NCCL on the card; two
# ranks on one card need gloo, as NCCL refuses them), the deadline of the
# two gloo ranks, the step of the ensemble step, the samplers' depth on the
# ranks and their chains per rank
PARALLEL_BACKEND = "nccl"
RANK_TIMEOUT_S = 300.0
PARALLEL_LR = 1e-3
PAR_WARMUP, PAR_DRAWS, PAR_CHAINS = 60, 60, 2

# phase 20: training iterations of the scale configuration (VC m=1000 on
# 1,000,000 rows; make_torch_port_golden.scale_problem)
SCALE_ITERS = 25

# phase 21: training iterations of the nine-band configuration
# (make_torch_port_golden.bands_problem); the wide kernel pair against plain
# at (rows, d) x TRAIN_M bases, random well-conditioned inputs; rows of a
# launch that compare_rows holds to plain (its first and last), above
# SAMPLE_ABOVE pairs; rows of phase 20's batch with NaNs served with
# MIX_TOPL >= m
BANDS_ITERS = 25
WIDE_SHAPES = ((70_000, 9), (70_000, 12), (70_000, 16), (4_000, 32))
SAMPLE_ROWS = 128
SAMPLE_ABOVE = 2 * 10**6
TOPL_ROWS = 250

# H100 SXM peaks for the bounds (NVIDIA's data sheet): device memory
# 3.35 TB/s; FP64 34 TFLOP/s and FP32 67 TFLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str):
    if not ok:
        raise SmokeFailure(what)


def median_ms(fn, trials: int = 7, calls: int = 20, warmup: int = 3) -> float:
    """Median over `trials` of the mean time of `calls` back-to-back calls,
    from CUDA events around each run of calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def fwd_ops(d: int) -> int:
    """Floating-point operations of one (row, basis) pair of the forward
    (csrc/vc_phi.cu): every add, multiply, divide, square root and logarithm
    counts one, a fused multiply-add two."""
    nt = d * (d + 1) // 2
    chol = sum(2 * c + 1 + (d - 1 - c) * (2 * c + 1) for c in range(d))
    solve = sum(2 * r + 1 for r in range(d))
    return nt + chol + d + solve + (2 * d - 1) + (2 * d - 1) + 4


def bwd_ops(d: int) -> int:
    """The same count for one pair of the backward's first pass: the
    forward's factorization and substitution, the back substitution, the
    triangular inverse, the upper triangle of A^-1 and the d + d(d+1)/2
    accumulations."""
    nt = d * (d + 1) // 2
    chol = sum(2 * c + 1 + (d - 1 - c) * (2 * c + 1) for c in range(d))
    solve = sum(2 * r + 1 for r in range(d))
    invert = sum(1 + sum(3 + 2 * (r - c - 1) for r in range(c + 1, d))
                 for c in range(d))
    a_inv = sum(1 + 2 * (d - 1 - b) for a in range(d) for b in range(a, d))
    return nt + chol + d + 2 * solve + 2 * d + invert + a_inv + 6 * nt


def bound(kind: str, n: int, m: int, d: int, dtype: str) -> dict:
    """The least time the card could take for one call: the larger of the
    bytes it must move (each input read once, each output written once) over
    the memory rate and its operations over the FP peak of its type."""
    size = 8 if dtype == "float64" else 4
    elems = n * d + n * d * d + m * d + m * d * d + n * m
    if kind == "fwd":
        elems += m                       # logdet_Sigma; lnPHI is the n*m
        ops = n * m * fwd_ops(d)
    else:
        elems += m * d + m * d * d       # g is the n*m; dP, dSigma written
        ops = n * m * bwd_ops(d) + n * m // 256 * (d + d * d)
    t_bytes = elems * size / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes_ms": t_bytes, "ops_ms": t_ops}


def random_inputs(rng, n, d, m, dtype, device, scale=1.0):
    """tests/test_ops.py::make_inputs: random, well conditioned. `scale`
    shrinks the inputs' length unit: A's pivots go with scale**2 and lnPHI
    changes by a constant."""
    import torch

    X = rng.standard_normal((n, d)) * scale
    A = rng.standard_normal((n, d, d)) * 0.3
    psi = (A @ np.swapaxes(A, 1, 2) + 0.2 * np.eye(d)) * scale ** 2
    P = rng.standard_normal((m, d)) * scale
    B = rng.standard_normal((m, d, d)) * 0.2
    Sigma = (B @ np.swapaxes(B, 1, 2) + 0.5 * np.eye(d)) * scale ** 2
    logdet = np.linalg.slogdet(Sigma)[1]
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (X, psi, P, Sigma, logdet))


def shape_line(args):
    n, d = args[0].shape
    return f"n={n} m={args[2].shape[0]} d={d} {args[0].dtype}"


def compare_kernel(name, args, tol, plain_timing=None):
    """Forward kernel vs plain on the same card inputs; returns the max abs
    error and both times (`plain_timing`: median_ms options for a plain
    version that takes seconds)."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    got = vc_phi.vc_lnphi_complete(*args)
    want = vc_phi.vc_lnphi_plain(*args[:5])
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)}")
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()),
          f"{name}: non-finite entries differ from the plain version")
    err = (got - want).abs()[fin]
    rtol, atol = tol
    limit = atol + rtol * want.abs()[fin]
    max_abs = float(err.max())
    worst = float((err / limit).max())
    rec = {
        "max_abs_err": max_abs,
        "ms": median_ms(lambda: vc_phi.vc_lnphi_complete(*args)),
        "plain_ms": median_ms(lambda: vc_phi.vc_lnphi_plain(*args[:5]),
                              **(plain_timing or {})),
    }
    print(f"kernel {name}: {shape_line(args)} max_abs_err={max_abs:.3e} "
          f"(err/bound {worst:.3f}) kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms")
    check(worst <= 1.0, f"{name}: kernel disagrees with the plain version "
          f"beyond rtol={rtol}, atol={atol}")
    return rec


def autograd_through_plain(X, psi, P, Sigma, g):
    """(dP, dSigma) by autograd through vc_lnphi_plain. The plain forward
    reads only the lower triangle of A, so autograd puts an off-diagonal
    pair's whole derivative into the lower entry: symmetrized, it is the
    cotangent the backward kernel writes."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    P = P.clone().requires_grad_(True)
    Sigma = Sigma.clone().requires_grad_(True)
    lds = torch.zeros(P.shape[0], dtype=P.dtype, device=P.device)
    out = vc_phi.vc_lnphi_plain(X, psi, P, Sigma, lds)
    dP, dS = torch.autograd.grad(out, (P, Sigma), g)
    return dP, 0.5 * (dS + dS.transpose(1, 2))


def compare_backward(name, args, g, tol, sets=1):
    """Backward kernel (its sums planned for `sets` runs of bases) vs the
    plain backward and vs autograd through the plain forward, and twice
    against itself; returns the worst max abs error."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    X, psi, P, Sigma = args[:4]
    got = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g, sets)
    again = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g, sets)
    plain = vc_phi.vc_lnphi_bwd_plain(X, psi, P, Sigma, g)
    auto = autograd_through_plain(X, psi, P, Sigma, g)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"{name}: two launches on the same inputs differ in their bits")
    check(torch.equal(got[1], got[1].transpose(1, 2)),
          f"{name}: dSigma's triangles differ")
    rtol, atol = tol
    max_abs, worst = 0.0, 0.0
    for what, want in (("plain", plain), ("autograd", auto)):
        for part, a, b in zip(("dP", "dSigma"), got, want):
            check(bool(torch.isfinite(a).all() and torch.isfinite(b).all()),
                  f"{name}: non-finite {part}")
            err = float((a - b).abs().max())
            ratio = err / (atol + rtol * float(b.abs().max()))
            max_abs, worst = max(max_abs, err), max(worst, ratio)
            check(ratio <= 1.0, f"{name}: {part} disagrees with {what} "
                  f"beyond rtol={rtol}, atol={atol} of its largest entry "
                  f"(max_abs_err {err:.3e}, largest {float(b.abs().max()):.3e})")
    print(f"kernel-bwd {name}: {shape_line(args)} max_abs_err={max_abs:.3e} "
          f"(err/bound {worst:.3f}) vs plain and autograd, two launches "
          "bit-identical")
    return max_abs


@contextlib.contextmanager
def recording(module: str, name: str, sites: dict, host_above=None):
    """Record the calls of a kernel wrapper, module.<name>, while the block
    runs: sites {(rows, bases): [calls, the arguments of the first]}, in the
    order the shapes were first launched. An argument of more than
    `host_above` elements is kept as a copy on the host (`moved` brings it
    back), so that recording holds no (n, m) cotangent on the card."""
    mod = importlib.import_module(module)
    real = getattr(mod, name)

    def keep(a):
        if not hasattr(a, "detach"):
            return a
        if host_above is not None and a.numel() > host_above:
            return a.detach().to("cpu")
        return a.detach().clone()

    def record(*args):
        shape = (args[0].shape[0], args[2].shape[0])
        if shape not in sites:
            sites[shape] = [0, tuple(keep(a) for a in args)]
        sites[shape][0] += 1
        return real(*args)

    setattr(mod, name, record)
    try:
        yield sites
    finally:
        setattr(mod, name, real)


def moved(args, device) -> tuple:
    """Recorded arguments with their tensors on `device` (the sets count of
    a batched call stays as it is)."""
    return tuple(a.to(device) if hasattr(a, "to") else a for a in args)


@contextlib.contextmanager
def pair_recorded(fwd_sites: dict, bwd_sites: dict, host_above=None):
    """Record the design-matrix kernel pair's calls from the objective while
    the block runs: the forward where phi calls it, the backward where the
    autograd function calls it (with the cotangent it is given)."""
    with recording("gpz_tpu_torch.phi", "vc_lnphi_complete", fwd_sites,
                   host_above), \
            recording("gpz_tpu_torch.ops.vc_phi", "vc_lnphi_bwd", bwd_sites,
                      host_above):
        yield


def site_calls(fn):
    """Run fn() with predict.vc_lnphi_complete recorded: (fn's result,
    sites)."""
    # the module, not the package's `predict` function of the same name
    with recording("gpz_tpu_torch.predict", "vc_lnphi_complete", {}) as sites:
        result = fn()
    return result, sites


def compare_sites(prefix, sites, per, key="launches_per_request",
                  sample_above=None):
    """compare_kernel at every recorded shape of a path, with the shape's
    launches (under `key`) and its bound; {name: record}. A shape of more
    than `sample_above` pairs goes to compare_rows instead."""
    recs = {}
    for (n, bases), (count, args) in sites.items():
        name = f"{prefix}-{n}x{bases}"
        slow = (dict(trials=3, calls=2, warmup=1)
                if bases > 1000 or n * bases > 1e7 else None)
        if sample_above is not None and n * bases > sample_above:
            rec = compare_rows(name, args, KERNEL_TOL["trained"])
        else:
            rec = compare_kernel(name, args, KERNEL_TOL["trained"],
                                 plain_timing=slow)
        b = bound("fwd", n, bases, args[0].shape[1], "float64")
        rec.update({"shape": [n, bases], key: count,
                    "bound_ms": b["bound_ms"]})
        print(f"site {name} d={args[0].shape[1]} f64: {count} launches per "
              f"{per}; bound {b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
              f"{b['bytes_ms']:.5f}, operations {b['ops_ms']:.5f}); kernel "
              f"{rec['ms'] / b['bound_ms']:.2f}x its bound")
        recs[name] = rec
    return recs


def compare_rows(name, args, tol):
    """The forward kernel launched at a site's full shape and held to plain
    on the first and last SAMPLE_ROWS rows of it (a row's lnPHI depends on
    that row alone), where plain on every row takes seconds: the kernel
    timed at the full shape, plain on those rows (plain_rows)."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    X, psi, P, Sigma, lds = args[:5]
    n = X.shape[0]
    rows = SAMPLE_ROWS
    idx = torch.as_tensor(sorted(set(range(min(rows, n)))
                                 | set(range(max(0, n - rows), n))),
                          device=X.device)
    got = vc_phi.vc_lnphi_complete(*args)[idx]
    sample = (X[idx].contiguous(), psi[idx].contiguous(), P, Sigma, lds)
    want = vc_phi.vc_lnphi_plain(*sample)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    check(bool((torch.isfinite(got) == fin).all()),
          f"{name}: non-finite entries differ from the plain version")
    err = (got - want).abs()[fin]
    rtol, atol = tol
    max_abs = float(err.max())
    worst = float((err / (atol + rtol * want.abs()[fin])).max())
    few = dict(trials=3, calls=3, warmup=1)
    rec = {"max_abs_err": max_abs,
           "ms": median_ms(lambda: vc_phi.vc_lnphi_complete(*args), **few),
           "plain_ms": median_ms(lambda: vc_phi.vc_lnphi_plain(*sample),
                                 trials=1, calls=1, warmup=0),
           "plain_rows": len(idx)}
    print(f"kernel {name}: {shape_line(args)} max_abs_err={max_abs:.3e} "
          f"(err/bound {worst:.3f}) on {len(idx)} of its {n} rows; kernel "
          f"{rec['ms']:.4f} ms at the full shape, plain {rec['plain_ms']:.4f} "
          f"ms on those rows")
    check(worst <= 1.0, f"{name}: kernel disagrees with the plain version "
          f"beyond rtol={rtol}, atol={atol}")
    return rec


def compare_bwd_sites(prefix, sites, per):
    """compare_backward at every recorded shape of a path, on the cotangent
    the path gave the kernel there, with the shape's launches, the kernel's
    and the plain backward's times and its bound; {name: record}."""
    from gpz_tpu_torch.ops import vc_phi

    few = dict(trials=5, calls=5, warmup=2)
    recs = {}
    for (n, bases), (count, args) in sites.items():
        name = f"{prefix}-bwd-{n}x{bases}"
        d = args[0].shape[1]
        rec = {"max_abs_err": compare_backward(name, args, args[4],
                                               KERNEL_BWD_TOL["trained"],
                                               *args[5:]),
               "ms": median_ms(lambda: vc_phi.vc_lnphi_bwd(*args), **few),
               "plain_ms": median_ms(
                   lambda: vc_phi.vc_lnphi_bwd_plain(*args[:5]), **few)}
        b = bound("bwd", n, bases, d, "float64")
        rec.update(shape=[n, bases], launches=count, bound_ms=b["bound_ms"])
        print(f"site {name} d={d} f64: {count} launches per {per}; kernel "
              f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
              f"{b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
              f"{b['bytes_ms']:.5f}, operations {b['ops_ms']:.5f}); kernel "
              f"{rec['ms'] / b['bound_ms']:.2f}x its bound")
        recs[name] = rec
    return recs


def complete_calls(cfg, rows: int):
    """The moment calls of one predict() on `rows` complete rows with psi, as
    moments_calls records them: one per row batch of model.predict."""
    from gpz_tpu_torch.model import _moments_batch

    bs = _moments_batch(cfg)
    return [(min(bs, rows - start), True, 0, None)
            for start in range(0, rows, bs)]


def moments_calls(fn):
    """Run fn() with predict.predict_moments_full recorded: one (rows,
    complete, mixture width, coverage or None) per call."""
    predict_mod = importlib.import_module("gpz_tpu_torch.predict")
    real = predict_mod.predict_moments_full
    calls = []

    def record(*args, **kw):
        out = real(*args, **kw)
        cfg, X, complete = args[3], args[4], args[7]
        width = min(cfg.m, kw.get("mix_topl") or predict_mod.MIX_TOPL)
        calls.append((X.shape[0], complete, width,
                      float(out[5]) if kw.get("return_coverage") else None))
        return out

    predict_mod.predict_moments_full = record
    try:
        result = fn()
    finally:
        predict_mod.predict_moments_full = real
    return result, calls


def expected_sites(cfg, calls) -> dict:
    """{(rows, bases): launches} of the forward kernel that moment calls
    (rows, complete, mixture width, coverage) imply, derived here from the
    two budgets alone. A budget counts float32 elements and the chain runs in
    float64, so half as many elements fit.

    Complete rows: one launch of the rows against the m bases (PHI), then
    the pair pass in blocks of B basis indices, B the most that keeps
    (rows, B, m) within PAIR_BUDGET: one launch per block against the
    block's B * m pairs as bases. Missing values: the same two sites with B
    from MISSING_PAIR_BUDGET, each a sum over `width` mixture components
    whose rows go through the kernel together, as many components per launch
    as keep (components * rows, bases) within MISSING_PAIR_BUDGET.
    """
    predict_mod = importlib.import_module("gpz_tpu_torch.predict")
    pair_elems = predict_mod.PAIR_BUDGET // 2
    mix_elems = predict_mod.MISSING_PAIR_BUDGET // 2
    m = cfg.m
    out = {}

    def add(shape, times):
        out[shape] = out.get(shape, 0) + times

    for n, complete, width, _ in calls:
        B = max(1, min(m, (pair_elems if complete else mix_elems) // (n * m)))
        blocks = -(-m // B)
        for bases, times in ((m, 1), (B * m, blocks)):
            if complete:
                add((n, bases), times)
                continue
            chunk = max(1, min(width, mix_elems // (n * bases)))
            whole, rest = divmod(width, chunk)
            add((chunk * n, bases), times * whole)
            if rest:
                add((rest * n, bases), times)
    return out


def site_counts(sites) -> dict:
    return {shape: rec[0] for shape, rec in sites.items()}


def expected_batches(X, rows_per_batch: int):
    """[(rows, complete)] of the moment batches model.predict makes for X:
    patterns in np.unique's order, each in batches of rows_per_batch."""
    mask = ~np.isnan(X)
    patterns, inverse = np.unique(mask, axis=0, return_inverse=True)
    out = []
    for pi in range(patterns.shape[0]):
        n = int((inverse == pi).sum())
        out += [(min(rows_per_batch, n - s), bool(patterns[pi].all()))
                for s in range(0, n, rows_per_batch)]
    return out


def timed_predict(X, model, psi):
    """(prediction, seconds) of one predict() call, synchronized."""
    import torch
    import gpz_tpu_torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pred = gpz_tpu_torch.predict(X, model, psi=psi)
    torch.cuda.synchronize()
    return pred, time.perf_counter() - t0


def count_launches(fn) -> int:
    """cudaLaunchKernel calls of one fn() under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key.startswith("cudaLaunchKernel"))


def objective_at(flat, unravel, data, cfg, complete=True):
    """(nlml, flat gradient) of nlog_ml as host arrays."""
    import torch
    from gpz_tpu_torch.objective import nlog_ml

    flat = flat.detach().clone().requires_grad_(True)
    nlml, _ = nlog_ml(unravel(flat), data, cfg, complete=complete)
    grad, = torch.autograd.grad(nlml, flat)
    return float(nlml.detach()), grad.cpu().numpy()


def sass_check(so: str):
    """cuobjdump -sass of the built library: no instantiation of the forward
    or the backward kernel may hold a CALL (an IEEE division or square root,
    and CUDA's rsqrt(), each call a slow path). Prints the instruction
    counts of the two <double, 5> kernels."""
    from torch.utils.cpp_extension import CUDA_HOME

    res = subprocess.run([os.path.join(CUDA_HOME, "bin", "cuobjdump"),
                          "-sass", so], capture_output=True, text=True,
                         check=True, timeout=300)
    counts, name = {}, None
    for line in res.stdout.splitlines():
        if "Function :" in line:
            name = line.split(":", 1)[1].strip()
            counts[name] = {}
        got = re.match(r"\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z]\w*)",
                       line)
        if name and got:
            op = got.group(1)
            counts[name][op] = counts[name].get(op, 0) + 1
    kernels = {fn: c for fn, c in counts.items()
               if "vc_lnphi_fwd_kernel" in fn or "vc_lnphi_bwd_kernel" in fn
               or "_wide_kernel" in fn}
    check(len(kernels) == 36, f"sass: {len(kernels)} kernel bodies, not 36")
    for fn, c in kernels.items():
        check(c.get("CALL", 0) == 0, f"sass: {fn} holds a CALL")
        if "IdLi5E" in fn or "wide_kernelIdE" in fn:
            what = "bwd" if "bwd" in fn else "fwd"
            what += " wide <double>" if "_wide_" in fn else " <double, 5>"
            print(f"sass: {what}: {sum(c.values())} instructions, "
                  + ", ".join(f"{k} {c.get(k, 0)}" for k in (
                      "DFMA", "DMUL", "DADD", "MUFU", "BRA", "CALL", "LDS",
                      "LDG", "LDGSTS", "BAR")))


def profile_evaluation(fun, flat):
    """torch.profiler over one warm gradient evaluation: launches, device
    time by kernel, device busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fun(flat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fun(flat)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fun(flat)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    dev = [(e.key, e.count, e.device_time_total / 1e3) for e in events
           if e.device_time_total > 0
           and e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in dev)
    launches = sum(e.count for e in events
                   if e.key.startswith("cudaLaunchKernel"))
    syncs = sum(e.count for e in events if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaMemcpyAsync"))
    print(f"profile: one warm gradient evaluation {warm_ms:.3f} ms wall "
          f"({traced_ms:.3f} ms under the profiler), device kernels "
          f"{total:.3f} ms in {sum(r[1] for r in dev)} kernel runs, "
          f"{launches} cudaLaunchKernel calls, {syncs} synchronizing or "
          f"copying runtime calls, device busy share "
          f"{total / traced_ms:.3f} of the traced wall")
    for key, count, ms in dev[:25]:
        print(f"profile: {ms:9.4f} ms  {count:4d} x  {key[:110]}")


@contextlib.contextmanager
def env_set(name: str, value: str):
    """The environment variable `name` set to `value` while the block runs,
    as it was after."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def reset_launches():
    from gpz_tpu_torch.ops import vc_phi

    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0


def launches() -> tuple:
    """(forward, backward) kernel launches since the last reset."""
    from gpz_tpu_torch.ops import vc_phi

    return vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD


def cli_json(argv) -> tuple:
    """(JSON lines, seconds) of one in-process gpz_tpu_torch.cli.main call,
    synchronized; its other output (the training table) is swallowed."""
    import contextlib
    import io
    import torch
    from gpz_tpu_torch import cli

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc in (None, 0), f"cli {argv[0]}: exit {rc}")
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")], secs


def phase_cli(workdir: str) -> dict:
    """12. The CLI trains VC m=100 from a CSV of synthetic_sdss(100,000)
    and serves the rows its split leaves out; {path: (fwd, bwd)}."""
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils, native
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.checkpoint import load_model

    mags, errs, z = synthetic_sdss(CLI_ROWS, seed=1)
    table = np.column_stack([mags, errs, z])
    csv = os.path.join(workdir, "catalog.csv")
    np.savetxt(csv, table, delimiter=",")
    check(native.available(), "cli: the native library did not build; "
          "read_csv runs its NumPy fallback")
    t0 = time.perf_counter()
    raw = native.read_csv(csv)
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = np.loadtxt(csv, delimiter=",")
    loadtxt_s = time.perf_counter() - t0
    check(raw.dtype == ref.dtype and np.array_equal(raw, ref)
          and np.array_equal(raw, table), "cli: native read_csv differs from "
          "np.loadtxt of the same file")
    # the CLI's split (gpz_tpu.cli: fractions 0.7 / 0.15, rng of --seed)
    tr, va, te = datautils.split(CLI_ROWS, 0.7, 0.15, 1 - 0.7 - 0.15,
                                 np.random.default_rng(1))
    ckpt = os.path.join(workdir, "model.npz")
    reset_launches()
    lines, train_s = cli_json([
        "train", csv, "--out", ckpt, "--method", "VC", "--m", str(TRAIN_M),
        "--max-iter", str(TRAIN_ITERS), "--dtype", "float64", "--seed", "1"])
    train_l = launches()
    info = lines[-1]
    check(set(info) == {"saved", "iterations", "fun_evals", "best_valid_ll",
                        "train_seconds"} and np.isfinite(info["best_valid_ll"]),
          f"cli train: JSON line {info}")
    n_it, evals = info["iterations"], info["fun_evals"]
    # phase 7's count, plus init's one forward (its posterior)
    want = (1 + evals + (n_it + 1) + 4, evals)
    print(f"cli: train on {int(tr.sum())} of {CLI_ROWS} rows ({int(va.sum())} "
          f"validation): {n_it} iterations, {evals} evaluations in "
          f"{train_s:.3f} s (init, training, checkpoint), best validation "
          f"log-likelihood {info['best_valid_ll']:.6f}; launches fwd/bwd "
          f"{train_l} (expected {want})")
    check(n_it == TRAIN_ITERS, f"cli train: {n_it} iterations")
    check(train_l == want, "cli train: launch counts differ from what init "
          "+ train imply")

    test_csv = os.path.join(workdir, "left_out.csv")
    np.savetxt(test_csv, table[te], delimiter=",")
    pred_csv = os.path.join(workdir, "pred.csv")
    predict_argv = ["predict", test_csv, "--model", ckpt, "--out", pred_csv,
                    "--has-target", "--has-errors"]
    reset_launches()
    lines, predict_s = cli_json(predict_argv)
    predict_l = launches()
    metrics = lines[0]
    check(lines[-1] == {"wrote": pred_csv} and metrics["n"] == int(te.sum())
          and np.isfinite([metrics["rmse"], metrics["mll"]]).all(),
          f"cli predict: JSON lines {lines}")
    model = load_model(ckpt)
    want_p = (sum(expected_sites(model.cfg, complete_calls(
        model.cfg, int(te.sum()))).values()), 0)
    out = np.loadtxt(pred_csv, delimiter=",", skiprows=1)
    check(out.shape == (int(te.sum()), 6) and np.isfinite(out).all(),
          "cli predict: output not finite of the expected shape")
    check(predict_l == want_p, f"cli predict: launches {predict_l}, the "
          f"batches imply {want_p}")
    # the same rows served in this process must give the same file
    pred = gpz_tpu_torch.predict(table[te, :5], model,
                                 psi=table[te, 5:10] ** 2)
    mine = os.path.join(workdir, "pred_in_process.csv")
    np.savetxt(mine, np.column_stack([
        table[te, -1], pred.mu[:, 0], pred.sigma[:, 0], pred.nu[:, 0],
        pred.beta_i[:, 0], pred.gamma[:, 0]]), delimiter=",",
        header="target,mu,sigma,nu,beta_i,gamma", comments="")
    with open(pred_csv, "rb") as a, open(mine, "rb") as b:
        check(a.read() == b.read(), "cli predict: its CSV differs from "
              "predict(X, load_model(checkpoint)) written the same way")
    sub_csv = os.path.join(workdir, "pred_subprocess.csv")
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gpz_tpu_torch", "predict",
                          test_csv, "--model", ckpt, "--out", sub_csv,
                          "--has-target", "--has-errors"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    sub_s = time.perf_counter() - t0
    check(res.returncode == 0, "python -m gpz_tpu_torch predict: exit "
          f"{res.returncode}\n{res.stderr[-2000:]}")
    with open(pred_csv, "rb") as a, open(sub_csv, "rb") as b:
        check(a.read() == b.read(), "python -m gpz_tpu_torch predict wrote "
              "other bytes than the in-process call")
    print(f"cli: read {CLI_ROWS} x {raw.shape[1]} CSV in {read_s:.3f} s "
          f"(native; np.loadtxt {loadtxt_s:.3f} s, bit-identical); predict "
          f"{int(te.sum())} rows in {predict_s:.3f} s (load, read, serve, "
          f"write), test RMSE {metrics['rmse']:.6f}, mean log-likelihood "
          f"{metrics['mll']:.6f}, launches fwd/bwd {predict_l} (expected "
          f"{want_p}); CSV equal to the in-process prediction's bytes, and "
          f"to `python -m gpz_tpu_torch predict`'s ({sub_s:.1f} s as a "
          f"process)")
    return {"cli_train": train_l, "cli_predict": predict_l}


def lockstep_sites(results, n_train, n_valid, m, restarts) -> tuple:
    """({(rows, bases): launches} forward, the same backward) that one
    fit_ensemble implies from its lanes' MinimizeResults (phase 13): each
    restart's init posterior and the chosen restart's `last` and `best`
    resolved (posterior and prior each) at (n_train, m); evaluation round e
    at (n_train, A m), A the lanes still running at e (those with fun_evals
    >= e), forward and backward; one validation score per round in which A'
    lanes end an iteration (an iteration ends where its trace's fevals
    reads e), at (n_valid, A' m). Also the number of rounds."""
    fwd, bwd = {(n_train, m): restarts + 4}, {}
    rounds = max(r.fun_evals for r in results)
    for e in range(1, rounds + 1):
        active = sum(r.fun_evals >= e for r in results)
        scored = sum(int(e in r.trace["fevals"]) for r in results)
        for sites in (fwd, bwd):
            key = (n_train, active * m)
            sites[key] = sites.get(key, 0) + 1
        if scored:
            key = (n_valid, scored * m)
            fwd[key] = fwd.get(key, 0) + 1
    return fwd, bwd, rounds


def phase_ensemble(X, Y, psi, tr, va) -> tuple:
    """13. fit_ensemble, 4 restarts of VC m=100 on the training problem, as
    one lockstep minimize_batched; every restart against itself trained
    alone by minimize (the restarts in turn); the kernel pair against plain
    at every shape the lockstep run launched. Returns ((fwd, bwd) launches,
    forward site records, backward site records)."""
    import torch
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch import ensemble as ensemble_mod
    from gpz_tpu_torch import model as model_mod
    from gpz_tpu_torch.objective import holdout_metrics
    from gpz_tpu_torch.optim import minimize

    lanes = []
    batched = ensemble_mod.minimize_batched

    def captured(*args, **kw):
        lanes.extend(batched(*args, **kw))
        return lanes

    fwd_sites, bwd_sites = {}, {}
    ensemble_mod.minimize_batched = captured
    try:
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with pair_recorded(fwd_sites, bwd_sites):
            model, info = gpz_tpu_torch.fit_ensemble(
                X, Y, "VC", TRAIN_M, n_restarts=RESTARTS, training=tr,
                validation=va, psi=psi, max_iter=TRAIN_ITERS, seed=1,
                dtype="float64")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = launches()
        peak = torch.cuda.max_memory_allocated()
    finally:
        ensemble_mod.minimize_batched = batched
    scores, best = info["restart_scores"], info["best_restart"]
    its, evals = info["iterations"], info["fun_evals"]
    check(len(lanes) == RESTARTS, f"ensemble: {len(lanes)} lanes")
    check(np.isfinite(scores).all() and scores.shape == (RESTARTS,)
          and best == int(np.argmax(scores)), f"ensemble: scores {scores}, "
          f"best restart {best}")
    check(its.shape == evals.shape == (RESTARTS,)
          and its.tolist() == [r.iterations for r in lanes]
          and evals.tolist() == [r.fun_evals for r in lanes],
          "ensemble: fit_info's iterations and evaluations are not the "
          "lanes'")
    n_tr, n_va = int(tr.sum()), int(va.sum())
    want_fwd, want_bwd, rounds = lockstep_sites(lanes, n_tr, n_va, TRAIN_M,
                                                RESTARTS)
    want = (sum(want_fwd.values()), sum(want_bwd.values()))
    check(site_counts(fwd_sites) == want_fwd
          and site_counts(bwd_sites) == want_bwd, "ensemble: the pair "
          f"launched at {site_counts(fwd_sites)} forward and "
          f"{site_counts(bwd_sites)} backward; the lanes imply {want_fwd} "
          f"and {want_bwd}")
    check(got == want, f"ensemble: launches fwd/bwd {got}, the lanes imply "
          f"{want}")

    # every restart alone, from its own init: the restarts in turn
    rtol, atol = RESTART_TOL
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    alone = []
    for r in range(RESTARTS):
        init = gpz_tpu_torch.init(X, Y, "VC", TRAIN_M, psi=psi, training=tr,
                                  seed=1 + r, dtype="float64")
        cfg = init.cfg
        Xn = (X - init.muX[None, :]) / init.sdX[None, :]
        Yc = Y[:, None] - init.muY[None, :]
        psi_c = datautils.fix_psi(psi, len(Y), init.sdX, True)
        dev = init.last.params.P.device
        data_tr = model_mod._make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), tr,
                                          torch.float64, dev)
        data_va = model_mod._make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), va,
                                          torch.float64, dev)
        flat0, unravel = init.last.params.flatten()

        def score_fn(flat, aux):
            rmse, ll = holdout_metrics(unravel(flat), aux.w, data_va, cfg,
                                       complete=True)
            return ll, {"valid_rmse": rmse, "valid_ll": ll}

        alone.append(minimize(model_mod._objective(unravel, data_tr, cfg,
                                                   True),
                              flat0, max_iter=TRAIN_ITERS,
                              score_fn=score_fn))
    torch.cuda.synchronize()
    turn_secs = time.perf_counter() - t0
    worst = 0.0
    for r, (lane, one) in enumerate(zip(lanes, alone)):
        check((lane.iterations, lane.fun_evals, lane.status)
              == (one.iterations, one.fun_evals, one.status),
              f"ensemble: restart {r} took {lane.iterations} iterations, "
              f"{lane.fun_evals} evaluations, status {lane.status} in the "
              f"lockstep run and {one.iterations}, {one.fun_evals}, "
              f"{one.status} alone")
        for which in ("x", "x_best"):
            a, b = getattr(lane, which), getattr(one, which)
            err = (a - b).abs()
            ratio = float((err / (atol + rtol * b.abs())).max())
            worst = max(worst, ratio)
            check(ratio <= 1.0, f"ensemble: restart {r}'s {which} differs "
                  f"from the restart alone by {float(err.max()):.3e} (err/"
                  f"bound {ratio:.3f})")
        check(abs(lane.best_score - one.best_score)
              <= atol + rtol * abs(one.best_score), f"ensemble: restart {r}'s "
              f"score {lane.best_score} against {one.best_score} alone")
    for which, lane_x in (("best", lanes[best].x_best),
                          ("last", lanes[best].x)):
        check(torch.equal(getattr(model, which).params.flatten()[0], lane_x),
              f"ensemble: the model's {which} parameters are not restart "
              f"{best}'s")
    bit = all(torch.equal(a.x, b.x) and torch.equal(a.x_best, b.x_best)
              for a, b in zip(lanes, alone))

    def lockstep():
        gpz_tpu_torch.fit_ensemble(
            X, Y, "VC", TRAIN_M, n_restarts=RESTARTS, training=tr,
            validation=va, psi=psi, max_iter=TRAIN_ITERS, seed=1,
            dtype="float64")

    # once more after the restarts in turn, which ran warm; then host syncs
    # and launches of the whole run, lockstep and in turn
    warm_secs = host_ms(lockstep) / 1e3
    syncs_b, calls_b = profiled_counts(lockstep)
    one = alone[-1]
    syncs_1, calls_1 = profiled_counts(lambda: minimize(
        model_mod._objective(unravel, data_tr, cfg, True), flat0,
        max_iter=TRAIN_ITERS, score_fn=score_fn))
    print(f"ensemble: {RESTARTS} restarts of VC m={TRAIN_M}, {TRAIN_ITERS} "
          f"iterations each, lockstep in {secs:.3f} s ({secs / RESTARTS:.3f} "
          f"s per restart, init included; {warm_secs:.3f} s, "
          f"{warm_secs / RESTARTS:.3f} s per restart, once more after the "
          f"restarts in turn), in turn {turn_secs:.3f} s "
          f"({turn_secs / RESTARTS:.3f} s per restart; "
          f"{turn_secs / secs:.2f}x and {turn_secs / warm_secs:.2f}x); "
          f"{rounds} rounds for evaluations "
          f"{evals.tolist()}, iterations {its.tolist()}, statuses "
          f"{[r.status for r in lanes]}; scores "
          f"{np.round(scores, 6).tolist()}, best restart {best}; every "
          f"restart against itself alone: equal counts and statuses, "
          f"parameters err/bound {worst:.3f} (bit-equal: {bit}); launches "
          f"fwd/bwd {got} ({got[0] / rounds:.2f} / {got[1] / rounds:.2f} per "
          f"round); peak memory {peak / 2**30:.3f} GiB")
    print(f"ensemble: the pair launched at forward "
          f"{sorted(site_counts(fwd_sites).items())}, backward "
          f"{sorted(site_counts(bwd_sites).items())}")
    print(f"ensemble: under the profiler, the lockstep run {syncs_b} host "
          f"syncs and {calls_b} kernel launches ({syncs_b / rounds:.1f} and "
          f"{calls_b / rounds:.1f} per round of {rounds}); restart "
          f"{RESTARTS - 1} alone "
          f"{syncs_1} and {calls_1} ({syncs_1 / one.fun_evals:.1f} and "
          f"{calls_1 / one.fun_evals:.1f} per evaluation of "
          f"{one.fun_evals})")
    fwd_recs = compare_sites("ensemble", fwd_sites, "phase-13 lockstep run",
                             key="launches")
    bwd_recs = compare_bwd_sites("ensemble", bwd_sites,
                                 "phase-13 lockstep run")
    return got, fwd_recs, bwd_recs


def profiled_counts(fn) -> tuple:
    """(cudaStreamSynchronize calls, cudaLaunchKernel calls) of one fn()
    under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return (sum(e.count for e in events if e.key == "cudaStreamSynchronize"),
            sum(e.count for e in events
                if e.key.startswith("cudaLaunchKernel")))


def phase_host_lbfgs(model, X, Y, psi, tr, device_trace) -> tuple:
    """14. minimize_host on nlog_ml at the training shape through a closure
    that copies x in and (f, g) out; (fwd, bwd) launches."""
    import torch
    from gpz_tpu_torch import datautils, native
    from gpz_tpu_torch import model as model_mod
    from gpz_tpu_torch.optim import minimize_host

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[:, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)
    flat0, unravel = model.last.params.flatten()
    dev = flat0.device
    data = model_mod._make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), tr,
                                   torch.float64, dev)
    fun = model_mod._objective(unravel, data, model.cfg, True)
    clock = {"copies": 0.0, "total": 0.0}

    def host_fun(x):
        t0 = time.perf_counter()
        xt = torch.as_tensor(x, device=dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        f, g, _ = fun(xt)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out = float(f), g.cpu().numpy()
        t3 = time.perf_counter()
        clock["copies"] += (t1 - t0) + (t3 - t2)
        clock["total"] += t3 - t0
        return out

    check(native.available(), "host-lbfgs: the native library is not in "
          "use (NumPy fallback)")
    reset_launches()
    t0 = time.perf_counter()
    res = minimize_host(host_fun, flat0.cpu().numpy(), max_iter=TRAIN_ITERS)
    secs = time.perf_counter() - t0
    got = launches()
    f = np.array([t[0] for t in res.trace])
    check(np.isfinite(f).all() and bool(np.all(np.diff(f) <= 0)),
          "host-lbfgs: f not finite or not non-increasing")
    check(abs(f[0] - device_trace[0]) <= 1e-12 * abs(device_trace[0]),
          f"host-lbfgs: f at iteration 0 {f[0]!r} differs from the device "
          f"minimize's {device_trace[0]!r}")
    k = min(len(f), len(device_trace))
    print(f"host-lbfgs: {res.iterations} iterations, {res.fun_evals} "
          f"evaluations, status {res.status}, in {secs:.3f} s; per "
          f"evaluation {clock['total'] / res.fun_evals * 1e3:.3f} ms, of which "
          f"the host copies {clock['copies'] / clock['total']:.3f}; f[0] "
          f"{'equal to' if f[0] == device_trace[0] else 'within 1e-12 of'} "
          f"the device minimize's; f at iterations 0..{k - 1} minus the "
          f"device minimize's: max |diff| {np.abs(f[:k] - device_trace[:k]).max():.3e}; "
          f"final f {f[-1]:.10f} (device {device_trace[-1]:.10f}); launches "
          f"fwd/bwd {got}")
    check(got == (res.fun_evals, res.fun_evals), "host-lbfgs: launches "
          "differ from one forward and one backward per evaluation")
    return got


def phase_derivcheck(model, X, Y, psi, tr) -> tuple:
    """15. check_gradient on nlog_ml(flat0 + U z) at 4,096 rows, U 32
    seeded unit directions; (fwd, bwd) launches."""
    import torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.model import _make_dataset
    from gpz_tpu_torch.objective import nlog_ml
    from gpz_tpu_torch.optim import check_gradient
    from make_torch_port_golden import objective_rows

    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[:, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)
    flat0, unravel = model.last.params.flatten()
    dev = flat0.device
    data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), objective_rows(tr),
                         torch.float64, dev)
    U = np.random.default_rng(15).standard_normal((flat0.numel(),
                                                   DERIV_DIRECTIONS))
    U = torch.as_tensor(U / np.linalg.norm(U, axis=0), device=dev)

    def f(zt):
        return nlog_ml(unravel(flat0 + U @ zt), data, model.cfg,
                       complete=True)[0]

    reset_launches()
    t0 = time.perf_counter()
    ok, err = check_gradient(f, torch.zeros(DERIV_DIRECTIONS,
                                            dtype=torch.float64, device=dev))
    secs = time.perf_counter() - t0
    got = launches()
    want = (1 + 2 * DERIV_DIRECTIONS, 1)
    print(f"derivcheck: nlog_ml on {data.n} rows along {DERIV_DIRECTIONS} "
          f"random unit directions: ok {ok}, max abs error {err:.3e}, in "
          f"{secs:.3f} s; launches fwd/bwd {got} (expected {want})")
    check(ok, f"derivcheck: autograd through the kernel pair disagrees with "
          f"central differences (max abs error {err:.3e})")
    check(got == want, "derivcheck: launch counts differ")
    return got


def phase_bench(smi: str) -> tuple:
    """16. `python -m gpz_tpu_torch bench` as a process; then bench.main()
    in this process for its launches; (fwd, bwd)."""
    import contextlib
    import io
    from gpz_tpu_torch import bench

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "gpz_tpu_torch", "bench"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    check(res.returncode == 0, f"bench: exit {res.returncode}\n"
          f"{res.stderr[-2000:]}")
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"bench: {len(lines)} JSON lines")
    out = json.loads(lines[0])
    check(set(out) == {"metric", "value", "unit", "vs_baseline"}
          and out["metric"] == "logML_grad_evals_per_sec_VC_m100_n100k"
          and np.isfinite(out["value"]) and out["value"] > 0,
          f"bench: {out}")
    print(f"bench: {lines[0]} on {smi} ({secs:.1f} s as a process)")
    reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench.main()
    got = launches()
    want = (2 * bench.ITERS, 2 * bench.ITERS)  # warm-up run + timed run
    print(f"bench: in this process {buf.getvalue().strip()}; launches "
          f"fwd/bwd {got} (expected {want})")
    check(got == want, "bench: launch counts differ")
    return got


def phase_convergence(cmd=None) -> tuple:
    """8. `python -m gpz_tpu_torch.bench_convergence` as a process, in its
    default mode (a fresh and a process-warm training): both reach the
    target (best nlml at or below target + 1e-3 * |target|), with a
    converged status; whether the two runs are bit-equal (a report); the
    process's wall clock broken down
    by its own timestamps; its launches held to what its two trainings
    imply. Returns ((fwd, bwd), the two run records)."""
    from gpz_tpu_torch import bench_convergence as bc

    cmd = cmd or [sys.executable, "-m", "gpz_tpu_torch.bench_convergence"]
    t_launch = time.time()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    t_exit = time.time()
    check(res.returncode == 0, f"convergence: exit {res.returncode}\n"
          f"{res.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in res.stdout.splitlines()
             if ln.startswith("{")]
    check(len(lines) == 4, f"convergence: {len(lines)} JSON lines, not 4")
    runs, metric, proc = lines[:2], lines[2], lines[3]
    check([r["label"] for r in runs] == ["fresh_process", "process_warm"]
          and metric["metric"] == "seconds_to_f64_logML_VC_m100_n70k",
          f"convergence: unexpected records {[r.get('label') for r in runs]}"
          f", {metric}")
    tol = 1e-3 * abs(TARGET_NLML)
    for r in runs:
        gap = r["best_nlml"] - TARGET_NLML
        print(f"north-star: {r['label']}: {r['iterations']} iterations, "
              f"{r['fun_evals']} evaluations, status {r['status_name']}; "
              f"train {r['train_seconds']} s, seconds_to_target "
              f"{r['seconds_to_target']}; best nlml {r['best_nlml']:.8f} "
              f"(best - target {gap:+.3e}, band {tol:.3e}), final "
              f"{r['final_nlml']:.8f}, best validation log-likelihood "
              f"{r['best_valid_ll']:.6f}")
        check(r["target_nlml"] == TARGET_NLML, "convergence: target differs")
        # reached from above, as the JAX script's reached_target: the
        # target is the best nlml of a 200-iteration float64 run that had not
        # converged (max|g| 2.3e-3), so MAX_ITER = 320 may go below it
        check(r["reached_target"] and gap <= tol
              and r["status"] in bc.CONVERGED_STATUSES,
              f"convergence: {r['label']} did not reach the target with a "
              "converged status")
    same = all(runs[0][k] == runs[1][k] for k in (
        "best_nlml", "final_nlml", "iterations", "fun_evals", "status"))
    print(f"north-star: the two trainings bit-equal in nlml, iterations, "
          f"evaluations and status: {same}")
    st, prev, marks = proc["timestamps"], t_launch, []
    for key, what in (("import", "interpreter, torch and package imports"),
                      ("cuda_context", "CUDA context"),
                      ("kernel_library", "kernel library"),
                      ("problem", "problem"),
                      ("fresh_process_end", "fresh training (init + train)"),
                      ("process_warm_end",
                       "process-warm training (init + train)")):
        if key not in st:       # the CUDA stamps, off the GPU
            continue
        marks.append((what, prev, st[key]))
        prev = st[key]
    marks.append(("exit", prev, t_exit))
    wall = t_exit - t_launch
    print(f"north-star: the process took {wall:.3f} s; "
          + "; ".join(f"{what} {b - a:.3f} s" for what, a, b in marks)
          + f"; metric line {json.dumps(metric)}")
    got = (proc["launches"]["vc_lnphi_fwd"], proc["launches"]["vc_lnphi_bwd"])
    # per training, as phase 7 counts them: init's posterior one forward;
    # per evaluation one of each; one forward per scored iteration
    # (0..iterations); posterior + prior for each of `last` and `best`
    want = (sum(1 + r["fun_evals"] + r["iterations"] + 1 + 4 for r in runs),
            sum(r["fun_evals"] for r in runs))
    print(f"north-star: launches fwd/bwd {got} (expected {want})")
    check(got == want, "convergence: launch counts differ from what the two "
          "trainings imply")
    return got, runs


def phase_demos(device=None) -> tuple:
    """19. The three demos' run() at the JAX scripts' default sizes in
    float64: outputs finite, every trace non-increasing, every printed
    number within 1e-3 * max(1, |JAX's|) of JAX's full-size value
    (tests/data/torch_port_golden_demos.npz); demo_photoz's launches and
    the shapes of its kernel sites held to what its evaluations and predict
    batches imply, and the pair held to plain at every shape it launched.
    Returns ((fwd, bwd), forward sites, backward sites)."""
    import torch
    from make_torch_port_golden import DEMO_NUMBERS, DEMOS, load_golden_demos

    golden = load_golden_demos()
    fwd_sites, bwd_sites, pred_sites = {}, {}, {}
    total = [0, 0]
    for demo in DEMOS:
        mod = importlib.import_module(f"gpz_tpu_torch.demos.demo_{demo}")
        reset_launches()
        if demo == "photoz":
            with pair_recorded(fwd_sites, bwd_sites), recording(
                    "gpz_tpu_torch.predict", "vc_lnphi_complete",
                    pred_sites):
                r = mod.run(dtype="float64", device=device)
        else:
            r = mod.run(device=device)
        torch.cuda.synchronize()
        got = launches()
        total = [total[0] + got[0], total[1] + got[1]]
        for fit in r["fits"]:
            tr_ = fit["trace"]
            check(all(np.isfinite(a).all() for a in (
                tr_["f"], tr_["opt_cond"], tr_["step"], tr_["score"],
                *tr_["extras"].values())), f"demo_{demo}: non-finite trace")
            check(bool(np.all(np.diff(tr_["f"]) <= 0)),
                  f"demo_{demo}: f increased over an accepted iteration")
        gaps = []
        for name, want in zip(DEMO_NUMBERS[demo],
                              golden[f"{demo}.full.values"]):
            band = 1e-3 * max(1.0, abs(float(want)))
            gap = r[name] - float(want)
            gaps.append(abs(gap) / band)
            check(np.isfinite(r[name]), f"demo_{demo}: {name} not finite")
            print(f"demo_{demo}: {name} {r[name]:.6f} (JAX {float(want):.6f},"
                  f" gap {gap:+.3e}, band {band:.1e}, gap/band "
                  f"{gaps[-1]:.3f})")
        fits = "; ".join(f"{f['iterations']} iterations, {f['fun_evals']} "
                         f"evaluations, status {f['status']}"
                         for f in r["fits"])
        print(f"demo_{demo}: {r['seconds']:.3f} s ({fits}); launches fwd/bwd"
              f" {got}; worst gap/band {max(gaps):.3f}")
        check(max(gaps) <= 1.0, f"demo_{demo}: a printed number differs from "
              "JAX's full-size value beyond 1e-3 * max(1, |value|)")
        if demo != "photoz":
            check(got == (0, 0), f"demo_{demo}: launched the VC kernel pair")
            continue
        # photo-z: the pair's sites and counts, from its evaluations and
        # predict's batches
        model, fit = r["model"], r["fits"][0]
        m, n_tr, n_va = model.cfg.m, r["n_train"], r["n_valid"]
        want_fwd = {(n_tr, m): 1 + fit["fun_evals"] + 4}
        want_fwd[(n_va, m)] = want_fwd.get((n_va, m), 0) + fit[
            "iterations"] + 1
        want_pred = expected_sites(model.cfg, complete_calls(model.cfg,
                                                             r["n_test"]))
        want_bwd = {(n_tr, m): fit["fun_evals"]}
        check(site_counts(fwd_sites) == want_fwd
              and site_counts(bwd_sites) == want_bwd
              and site_counts(pred_sites) == want_pred,
              f"demo_photoz: sites {site_counts(fwd_sites)}, "
              f"{site_counts(bwd_sites)}, {site_counts(pred_sites)}; the "
              f"path implies {want_fwd}, {want_bwd}, {want_pred}")
        want = (sum(want_fwd.values()) + sum(want_pred.values()),
                fit["fun_evals"])
        check(got == want, f"demo_photoz: launches {got}, the path implies "
              f"{want}")
        print(f"demo_photoz: {n_tr} training, {n_va} validation and "
              f"{r['n_test']} test rows; "
              f"launches as the path implies {want}: training "
              f"{want_fwd}, predict {want_pred}")
    fwd = compare_sites("demo-photoz", fwd_sites, "demo run",
                        key="launches")
    fwd.update(compare_sites("demo-photoz-predict", pred_sites, "demo run",
                             key="launches"))
    bwd = compare_bwd_sites("demo-photoz", bwd_sites, "demo run")
    return tuple(total), fwd, bwd


def host_peak(fn) -> tuple:
    """(fn(), the peak of host memory that Python and NumPy allocated while
    fn ran, in bytes, by tracemalloc; memory held before fn is not in it)."""
    import tracemalloc

    tracemalloc.start()
    try:
        out = fn()
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    return out, peak


def compare_big(name, args, g, sets=1, rows=50_000, tol="trained") -> tuple:
    """The kernel pair against plain at a shape past 10**8 pairs, where the
    plain versions take seconds and their (n, m) outputs gigabytes: the
    forward's output held to plain a chunk of `rows` rows at a time, the
    backward twice (bit-equal) against the plain backward once (not against
    autograd through plain, whose graph would hold every row block's
    (rows, m, d, d) systems). Plain runs once each way, timed by CUDA
    events, out of the kernels' timing loops. Returns (forward record,
    backward record)."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    X, psi, P, Sigma, lds = args[:5]
    n, m, d = X.shape[0], P.shape[0], X.shape[1]
    rtol, atol = KERNEL_TOL[tol]
    got = vc_phi.vc_lnphi_complete(*args[:5])
    plain_ms, max_abs, worst = 0.0, 0.0, 0.0
    for r0 in range(0, n, rows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = vc_phi.vc_lnphi_plain(X[r0:r0 + rows], psi[r0:r0 + rows], P,
                                     Sigma, lds)
        end.record()
        end.synchronize()
        plain_ms += start.elapsed_time(end)
        part = got[r0:r0 + rows]
        fin = torch.isfinite(want)
        check(bool((torch.isfinite(part) == fin).all()),
              f"{name}: non-finite entries differ from the plain version")
        err = (part - want).abs()[fin]
        max_abs = max(max_abs, float(err.max()))
        worst = max(worst, float((err / (atol + rtol * want.abs()[fin]))
                                 .max()))
    del got, want, part
    check(worst <= 1.0, f"{name}: kernel disagrees with the plain version "
          f"beyond rtol={rtol}, atol={atol}")
    few = dict(trials=3, calls=2, warmup=1)
    fwd = {"max_abs_err": max_abs, "plain_ms": plain_ms,
           "ms": median_ms(lambda: vc_phi.vc_lnphi_complete(*args[:5]),
                           **few)}
    b = bound("fwd", n, m, d, "float64")
    print(f"kernel {name}: {shape_line(args)} max_abs_err={max_abs:.3e} "
          f"(err/bound {worst:.3f}, plain in chunks of {rows} rows) kernel "
          f"{fwd['ms']:.4f} ms, {fwd['ms'] / b['bound_ms']:.2f}x its bound "
          f"{b['bound_ms']:.5f} ms by {b['bound_by']}; plain {plain_ms:.1f} "
          "ms (once)")

    got = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g, sets)
    again = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g, sets)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = vc_phi.vc_lnphi_bwd_plain(X, psi, P, Sigma, g, sets)
    end.record()
    end.synchronize()
    check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
          f"{name}: two backward launches on the same inputs differ in "
          "their bits")
    check(torch.equal(got[1], got[1].transpose(1, 2)),
          f"{name}: dSigma's triangles differ")
    rtol, atol = KERNEL_BWD_TOL[tol]
    bmax, bworst = 0.0, 0.0
    for part, a, w in zip(("dP", "dSigma"), got, plain):
        check(bool(torch.isfinite(a).all() and torch.isfinite(w).all()),
              f"{name}: non-finite {part}")
        err = float((a - w).abs().max())
        ratio = err / (atol + rtol * float(w.abs().max()))
        bmax, bworst = max(bmax, err), max(bworst, ratio)
        check(ratio <= 1.0, f"{name}: backward {part} disagrees with plain "
              f"beyond rtol={rtol}, atol={atol} of its largest entry "
              f"(max_abs_err {err:.3e})")
    bwd = {"max_abs_err": bmax, "plain_ms": start.elapsed_time(end),
           "ms": median_ms(lambda: vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g,
                                                       sets), **few)}
    b = bound("bwd", n, m, d, "float64")
    print(f"kernel-bwd {name}: {shape_line(args)} max_abs_err={bmax:.3e} "
          f"(err/bound {bworst:.3f}) vs plain, two launches bit-identical; "
          f"kernel {bwd['ms']:.4f} ms, {bwd['ms'] / b['bound_ms']:.2f}x its "
          f"bound {b['bound_ms']:.5f} ms by {b['bound_by']}; plain "
          f"{bwd['plain_ms']:.1f} ms (once)")
    return fwd, bwd


def phase_scale(device=None) -> tuple:
    """20. BASELINE.json configs[4]'s per-card problem through the entry
    points: VC m=1000, d=5, k=1, heteroscedastic, psi (n, d, d), float64, on
    make_torch_port_golden.scale_problem's 1,000,000 training and 100,000
    validation rows. (a) init on the card: host seconds, host memory, device
    peak memory; its length scales held to gpz_tpu's expression evaluated
    unblocked on the host (SCALE_TOL). (b) the sub-problem against
    tests/data/torch_port_golden_scale.npz: init on its 20,000 rows, the
    objective and gradient on 8,192 rows, the predictions of 16 complete
    rows and 4 rows with NaNs at its init point, 3 iterations of training.
    (c) train for SCALE_ITERS iterations at full size: the trace, status,
    evaluations and seconds per evaluation of every iteration, device peak
    memory. (d) save_model / load_model, then the loaded model serves the
    20,000 complete rows and the 1,000 rows with NaNs: rows/s, coverage,
    escalations; the predict sites' launches held to expected_sites. (e)
    the kernel pair against plain at every shape (a)-(d) launched. Then one
    evaluation at full size under the profiler. Returns ((fwd, bwd)
    launches of (a)-(d), forward sites, backward sites, (the loaded model,
    TOPL_ROWS served rows without band 0, their psi) for phase 21)."""
    import resource

    import torch
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.model import _make_dataset
    from gpz_tpu_torch.optim import lbfgs
    from make_torch_port_golden import (
        OUTPUTS, SCALE_M, SCALE_OBJECTIVE_ROWS, SCALE_SUB,
        SCALE_TOL, SCALE_TRACE_ITERS, load_golden_scale, scale_nan_picks,
        scale_problem,
    )

    predict_mod = importlib.import_module("gpz_tpu_torch.predict")
    model_mod = importlib.import_module("gpz_tpu_torch.model")
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    f64 = torch.float64
    gold = load_golden_scale()
    X, Y, psi, tr, va, served, (pos, Xm) = scale_problem(synthetic_sdss)
    psi_m = psi[served[pos]]
    n_tr, n_va = int(tr.sum()), int(va.sum())
    total_mem = torch.cuda.get_device_properties(0).total_memory
    fwd_sites, bwd_sites, pred_sites = {}, {}, {}
    pred_calls = []

    def serve(X_, model_, psi_):
        (pred, sec), calls = moments_calls(
            lambda: timed_predict(X_, model_, psi_))
        pred_calls.extend(calls)
        return pred, sec, calls

    torch.cuda.synchronize()
    reset_launches()
    with pair_recorded(fwd_sites, bwd_sites, host_above=10**8), recording(
            "gpz_tpu_torch.predict", "vc_lnphi_complete", pred_sites):
        # (a) init at full size
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, init_host = host_peak(lambda: gpz_tpu_torch.init(
            X, Y, "VC", SCALE_M, heteroscedastic=True, training=tr, psi=psi,
            seed=1, dtype="float64", device=device))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_dev = torch.cuda.max_memory_allocated()
        check(model.last.params.P.device == dev,
              "scale: init did not build the model on the card")

        # gpz_tpu.init's length-scale heuristic as it writes it: one (n, m)
        # distance matrix, unblocked, on the host (gpz_tpu/model.py:291-295)
        def unblocked():
            Xtr = ((X - model.muX[None, :]) / model.sdX[None, :])[tr]
            mu_p, cov_p, _ = datautils.pca_whiten_np(Xtr)
            Xl = datautils.fill_linear_np(Xtr, mu_p, cov_p)
            P = model.last.params.P.cpu().numpy()
            D = np.abs((Xl**2).sum(1)[:, None] + (P**2).sum(1)[None, :]
                       - 2.0 * Xl @ P.T)
            return np.sqrt(0.5 * SCALE_M ** (1.0 / Xl.shape[1])
                           / D.mean(axis=0))

        t0 = time.perf_counter()
        gamma_ref, ref_host = host_peak(unblocked)
        ref_s = time.perf_counter() - t0
        G = model.last.params.gamma.cpu().numpy()
        gamma_got = np.einsum("mii->mi", G)
        off = np.abs(G - np.einsum("mi,ij->mij", gamma_got, np.eye(G.shape[1])))
        err_g = float(np.max(np.abs(gamma_got - gamma_ref[:, None])))
        print(f"scale-init: VC m={SCALE_M} on {n_tr} training rows of "
              f"{len(Y)} in {init_s:.3f} s (host memory allocated at its "
              f"peak {init_host / 1e9:.3f} GB, tracemalloc; device peak "
              f"{init_dev / 2**30:.3f} GiB, the posterior's one forward at "
              f"({n_tr} x {SCALE_M})); gpz_tpu's expression unblocked on the "
              f"host {ref_s:.3f} s, {ref_host / 1e9:.3f} GB at its peak; "
              f"length scales blocked vs unblocked max_abs {err_g:.3e} of "
              f"{np.abs(gamma_ref).max():.3e} (bit-equal: "
              f"{bool(err_g == 0.0)}); process peak RSS "
              f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.3f}"
              " GB in its lifetime")
        check(err_g <= SCALE_TOL["init.flat"] and float(off.max()) == 0.0,
              "scale-init: length scales differ from gpz_tpu's unblocked "
              f"expression beyond {SCALE_TOL['init.flat']}")

        # (b) the sub-problem against the golden file
        sub = slice(0, SCALE_SUB)
        t0 = time.perf_counter()
        sub_model = gpz_tpu_torch.init(X[sub], Y[sub], "VC", SCALE_M,
                                       heteroscedastic=True, psi=psi[sub],
                                       seed=1, dtype="float64",
                                       device=device)
        flat_s, unravel_s = sub_model.last.params.flatten()
        err0 = float(np.max(np.abs(flat_s.cpu().numpy()
                                   - gold["sub.init.flat"])))
        print(f"scale-sub: init on {SCALE_SUB} rows, flat parameters vs "
              f"JAX's max_abs {err0:.3e}")
        check(err0 <= SCALE_TOL["sub.init.flat"], "scale-sub: init differs "
              f"from the JAX package's beyond {SCALE_TOL['sub.init.flat']}")
        rows = np.zeros(SCALE_SUB, bool)
        rows[:SCALE_OBJECTIVE_ROWS] = True
        Xn = (X[sub] - sub_model.muX[None, :]) / sub_model.sdX[None, :]
        Yc = Y[sub, None] - sub_model.muY[None, :]
        psi_c = datautils.fix_psi(psi[sub], SCALE_SUB, sub_model.sdX, True)
        data_o = _make_dataset(Xn, Yc, psi_c, np.ones(SCALE_SUB), rows, f64,
                               dev)
        nlml, grad = objective_at(
            torch.as_tensor(gold["sub.init.flat"], device=dev), unravel_s,
            data_o, sub_model.cfg)
        del data_o
        within(f"scale-sub: nlml on {SCALE_OBJECTIVE_ROWS} rows "
               f"{nlml:.12f} (JAX {float(gold['init.nlml']):.12f})",
               nlml, gold["init.nlml"], SCALE_TOL["init.nlml"])
        within(f"scale-sub: gradient on {SCALE_OBJECTIVE_ROWS} rows",
               grad, gold["init.grad"], SCALE_TOL["init.grad"])
        c_rows = served[:len(gold["complete.mu"])]
        pc, _, _ = serve(X[c_rows], sub_model, psi[c_rows])
        for k_ in OUTPUTS:
            within(f"scale-sub: {len(c_rows)} complete rows {k_}",
                   getattr(pc, k_), gold[f"complete.{k_}"],
                   SCALE_TOL["complete"][k_])
        picks = scale_nan_picks(Xm)
        check(np.array_equal(picks, gold["missing.picks"]),
              "scale-sub: golden rows with NaNs differ from this draw")
        pm, _, calls = serve(Xm[picks], sub_model, psi_m[picks])
        for k_ in OUTPUTS:
            within(f"scale-sub: {len(picks)} rows with NaNs {k_}",
                   getattr(pm, k_), gold[f"missing.{k_}"],
                   SCALE_TOL["missing"][k_])
        # the guard's reading of each pattern group (np.unique's order, as
        # both packages' predict groups rows) and its escalation
        _, group = np.unique(~np.isnan(Xm[picks]), axis=0,
                             return_inverse=True)
        first = [int(np.where(group.ravel() == g_)[0][0])
                 for g_ in range(group.max() + 1)]
        cov_jax = gold["missing.coverage"][first]
        esc_jax = gold["missing.escalated"][first]
        cov_got = np.array([c[3] for c in calls if c[3] is not None])
        esc_got = np.array([c[2] == SCALE_M for c in calls
                            if c[3] is None])
        print(f"scale-sub: coverage of the top {predict_mod.MIX_TOPL} per "
              f"group {np.round(cov_got, 9).tolist()} (JAX "
              f"{np.round(cov_jax, 9).tolist()}), escalated "
              f"{int(esc_got.sum())} of {len(cov_got)} (JAX "
              f"{int(esc_jax.sum())})")
        check(cov_got.shape == cov_jax.shape
              and float(np.max(np.abs(cov_got - cov_jax))) <= 1e-9
              and int(esc_got.sum()) == int(esc_jax.sum()),
              "scale-sub: the coverage guard's readings or escalations "
              "differ from JAX's")
        sub_fit = gpz_tpu_torch.train(
            sub_model, X[sub], Y[sub], psi=psi[sub],
            max_iter=SCALE_TRACE_ITERS, max_attempts=MAX_ATTEMPTS,
            verbose=False).fit_info
        k = len(gold["trace.f"])
        check(sub_fit["iterations"] + 1 == k, "scale-sub: "
              f"{sub_fit['iterations']} iterations, JAX {k - 1}")
        within(f"scale-sub: f at iterations 0..{k - 1} "
               f"{np.round(sub_fit['trace']['f'][:k], 10).tolist()}",
               sub_fit["trace"]["f"][:k], gold["trace.f"],
               SCALE_TOL["trace.f"])
        check(np.array_equal(sub_fit["trace"]["fevals"][:k],
                             gold["trace.fevals"]),
              "scale-sub: evaluation counts differ from JAX's")
        sub_evals = sub_fit["fun_evals"]
        print(f"scale-sub: evaluations {sub_fit['trace']['fevals'].tolist()}"
              f" (JAX {gold['trace.fevals'].tolist()}), status "
              f"{sub_fit['status']}; (a)-(b) in "
              f"{time.perf_counter() - t0:.1f} s")
        del sub_model

        # (c) training at full size, every evaluation timed
        eval_s = []
        real_objective = model_mod._objective

        def timed_objective(*a):
            fun = real_objective(*a)

            def timed(flat):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fun(flat)
                torch.cuda.synchronize()
                eval_s.append(time.perf_counter() - t1)
                return out
            return timed

        before_f, before_b = site_counts(fwd_sites), site_counts(bwd_sites)
        model_mod._objective = timed_objective
        torch.cuda.reset_peak_memory_stats()
        try:
            t0 = time.perf_counter()
            fitted = gpz_tpu_torch.train(
                model, X, Y, training=tr, validation=va, psi=psi,
                max_iter=SCALE_ITERS, max_attempts=MAX_ATTEMPTS,
                verbose=False)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            model_mod._objective = real_objective
        peak, reserved = (torch.cuda.max_memory_allocated(),
                          torch.cuda.max_memory_reserved())
        fit = fitted.fit_info
        trace = fit["trace"]
        n_it, evals = fit["iterations"], fit["fun_evals"]
        fev = np.asarray(trace["fevals"])
        for i in range(n_it + 1):
            lo = int(fev[i - 1]) if i else 0
            secs = eval_s[lo:int(fev[i])]
            print(f"scale-train: iteration {i}: f {trace['f'][i]:.10f}, "
                  f"evaluations {int(fev[i])} (+{len(secs)}), seconds per "
                  f"evaluation {[round(x_, 4) for x_ in secs]}, valid ll "
                  f"{trace['extras']['valid_ll'][i]:.6f}")
        check(all(np.isfinite(a).all() for a in (
            trace["f"], trace["opt_cond"], trace["step"], trace["score"],
            *trace["extras"].values())), "scale-train: non-finite trace")
        check(bool(np.all(np.diff(trace["f"]) <= 0)),
              "scale-train: f increased over an accepted iteration")
        check(n_it == SCALE_ITERS or fit["status"] in (
            lbfgs.STATUS_OPTIMAL, lbfgs.STATUS_STEP_TOO_SMALL,
            lbfgs.STATUS_EARLY_STOP),
              f"scale-train: {n_it} iterations, status {fit['status']}")
        check(len(eval_s) == evals, "scale-train: timed evaluations differ "
              "from the run's")
        med = float(np.median(eval_s[1:] if len(eval_s) > 1 else eval_s))
        print(f"scale-train: {n_it} iterations, {evals} evaluations, status "
              f"{fit['status']} in {train_s:.3f} s ({train_s / evals:.4f} s "
              f"per evaluation with scoring and resolving; evaluations alone "
              f"median {med:.4f} s, first {eval_s[0]:.4f} s with the "
              f"recording's copy of its ({n_tr}, {SCALE_M}) cotangent to the "
              f"host, synchronized); "
              f"final nlml {fit['final_nlml']:.10f}; device peak "
              f"{peak / 2**30:.3f} GiB allocated, {reserved / 2**30:.3f} GiB "
              f"reserved, of {total_mem / 2**30:.3f} GiB")
        check(reserved < total_mem, "scale-train: device memory reached the "
              "card's")
        after_f, after_b = site_counts(fwd_sites), site_counts(bwd_sites)
        big, val = (n_tr, SCALE_M), (n_va, SCALE_M)
        got_f = {s_: after_f.get(s_, 0) - before_f.get(s_, 0)
                 for s_ in after_f}
        got_b = {s_: after_b.get(s_, 0) - before_b.get(s_, 0)
                 for s_ in after_b}
        want_f = {big: evals + 4, val: n_it + 1}
        check({s_: c_ for s_, c_ in got_f.items() if c_} == want_f
              and {s_: c_ for s_, c_ in got_b.items() if c_} == {big: evals},
              f"scale-train: launches by shape {got_f}, {got_b}; the path "
              f"implies {want_f}, {{{big}: {evals}}}")

        # (d) checkpoint round trip, then serving from the loaded copy
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "scale.npz")
            t0 = time.perf_counter()
            gpz_tpu_torch.save_model(fitted, path)
            save_s = time.perf_counter() - t0
            size = os.path.getsize(path)
            t0 = time.perf_counter()
            loaded = gpz_tpu_torch.load_model(path, device=device)
            load_s = time.perf_counter() - t0
        check(loaded.best.params.P.device == model.last.params.P.device
              and torch.equal(loaded.best.params.flatten()[0],
                              fitted.best.params.flatten()[0])
              and torch.equal(loaded.best.post.iSigma_w,
                              fitted.best.post.iSigma_w),
              "scale-checkpoint: the loaded model differs from the saved")
        print(f"scale-checkpoint: {size} bytes, save {save_s:.3f} s, load "
              f"{load_s:.3f} s, best parameters and posterior bit-equal")
        del model, fitted
        esc_s = []
        real_moments = predict_mod.predict_moments_full

        def timed_moments(*a, **kw):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = real_moments(*a, **kw)
            torch.cuda.synchronize()
            if kw.get("mix_topl") == SCALE_M:
                esc_s.append(time.perf_counter() - t1)
            return out

        predict_mod.predict_moments_full = timed_moments
        try:
            pc, sec_c, calls_c = serve(X[served], loaded, psi[served])
            pm, sec_m, calls_m = serve(Xm, loaded, psi_m)
        finally:
            predict_mod.predict_moments_full = real_moments
        for label, pred, n_ in (("complete", pc, len(served)),
                                ("with NaNs", pm, len(Xm))):
            check(all(np.isfinite(getattr(pred, k_)).all()
                      for k_ in OUTPUTS + ("phi",))
                  and pred.mu.shape == (n_, 1) and pred.sigma.min() > 0
                  and pred.nu.min() >= 0 and pred.gamma.min() >= 0,
                  f"scale-serve: rows {label}: non-finite or negative")
        cov = [c[3] for c in calls_m if c[3] is not None]
        n_esc = sum(1 for c in calls_m if c[2] == SCALE_M)
        check(n_esc == sum(1 for c_ in cov
                           if c_ < predict_mod.MIX_COVERAGE_MIN),
              "scale-serve: escalations differ from the guarded batches "
              "below MIX_COVERAGE_MIN")
        print(f"scale-serve: {len(served)} complete rows in {sec_c:.3f} s "
              f"({len(served) / sec_c:.1f} rows/s, {len(calls_c)} batches); "
              f"{len(Xm)} rows with NaNs in {sec_m:.3f} s "
              f"({len(Xm) / sec_m:.1f} rows/s, {len(calls_m)} moment calls); "
              f"top-{predict_mod.MIX_TOPL} coverage over {len(cov)} guarded "
              f"batches: least {min(cov):.9f}; {n_esc} escalated to the "
              f"exact {SCALE_M}-component sum, "
              f"{[round(x_, 3) for x_ in esc_s]} s each")
        want_pred = expected_sites(loaded.cfg, pred_calls)
        check(site_counts(pred_sites) == want_pred, "scale-serve: predict "
              f"launched {site_counts(pred_sites)}, the budgets imply "
              f"{want_pred}")
        sub_shape = (SCALE_SUB, SCALE_M)
        want_all_f = {big: 1 + evals + 4, val: n_it + 1,
                      sub_shape: 1 + sub_evals + 4,
                      (SCALE_OBJECTIVE_ROWS, SCALE_M): 1}
        want_all_b = {big: evals, sub_shape: sub_evals,
                      (SCALE_OBJECTIVE_ROWS, SCALE_M): 1}
        check(site_counts(fwd_sites) == want_all_f
              and site_counts(bwd_sites) == want_all_b,
              f"scale: objective sites {site_counts(fwd_sites)}, "
              f"{site_counts(bwd_sites)}; the path implies {want_all_f}, "
              f"{want_all_b}")
    torch.cuda.synchronize()
    got = launches()
    want = (sum(want_all_f.values()) + sum(want_pred.values()),
            sum(want_all_b.values()))
    check(got == want, f"scale: launches {got}, the path implies {want}")
    print(f"scale: main path (a)-(d) in {time.perf_counter() - t_phase:.1f} s"
          f"; launches fwd/bwd {got} as the path implies: objective "
          f"{want_all_f}, {want_all_b}; predict {want_pred}")
    del pc, pm

    # one warm evaluation at full size under the profiler, out of the count
    Xn = (X - loaded.muX[None, :]) / loaded.sdX[None, :]
    Yc = Y[:, None] - loaded.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), loaded.sdX, True)
    data_tr = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), tr, f64, dev)
    flat_b, unravel_b = loaded.best.params.astype(f64).flatten()

    def evaluation(f_=flat_b):
        return objective_at(f_, unravel_b, data_tr, loaded.cfg)

    def peak_of(fn) -> tuple:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        return torch.cuda.max_memory_allocated(), held

    # the device peak of one evaluation, and with lnN held as the objective
    # held it before (until its Gram's forward ends)
    obj_mod = importlib.import_module("gpz_tpu_torch.objective")
    real_dm, real_terms = obj_mod.design_matrix, obj_mod._gram_terms
    kept = []

    def keeping_dm(*a, **kw):
        out = real_dm(*a, **kw)
        kept.append(out[1])
        return out

    def releasing_terms(*a, **kw):
        out = real_terms(*a, **kw)
        kept.clear()
        return out

    peak_eval, held = peak_of(evaluation)
    obj_mod.design_matrix, obj_mod._gram_terms = keeping_dm, releasing_terms
    try:
        peak_kept, _ = peak_of(evaluation)
    finally:
        obj_mod.design_matrix, obj_mod._gram_terms = real_dm, real_terms
    print(f"scale-memory: one evaluation at ({n_tr} x {SCALE_M}) peaks at "
          f"{peak_eval / 2**30:.3f} GiB allocated ({held / 2**30:.3f} GiB "
          f"held before it: data and models); with lnN held until the "
          f"Gram's forward ends {peak_kept / 2**30:.3f} GiB")
    profile_evaluation(evaluation, flat_b)
    del data_tr
    reset_launches()
    # phase 21 (c): TOPL_ROWS served rows without band 0, one batch
    topl_rows = served[:TOPL_ROWS]
    X_topl = X[topl_rows].copy()
    X_topl[:, 0] = np.nan
    topl_batch = (loaded, X_topl, psi[topl_rows])

    # (e) the kernel pair against plain at every shape (a)-(d) launched
    t0 = time.perf_counter()
    fwd, bwd = {}, {}
    big_f = fwd_sites.pop(big)
    big_b = bwd_sites.pop(big)
    args_b = moved(big_b[1], dev)
    rec_f, rec_b = compare_big(f"scale-{n_tr}x{SCALE_M}", moved(big_f[1], dev),
                               args_b[4], *args_b[5:])
    del args_b
    for rec, kind, count in ((rec_f, "fwd", big_f[0]),
                             (rec_b, "bwd", big_b[0])):
        rec.update(shape=list(big), launches=count,
                   bound_ms=bound(kind, n_tr, SCALE_M, X.shape[1],
                                  "float64")["bound_ms"])
    fwd[f"scale-{n_tr}x{SCALE_M}"] = rec_f
    bwd[f"scale-bwd-{n_tr}x{SCALE_M}"] = rec_b
    fwd.update(compare_sites("scale", fwd_sites, "phase-20 run",
                             key="launches"))
    fwd.update(compare_sites("scale-predict", pred_sites, "phase-20 run",
                             key="launches"))
    bwd.update(compare_bwd_sites("scale", bwd_sites, "phase-20 run"))
    print(f"scale: kernel pair vs plain at {len(fwd)} forward and {len(bwd)} "
          f"backward shapes in {time.perf_counter() - t0:.1f} s")
    return got, fwd, bwd, topl_batch


def phase_wide(dev) -> dict:
    """Phase 21 (a): the wide variant of the kernel pair (d > 8) against
    plain on the card; returns {d: (forward record, backward record)} at
    WIDE_SHAPES."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    t0 = time.perf_counter()
    f64 = torch.float64
    rng = np.random.default_rng(21)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    wide = {}
    for n, d in WIDE_SHAPES:
        args = random_inputs(rng, n, d, TRAIN_M, f64, dev)
        g = torch.randn((n, TRAIN_M), dtype=f64, device=dev, generator=gen)
        reset_launches()
        rec_f, rec_b = compare_big(f"wide-d{d}-{n}x{TRAIN_M}", args, g,
                                   tol="float64")
        check(all(c > 0 for c in launches()),
              f"wide d={d}: the kernel pair did not launch")
        for rec, kind in ((rec_f, "fwd"), (rec_b, "bwd")):
            b = bound(kind, n, TRAIN_M, d, "float64")
            rec.update(shape=[n, TRAIN_M, d], bound_ms=b["bound_ms"],
                       bound_by=b["bound_by"])
        wide[d] = (rec_f, rec_b)
        del args, g
    for d, dt_name in ((9, "float64"), (12, "float64"), (16, "float64"),
                       (32, "float64"), (48, "float64"), (9, "float32"),
                       (16, "float32"), (32, "float32")):
        args = random_inputs(rng, 300, d, 37, getattr(torch, dt_name), dev)
        name = f"wide-random-{dt_name}-d{d}-300x37"
        compare_kernel(name, args, KERNEL_TOL[dt_name])
        g = torch.randn((300, 37), dtype=args[0].dtype, device=dev,
                        generator=gen)
        compare_backward(name, args, g, KERNEL_BWD_TOL[dt_name])
    X_, psi_, P_, Sigma_, lds_ = random_inputs(rng, 23, 12, 6, f64, dev)
    Sigma_[[1, 4]] = -5.0 * torch.eye(12, dtype=f64, device=dev)
    lds_[[1, 4]] = 0.0
    non_pd = (X_, psi_, P_, Sigma_, lds_)
    compare_kernel("wide-non-pd-float64-d12-23x6", non_pd,
                   KERNEL_TOL["float64"])
    nan = torch.isnan(vc_phi.vc_lnphi_complete(*non_pd))
    check(bool(nan[:, [1, 4]].all()) and not bool(nan[:, [0, 2, 3, 5]].any()),
          "wide non-pd: NaN is not exactly in the columns of the indefinite "
          "bases")
    X_, psi_, P_, Sigma_, _ = random_inputs(rng, 2000, 9, 2 * TRAIN_M,
                                            f64, dev)
    g = torch.randn((2000, 2 * TRAIN_M), dtype=f64, device=dev, generator=gen)
    both = vc_phi.vc_lnphi_bwd(X_, psi_, P_, Sigma_, g, 2)
    for s_, cols in enumerate((slice(0, TRAIN_M), slice(TRAIN_M, None))):
        alone = vc_phi.vc_lnphi_bwd(X_, psi_, P_[cols].contiguous(),
                                    Sigma_[cols].contiguous(),
                                    g[:, cols].contiguous())
        check(all(torch.equal(a[cols], b) for a, b in zip(both, alone)),
              f"wide sets: set {s_} of a two-set backward differs from the "
              "set alone")
    print(f"bands-wide: the wide pair vs plain in "
          f"{time.perf_counter() - t0:.1f} s; a two-set backward at "
          f"(2000 x {2 * TRAIN_M}) d=9 bit-equal to each set alone")
    for d, (rf, rb) in wide.items():
        print(f"times wide d={d} ({rf['shape'][0]} x {TRAIN_M}) f64: fwd "
              f"kernel {rf['ms']:.4f} ms, {rf['ms'] / rf['bound_ms']:.2f}x "
              f"its bound {rf['bound_ms']:.4f} ms, plain {rf['plain_ms']:.1f}"
              f" ms; bwd kernel {rb['ms']:.4f} ms, "
              f"{rb['ms'] / rb['bound_ms']:.2f}x its bound "
              f"{rb['bound_ms']:.4f} ms, plain {rb['plain_ms']:.1f} ms")
    return wide


def phase_bands(topl_batch, device=None) -> tuple:
    """21. Wide-band surveys. (a) the wide kernel pair (d > 8) against plain
    on the card: forward and backward at WIDE_SHAPES (70,000 x 100 for d =
    9, 12, 16; 4,000 x 100 for d = 32) on random well-conditioned float64
    inputs within KERNEL_TOL / KERNEL_BWD_TOL, two backward launches
    bit-identical, times against the bound; 300 x 37 at d = 9, 12, 16, 32,
    48 in float64 (also against autograd through plain) and at d = 9, 16,
    32 in float32 (d = 48 forward and d = 32 backward in float64 work in
    the global scratch, the others in shared memory); NaN exactly at a
    non-PD A; a backward of two sets of bases bit-equal to each set alone.
    (b) the nine-band configuration (make_torch_port_golden.bands_problem:
    VC m=100, d=9, psi (n, 9, 9), float64) through the entry points: its
    1,000-row sub-problem against tests/data/torch_port_golden_bands.npz
    within BANDS_TOL (init, nlog_ml and its gradient, 16 complete rows, 4
    rows with NaNs with the coverage guard's readings and escalations, the
    first iterations); init on the 70,000 training rows, BANDS_ITERS
    iterations with the 10,000 validation rows, save_model / load_model,
    then the loaded model serves the 12,000 complete rows and the 3,000
    rows with NaNs; every launch's shape and count held to what the path
    implies (expected_sites for predict), and the kernel pair against plain
    at every shape launched (rows sampled above SAMPLE_ABOVE pairs). (c)
    phase 20's m=1000 model serves TOPL_ROWS rows without band 0, one
    batch, once with the default top-64 sum (guarded; it escalates to the
    exact sum) and once under GPZ_MIX_TOPL=1000 (the predict module
    reloaded): bit-equal, with the seconds and launches of each. Returns
    ((fwd, bwd) launches of (b), (fwd, bwd) launches of (c), wide forward
    and backward records at 70,000 x 100, d = 9, forward sites, backward
    sites)."""
    import torch
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.model import _make_dataset
    from gpz_tpu_torch.optim import lbfgs
    from make_torch_port_golden import (
        BANDS, BANDS_COMPLETE_ROWS, BANDS_SUB, BANDS_TOL, BANDS_TRACE_ITERS,
        M, OUTPUTS, bands_nan_picks, bands_problem, load_golden_bands,
    )

    predict_mod = importlib.import_module("gpz_tpu_torch.predict")
    model_mod = importlib.import_module("gpz_tpu_torch.model")
    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    f64 = torch.float64

    wide = phase_wide(dev)

    # (b) the nine-band configuration through the entry points
    t_b = time.perf_counter()
    gold = load_golden_bands()
    X, Y, psi, tr, va, served, (m_idx, Xm) = bands_problem(synthetic_sdss)
    psi_m = psi[m_idx]
    n_tr, n_va = int(tr.sum()), int(va.sum())
    fwd_sites, bwd_sites, pred_sites = {}, {}, {}
    pred_calls = []

    def serve(X_, model_, psi__):
        (pred, sec), calls = moments_calls(
            lambda: timed_predict(X_, model_, psi__))
        pred_calls.extend(calls)
        return pred, sec, calls

    torch.cuda.synchronize()
    reset_launches()
    with pair_recorded(fwd_sites, bwd_sites, host_above=10**8), recording(
            "gpz_tpu_torch.predict", "vc_lnphi_complete", pred_sites):
        sub = slice(0, BANDS_SUB)
        sub_model = gpz_tpu_torch.init(X[sub], Y[sub], "VC", M,
                                       heteroscedastic=True, psi=psi[sub],
                                       seed=1, dtype="float64", device=device)
        flat_s, unravel_s = sub_model.last.params.flatten()
        err0 = float(np.max(np.abs(flat_s.cpu().numpy()
                                   - gold["sub.init.flat"])))
        print(f"bands-sub: init on {BANDS_SUB} rows of {BANDS} bands, flat "
              f"parameters vs JAX's max_abs {err0:.3e}")
        check(err0 <= BANDS_TOL["sub.init.flat"], "bands-sub: init differs "
              f"from the JAX package's beyond {BANDS_TOL['sub.init.flat']}")
        Xn = (X[sub] - sub_model.muX[None, :]) / sub_model.sdX[None, :]
        Yc = Y[sub, None] - sub_model.muY[None, :]
        psi_c = datautils.fix_psi(psi[sub], BANDS_SUB, sub_model.sdX, True)
        data_o = _make_dataset(Xn, Yc, psi_c, np.ones(BANDS_SUB),
                               np.ones(BANDS_SUB, bool), f64, dev)
        nlml, grad = objective_at(flat_s, unravel_s, data_o, sub_model.cfg)
        del data_o
        within(f"bands-sub: nlml {nlml:.12f} (JAX "
               f"{float(gold['init.nlml']):.12f})", nlml, gold["init.nlml"],
               BANDS_TOL["init.nlml"])
        within("bands-sub: gradient", grad, gold["init.grad"],
               BANDS_TOL["init.grad"])
        c_rows = served[:BANDS_COMPLETE_ROWS]
        pc, _, _ = serve(X[c_rows], sub_model, psi[c_rows])
        for k_ in OUTPUTS:
            within(f"bands-sub: {len(c_rows)} complete rows {k_}",
                   getattr(pc, k_), gold[f"complete.{k_}"],
                   BANDS_TOL["complete"][k_])
        picks = bands_nan_picks(Xm)
        check(np.array_equal(picks, gold["missing.picks"]),
              "bands-sub: golden rows with NaNs differ from this draw")
        pm, _, calls = serve(Xm[picks], sub_model, psi_m[picks])
        for k_ in OUTPUTS:
            within(f"bands-sub: {len(picks)} rows with NaNs {k_}",
                   getattr(pm, k_), gold[f"missing.{k_}"],
                   BANDS_TOL["missing"][k_])
        _, group = np.unique(~np.isnan(Xm[picks]), axis=0,
                             return_inverse=True)
        first = [int(np.where(group.ravel() == g_)[0][0])
                 for g_ in range(group.max() + 1)]
        cov_jax = gold["missing.coverage"][first]
        esc_jax = gold["missing.escalated"][first]
        cov_got = np.array([c[3] for c in calls if c[3] is not None])
        esc_got = np.array([c[2] == M for c in calls if c[3] is None])
        print(f"bands-sub: coverage of the top {predict_mod.MIX_TOPL} per "
              f"group {np.round(cov_got, 9).tolist()} (JAX "
              f"{np.round(cov_jax, 9).tolist()}), escalated "
              f"{int(esc_got.sum())} of {len(cov_got)} (JAX "
              f"{int(esc_jax.sum())})")
        check(cov_got.shape == cov_jax.shape
              and float(np.max(np.abs(cov_got - cov_jax))) <= 1e-9
              and int(esc_got.sum()) == int(esc_jax.sum()),
              "bands-sub: the coverage guard's readings or escalations "
              "differ from JAX's")
        sub_fit = gpz_tpu_torch.train(
            sub_model, X[sub], Y[sub], psi=psi[sub],
            max_iter=BANDS_TRACE_ITERS, max_attempts=MAX_ATTEMPTS,
            verbose=False).fit_info
        k = len(gold["trace.f"])
        check(sub_fit["iterations"] + 1 == k, "bands-sub: "
              f"{sub_fit['iterations']} iterations, JAX {k - 1}")
        within(f"bands-sub: f at iterations 0..{k - 1} "
               f"{np.round(sub_fit['trace']['f'][:k], 10).tolist()}",
               sub_fit["trace"]["f"][:k], gold["trace.f"],
               BANDS_TOL["trace.f"])
        check(np.array_equal(sub_fit["trace"]["fevals"][:k],
                             gold["trace.fevals"]),
              "bands-sub: evaluation counts differ from JAX's")
        sub_evals = sub_fit["fun_evals"]
        del sub_model
        print(f"bands-sub: held to the golden file in "
              f"{time.perf_counter() - t_b:.1f} s")

        # init and training at full size, every evaluation timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = gpz_tpu_torch.init(X, Y, "VC", M, heteroscedastic=True,
                                   training=tr, psi=psi, seed=1,
                                   dtype="float64", device=device)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        check(model.last.params.P.device == dev,
              "bands: init did not build the model on the card")
        eval_s = []
        real_objective = model_mod._objective

        def timed_objective(*a):
            fun = real_objective(*a)

            def timed(flat):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fun(flat)
                torch.cuda.synchronize()
                eval_s.append(time.perf_counter() - t1)
                return out
            return timed

        model_mod._objective = timed_objective
        try:
            t0 = time.perf_counter()
            fitted = gpz_tpu_torch.train(
                model, X, Y, training=tr, validation=va, psi=psi,
                max_iter=BANDS_ITERS, max_attempts=MAX_ATTEMPTS,
                verbose=False)
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t0
        finally:
            model_mod._objective = real_objective
        fit = fitted.fit_info
        trace = fit["trace"]
        n_it, evals = fit["iterations"], fit["fun_evals"]
        check(all(np.isfinite(a).all() for a in (
            trace["f"], trace["opt_cond"], trace["step"], trace["score"],
            *trace["extras"].values())), "bands-train: non-finite trace")
        check(bool(np.all(np.diff(trace["f"]) <= 0)),
              "bands-train: f increased over an accepted iteration")
        check(n_it == BANDS_ITERS or fit["status"] in (
            lbfgs.STATUS_OPTIMAL, lbfgs.STATUS_STEP_TOO_SMALL,
            lbfgs.STATUS_EARLY_STOP),
              f"bands-train: {n_it} iterations, status {fit['status']}")
        check(len(eval_s) == evals, "bands-train: timed evaluations differ "
              "from the run's")
        med = float(np.median(eval_s[1:] if len(eval_s) > 1 else eval_s))
        print(f"bands-train: f at iterations 0..{n_it} "
              f"{np.round(trace['f'], 8).tolist()}; valid RMSE "
              f"{trace['extras']['valid_rmse'][-1]:.6f}")
        print(f"bands-train: VC m={M}, d={BANDS}, init on {n_tr} rows in "
              f"{init_s:.3f} s; {n_it} iterations, {evals} evaluations, "
              f"status {fit['status']} in {train_s:.3f} s "
              f"({train_s / evals:.4f} s per evaluation with scoring and "
              f"resolving; evaluations alone median {med:.4f} s, first "
              f"{eval_s[0]:.4f} s); final nlml {fit['final_nlml']:.10f}")

        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "bands.npz")
            gpz_tpu_torch.save_model(fitted, path)
            loaded = gpz_tpu_torch.load_model(path, device=device)
        check(torch.equal(loaded.best.params.flatten()[0],
                          fitted.best.params.flatten()[0])
              and torch.equal(loaded.best.post.iSigma_w,
                              fitted.best.post.iSigma_w),
              "bands-checkpoint: the loaded model differs from the saved")
        del model, fitted
        pc, sec_c, calls_c = serve(X[served], loaded, psi[served])
        pm, sec_m, calls_m = serve(Xm, loaded, psi_m)
        for label, pred, n_ in (("complete", pc, len(served)),
                                ("with NaNs", pm, len(Xm))):
            check(all(np.isfinite(getattr(pred, k_)).all()
                      for k_ in OUTPUTS + ("phi",))
                  and pred.mu.shape == (n_, 1) and pred.sigma.min() > 0
                  and pred.nu.min() >= 0 and pred.gamma.min() >= 0,
                  f"bands-serve: rows {label}: non-finite or negative")
        cov = [c[3] for c in calls_m if c[3] is not None]
        n_esc = sum(1 for c in calls_m if c[2] == M)
        check(n_esc == sum(1 for c_ in cov
                           if c_ < predict_mod.MIX_COVERAGE_MIN),
              "bands-serve: escalations differ from the guarded batches "
              "below MIX_COVERAGE_MIN")
        n_nan = int(np.isnan(Xm).any(axis=1).sum())
        print(f"bands-serve: {len(served)} complete rows in {sec_c:.3f} s "
              f"({len(served) / sec_c:.1f} rows/s, {len(calls_c)} batches); "
              f"{len(Xm)} rows ({n_nan} with NaNs) in {sec_m:.3f} s "
              f"({len(Xm) / sec_m:.1f} rows/s, {len(calls_m)} moment calls);"
              f" top-{predict_mod.MIX_TOPL} coverage over {len(cov)} guarded "
              f"batches: least {min(cov):.9f}; {n_esc} escalated to the "
              f"exact {M}-component sum")
        want_pred = expected_sites(loaded.cfg, pred_calls)
        check(site_counts(pred_sites) == want_pred, "bands-serve: predict "
              f"launched {site_counts(pred_sites)}, the budgets imply "
              f"{want_pred}")
        big, val, sub_shape = (n_tr, M), (n_va, M), (BANDS_SUB, M)
        want_f = {big: 1 + evals + 4, val: n_it + 1,
                  sub_shape: 1 + 1 + sub_evals + 4}
        want_b = {big: evals, sub_shape: 1 + sub_evals}
        check(site_counts(fwd_sites) == want_f
              and site_counts(bwd_sites) == want_b,
              f"bands: objective sites {site_counts(fwd_sites)}, "
              f"{site_counts(bwd_sites)}; the path implies {want_f}, "
              f"{want_b}")
    torch.cuda.synchronize()
    got = launches()
    want = (sum(want_f.values()) + sum(want_pred.values()),
            sum(want_b.values()))
    check(got == want and all(c > 0 for c in got),
          f"bands: launches {got}, the path implies {want}")
    print(f"bands: main path in {time.perf_counter() - t_b:.1f} s; "
          f"LAUNCHES_FWD / LAUNCHES_BWD {got} (the wide variant at d="
          f"{BANDS}) as the path implies: objective {want_f}, {want_b}; "
          f"predict {want_pred}")
    del pc, pm, loaded
    reset_launches()

    # the kernel pair against plain at every shape (b) launched
    t0 = time.perf_counter()
    fwd, bwd = {}, {}
    big_f, big_b = fwd_sites.pop(big), bwd_sites.pop(big)
    args_b = moved(big_b[1], dev)
    rec_f, rec_b = compare_big(f"bands-{n_tr}x{M}", moved(big_f[1], dev),
                               args_b[4], *args_b[5:])
    del args_b
    for rec, kind, count in ((rec_f, "fwd", big_f[0]),
                             (rec_b, "bwd", big_b[0])):
        rec.update(shape=list(big), launches=count,
                   bound_ms=bound(kind, n_tr, M, BANDS, "float64")["bound_ms"])
    fwd[f"bands-{n_tr}x{M}"] = rec_f
    bwd[f"bands-bwd-{n_tr}x{M}"] = rec_b
    fwd.update(compare_sites("bands", fwd_sites, "phase-21 run",
                             key="launches"))
    fwd.update(compare_sites("bands-predict", pred_sites, "phase-21 run",
                             key="launches", sample_above=SAMPLE_ABOVE))
    bwd.update(compare_bwd_sites("bands", bwd_sites, "phase-21 run"))
    print(f"bands: kernel pair vs plain at {len(fwd)} forward and {len(bwd)} "
          f"backward shapes in {time.perf_counter() - t0:.1f} s")

    # (c) phase 20's m=1000 model, one batch with NaNs, MIX_TOPL >= m
    model_k, X_k, psi_k = topl_batch
    m_k = model_k.cfg.m
    reset_launches()
    (esc, esc_s), esc_calls = moments_calls(
        lambda: timed_predict(X_k, model_k, psi_k))
    esc_launches = launches()
    check(len(esc_calls) == 2 and esc_calls[1][2] == m_k,
          f"topl: the batch did not escalate ({esc_calls})")
    try:
        with env_set("GPZ_MIX_TOPL", str(m_k)):
            importlib.reload(predict_mod)
            reset_launches()
            (exact, exact_s), exact_calls = moments_calls(
                lambda: timed_predict(X_k, model_k, psi_k))
            exact_launches = launches()
    finally:
        importlib.reload(predict_mod)
    check(len(exact_calls) == 1 and exact_calls[0][3] is None
          and exact_calls[0][2] == m_k,
          f"topl: MIX_TOPL={m_k} did not serve the exact sum unguarded "
          f"({exact_calls})")
    check(all(np.array_equal(getattr(exact, k_), getattr(esc, k_))
              for k_ in OUTPUTS + ("phi",)),
          f"topl: MIX_TOPL={m_k} differs from the escalated result")
    print(f"topl: {len(X_k)} rows without band 0 at m={m_k}: default top-"
          f"{predict_mod.MIX_TOPL} (coverage {esc_calls[0][3]:.9f}, "
          f"escalated) {esc_s:.3f} s, launches fwd/bwd {esc_launches}; "
          f"GPZ_MIX_TOPL={m_k} {exact_s:.3f} s, launches {exact_launches}; "
          "outputs bit-equal")
    print(f"bands: phase 21 in {time.perf_counter() - t_phase:.1f} s")
    return got, exact_launches, wide[BANDS], fwd, bwd


def host_ms(fn) -> float:
    """Host-clock milliseconds of one fn(), synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def count_syncs(fn) -> int:
    """cudaStreamSynchronize calls of one fn() under torch.profiler: the
    host waiting on the card (a read of a device value, a copy from the
    host's pageable memory)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return sum(e.count for e in prof.key_averages()
               if e.key == "cudaStreamSynchronize")


def effective_sizes(samples: np.ndarray) -> np.ndarray:
    """Effective sample size per dimension of draws (chains, draws, p):
    Stan's multi-chain estimator, autocorrelations by FFT and Geyer's
    initial monotone sequence of pair sums."""
    C, S, _ = samples.shape
    x = samples - samples.mean(axis=1, keepdims=True)
    f = np.fft.rfft(x, n=2 * S, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=2 * S, axis=1)[:, :S] / S
    W = (acov[:, 0] * S / (S - 1)).mean(0)
    var_plus = W * (S - 1) / S + samples.mean(axis=1).var(axis=0, ddof=1)
    rho = 1.0 - (W - acov.mean(0)) / var_plus             # (S, p)
    K = S // 2
    pairs = rho[0:2 * K:2] + rho[1:2 * K:2]
    pairs = np.where(np.cumprod(pairs > 0, axis=0).astype(bool), pairs, 0.0)
    tau = -1.0 + 2.0 * np.minimum.accumulate(pairs, axis=0).sum(0)
    return C * S / np.maximum(tau, 1e-3)


def within(name, got, want, tol) -> float:
    """Largest err / (atol + rtol |want|) of got against want (host arrays);
    fails beyond 1."""
    rtol, atol = tol
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want,
                                                              dtype=np.float64)
    check(got.shape == want.shape and np.isfinite(got).all(),
          f"{name}: shape {got.shape} or non-finite values")
    err = np.abs(got - want)
    ratio = float(np.max(err / (atol + rtol * np.abs(want)))) if err.max() \
        else 0.0
    print(f"{name}: max_abs_err {err.max():.3e} of max "
          f"{np.abs(want).max():.3e} (err/bound {ratio:.3f})")
    check(ratio <= 1.0, f"{name}: beyond rtol={rtol}, atol={atol}")
    return ratio


def single_and_batched(unravel, data, cfg, complete=True):
    """(nlml of a batch (C, p) in one nlog_ml_batched call, the same by C
    nlog_ml calls one after another)."""
    import torch
    from gpz_tpu_torch.objective import nlog_ml, nlog_ml_batched

    def batched(x):
        return nlog_ml_batched(x, unravel, data, cfg, complete)

    def single(x):
        return torch.stack([nlog_ml(unravel(r), data, cfg,
                                    complete=complete)[0] for r in x])

    return batched, single


def compare_batched(label, batched, single, X) -> dict:
    """(a) one batched evaluation of the C rows of X against C single ones:
    values and gradients within BATCH_TOL, launches (1, 1) against (C, C),
    median host times of the two in turn and their host syncs."""
    from gpz_tpu_torch.inference.mcmc import _value_and_grad

    C = X.shape[0]
    reset_launches()
    fb, gb = _value_and_grad(batched, X)
    lb = launches()
    reset_launches()
    fs, gs = _value_and_grad(single, X)
    ls = launches()
    check(lb == (1, 1) and ls == (C, C), f"batched {label}: launches "
          f"{lb} batched, {ls} single, expected (1, 1) and ({C}, {C})")
    within(f"inference batched-{label} nlml", fb.cpu().numpy(),
           fs.cpu().numpy(), BATCH_TOL["nlml"])
    within(f"inference batched-{label} grad", gb.cpu().numpy(),
           gs.cpu().numpy(), BATCH_TOL["grad"])
    tb, ts = [], []
    for _ in range(7):
        tb.append(host_ms(lambda: _value_and_grad(batched, X)))
        ts.append(host_ms(lambda: _value_and_grad(single, X)))
    rec = {"batched_ms": float(np.median(tb)),
           "single_ms": float(np.median(ts)),
           "syncs_batched": count_syncs(lambda: _value_and_grad(batched, X)),
           "syncs_single": count_syncs(lambda: _value_and_grad(single, X))}
    print(f"inference batched-{label}: {C} points, one batched evaluation "
          f"(value and gradient, host clock with sync, median of 7) "
          f"{rec['batched_ms']:.3f} ms in 1 + 1 launches, {C} single ones "
          f"in turn {rec['single_ms']:.3f} ms in {C} + {C} "
          f"({rec['single_ms'] / rec['batched_ms']:.2f}x); host syncs "
          f"{rec['syncs_batched']} against {rec['syncs_single']}")
    return rec


def counted_evaluations(fn):
    """(fn's result, batched evaluations): calls of nlog_ml_batched made
    through gpz_tpu_torch.inference.api while fn runs."""
    api = importlib.import_module("gpz_tpu_torch.inference.api")
    real = api.nlog_ml_batched
    calls = [0]

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)

    api.nlog_ml_batched = counted
    try:
        return fn(), calls[0]
    finally:
        api.nlog_ml_batched = real


def run_sampler(label, model, X, Y, psi, omega, tr, **kw) -> tuple:
    """(c), (d): sample_posterior on the card; (samples, info, evaluations,
    seconds, launches), the launches checked against the evaluations."""
    import torch
    from gpz_tpu_torch.inference import sample_posterior

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (samples, info), evals = counted_evaluations(lambda: sample_posterior(
        model, X, Y, omega=omega, training=tr, psi=psi,
        num_chains=INF_CHAINS, seed=17, **kw))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = launches()
    S = samples.shape[1]
    draws = samples.cpu().numpy()
    check(samples.shape == (INF_CHAINS, S, samples.shape[2])
          and np.isfinite(draws).all(), f"{label}: draws not finite of "
          "the expected shape")
    accept = info["accept_rate"].cpu().numpy()
    check(bool((accept > 0).all()), f"{label}: acceptance {accept}")
    check(got == (evals, evals), f"{label}: launches {got}, the target was "
          f"evaluated {evals} times")
    ess = effective_sizes(draws)
    rhat = info["rhat"].cpu().numpy()
    print(f"inference {label}: {INF_CHAINS} chains x {S} draws of p = "
          f"{samples.shape[2]} in {secs:.3f} s, {evals} batched evaluations "
          f"({secs / evals * 1e3:.3f} ms each; launches fwd/bwd {got}); "
          f"acceptance {np.round(accept, 3).tolist()}, step size "
          f"{np.asarray(info['step_size'].cpu()).round(6).tolist()}, "
          f"split-Rhat max {rhat.max():.3f} median {np.median(rhat):.3f}; "
          f"effective draws min {ess.min():.1f} median {np.median(ess):.1f} "
          f"of {INF_CHAINS * S}: {secs / ess.min():.3f} s per effective "
          f"draw at the minimum, {secs / np.median(ess):.3f} at the median")
    return samples, info, evals, secs, got


def phase_inference(model64, mags, errs, z, test_rows, data70, flat70,
                    unravel70, cfg70) -> tuple:
    """17. Posterior inference at the trained photo-z point; ((fwd, bwd)
    launches of its main path, (c) to (f), and the kernel pair's records at
    every shape that path launched, forward and backward)."""
    import dataclasses
    import torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.inference import advi_fit, predictive_draws
    from gpz_tpu_torch.inference.mcmc import _hmc_step, _value_and_grad
    from gpz_tpu_torch.inference.nuts import _nuts_step
    from gpz_tpu_torch.inference.api import posterior_target
    import gpz_tpu_torch
    from make_torch_port_golden import (
        HMC_LEAPFROG, INFERENCE_TOL, JITTER, NUTS_DEPTH, PRIOR_SCALE,
        STEP_EPS, inference_problem, jittered_points, load_golden_inference,
    )

    t_phase = time.perf_counter()
    f64 = torch.float64
    dev = model64.best.params.P.device
    X, Y, psi, omega, tr = inference_problem(
        synthetic_sdss, datautils.split, datautils.get_omega)
    check(int(tr.sum()) == 4000, f"inference: {int(tr.sum())} training rows")
    # sample_posterior's own target, which (b) holds against JAX
    logp, flat, unravel, data, complete = posterior_target(
        model64, X, Y, omega=omega, training=tr, psi=psi,
        prior_scale=PRIOR_SCALE)
    check(complete, "inference: the training rows are not taken as complete")
    nlml_b, nlml_s = single_and_batched(
        unravel, data, dataclasses.replace(model64.cfg, dtype="float64"))
    p = flat.numel()
    rng = np.random.default_rng(17)

    def jitter(center):
        return center[None] + JITTER * torch.as_tensor(
            rng.standard_normal((INF_CHAINS, center.numel())), device=dev)

    # (a) batched against single, here and at 70,000 rows
    rec_a = compare_batched(f"{tr.sum()}x{model64.cfg.m}", nlml_b, nlml_s,
                            jitter(flat))
    b70, s70 = single_and_batched(unravel70, data70, cfg70)
    rec_70 = compare_batched(f"{data70.n}x{cfg70.m}", b70, s70,
                             jitter(flat70))

    # (b) against JAX: log posterior, one HMC and one NUTS transition, ADVI
    gold = load_golden_inference()
    within("inference golden flat", flat.cpu().numpy(), gold["flat"],
           INFERENCE_TOL["flat"])
    pts = np.concatenate([gold["flat"][None], jittered_points(gold["flat"])])
    lp, g = _value_and_grad(logp, torch.as_tensor(pts, device=dev))
    within("inference golden logp", lp.cpu().numpy(), gold["logp"],
           INFERENCE_TOL["logp"])
    within("inference golden grad", g.cpu().numpy(), gold["grad"],
           INFERENCE_TOL["grad"])
    def dv(name):
        return torch.as_tensor(gold[name], device=dev)

    x0 = flat[None].expand(2, p).clone()
    l0, g0 = _value_and_grad(logp, x0)
    eps = torch.full((2,), STEP_EPS, dtype=f64, device=dev)
    ones = torch.ones((2, p), dtype=f64, device=dev)
    hmc_draws = [dv(f"hmc.{k}") for k in ("z", "steps", "u")]
    nuts_draws = [dv(f"nuts.{k}") for k in ("z", "go_right", "leaf_u",
                                            "merge_u")]
    reset_launches()
    hmc = _hmc_step(logp, x0, l0, g0, eps, ones, *hmc_draws)
    check(launches() == (int(gold["hmc.steps"].max()),) * 2,
          f"golden hmc: launches {launches()}")
    for name, got in zip(("x", "logp", "accept_prob"), (hmc[0], hmc[1],
                                                        hmc[3])):
        within(f"inference golden hmc.{name}", got.cpu().numpy(),
               gold[f"hmc.{name}"], INFERENCE_TOL[f"hmc.{name}"])
    reset_launches()
    nuts = _nuts_step(logp, x0, l0, g0, eps, ones, *nuts_draws, NUTS_DEPTH)
    nuts_l = launches()
    for name, got in zip(("x", "logp", "accept_stat"), (nuts[0], nuts[1],
                                                        nuts[3])):
        within(f"inference golden nuts.{name}", got.cpu().numpy(),
               gold[f"nuts.{name}"], INFERENCE_TOL[f"nuts.{name}"])
    check(np.array_equal(nuts[4].cpu().numpy(), gold["nuts.depth"])
          and np.array_equal(nuts[5].cpu().numpy(), gold["nuts.diverged"]),
          f"golden nuts: depth {nuts[4].tolist()} diverged "
          f"{nuts[5].tolist()}, JAX {gold['nuts.depth'].tolist()} "
          f"{gold['nuts.diverged'].tolist()}")
    check(nuts_l[0] == nuts_l[1] <= 2**NUTS_DEPTH - 1,
          f"golden nuts: launches {nuts_l}")
    mu, rho, elbos = advi_fit(logp, flat, num_steps=len(gold["advi.elbos"]),
                              num_mc=gold["advi.eps"].shape[1],
                              eps=dv("advi.eps"))
    for name, got in (("mu", mu), ("rho", rho), ("elbos", elbos)):
        within(f"inference golden advi.{name}", got.cpu().numpy(),
               gold[f"advi.{name}"], INFERENCE_TOL[f"advi.{name}"])
    # host syncs of the two transitions: two per evaluation (the jitter
    # ladders' reads), plus at most one per HMC transition and one per leaf
    per_eval = rec_a["syncs_batched"]
    hmc_syncs = count_syncs(lambda: _hmc_step(
        logp, x0, l0, g0, eps, ones, *hmc_draws))
    nuts_syncs = count_syncs(lambda: _nuts_step(
        logp, x0, l0, g0, eps, ones, *nuts_draws, NUTS_DEPTH))
    n_hmc = int(gold["hmc.steps"].max())
    print(f"inference golden: HMC transition of {HMC_LEAPFROG} steps at "
          f"most, accept_prob {hmc[3].tolist()} (JAX "
          f"{gold['hmc.accept_prob'].tolist()}); NUTS depth "
          f"{nuts[4].tolist()}, {nuts_l[0]} leaves in lockstep, "
          f"accept_stat {nuts[3].tolist()}; host syncs: HMC {hmc_syncs} for "
          f"{n_hmc} evaluations, NUTS {nuts_syncs} for {nuts_l[0]} leaves "
          f"({per_eval} per evaluation)")
    check(hmc_syncs <= n_hmc * per_eval + 1
          and nuts_syncs <= nuts_l[0] * (per_eval + 1),
          "inference: the samplers read the host more than once per HMC "
          "transition or NUTS leaf beyond the evaluations' own reads")

    # (c) to (f), the main path, each part counted from 0, with the kernel
    # pair's calls recorded for (g)
    map_mu = gpz_tpu_torch.predict(mags[test_rows], model64,
                                   psi=errs[test_rows] ** 2).mu
    fwd_sites, bwd_sites = {}, {}
    with pair_recorded(fwd_sites, bwd_sites):
        hmc_s, hmc_info, hmc_evals, hmc_secs, hmc_l = run_sampler(
            "hmc", model64, X, Y, psi, omega, tr, sampler="hmc",
            num_warmup=HMC_WARMUP, num_samples=HMC_DRAWS)
        _, nuts_info, nuts_evals, nuts_secs, nuts_l = run_sampler(
            "nuts", model64, X, Y, psi, omega, tr, sampler="nuts",
            num_warmup=NUTS_WARMUP, num_samples=NUTS_DRAWS,
            max_depth=NUTS_MAX_DEPTH)
    transitions = NUTS_WARMUP + NUTS_DRAWS
    print(f"inference nuts: mean tree depth "
          f"{np.round(nuts_info['mean_tree_depth'].cpu().numpy(), 3).tolist()}"
          f" (max {NUTS_MAX_DEPTH}), divergences "
          f"{nuts_info['divergences'].cpu().numpy().tolist()}, "
          f"{(nuts_evals - 1) / transitions:.2f} leaves per transition "
          f"(lockstep batch), {nuts_secs / transitions:.3f} s per transition")

    # (e) predictive draws on the test rows
    thin = max(1, INF_CHAINS * HMC_DRAWS // PREDICTIVE_DRAWS)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pair_recorded(fwd_sites, bwd_sites):
        mus, mean_mu, std_mu = predictive_draws(
            model64, hmc_s, hmc_info, mags[test_rows],
            psi_new=errs[test_rows] ** 2, thin=thin)
    pred_secs = time.perf_counter() - t0
    pred_l = launches()
    n_draws = mus.shape[0]
    check(mus.shape == (n_draws, len(test_rows), 1) and np.isfinite(mus).all()
          and (std_mu >= 0).all(), "predictive: draws not finite of the "
          "expected shape, or a negative spread")
    check(pred_l == (2 * n_draws, 0), f"predictive: launches {pred_l}, "
          f"expected (2 x {n_draws}, 0)")
    gap = float(np.max(np.abs(mean_mu - map_mu)))
    rmse = float(np.sqrt(np.mean((mean_mu[:, 0] - z[test_rows]) ** 2)))
    print(f"inference predictive: {n_draws} draws (thin {thin}) on "
          f"{len(test_rows)} test rows in {pred_secs:.3f} s, launches "
          f"fwd/bwd {pred_l}; spread of the mean median "
          f"{np.median(std_mu):.3e} max {std_mu.max():.3e}; largest |mean - "
          f"MAP predict mu| {gap:.3e} (gpz_tpu's test bound 1.0); test RMSE "
          f"of the mean {rmse:.6f}")
    check(gap < 1.0, "predictive: the posterior-predictive mean is 1.0 or "
          "more from the MAP prediction")

    # (f) ADVI
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with pair_recorded(fwd_sites, bwd_sites):
        mu, rho, elbos = advi_fit(logp, flat, gen, num_steps=ADVI_FIT_STEPS,
                                  num_mc=ADVI_FIT_MC)
    torch.cuda.synchronize()
    advi_secs = time.perf_counter() - t0
    advi_l = launches()
    el = elbos.cpu().numpy()
    print(f"inference advi: {ADVI_FIT_STEPS} steps of {ADVI_FIT_MC} draws "
          f"({ADVI_FIT_MC} x {model64.cfg.m} bases per launch) in "
          f"{advi_secs:.3f} s, launches fwd/bwd {advi_l}; ELBO mean of the "
          f"first 50 {el[:50].mean():.3f}, of the last 50 "
          f"{el[-50:].mean():.3f}, scale median "
          f"{float(rho.exp().median()):.3e}")
    check(np.isfinite(el).all() and el[-50:].mean() > el[:50].mean(),
          "advi: ELBO not finite or not higher over the last 50 steps")
    check(advi_l == (ADVI_FIT_STEPS, ADVI_FIT_STEPS), "advi: launches differ "
          "from one pair per step")
    got = tuple(sum(c) for c in zip(hmc_l, nuts_l, pred_l, advi_l))

    # (g) the kernel pair against its plain versions at every shape the main
    # path launched, on the arguments of its first launch there (the
    # backward on the cotangent the path gave it)
    m, n_tr = model64.cfg.m, int(tr.sum())
    chains = hmc_evals + nuts_evals
    want_f = {(n_tr, INF_CHAINS * m): chains, (n_tr, m): n_draws,
              (len(test_rows), m): n_draws,
              (n_tr, ADVI_FIT_MC * m): ADVI_FIT_STEPS}
    want_b = {(n_tr, INF_CHAINS * m): chains,
              (n_tr, ADVI_FIT_MC * m): ADVI_FIT_STEPS}
    check(site_counts(fwd_sites) == want_f
          and site_counts(bwd_sites) == want_b,
          f"inference: the main path launched {site_counts(fwd_sites)} "
          f"forward and {site_counts(bwd_sites)} backward, expected {want_f} "
          f"and {want_b}")
    fwd_recs = compare_sites("inference", fwd_sites, "phase-17 main path",
                             key="launches")
    bwd_recs = compare_bwd_sites("inference", bwd_sites, "phase-17 main path")
    del fwd_sites, bwd_sites
    print(f"inference: phase in {time.perf_counter() - t_phase:.1f} s; main "
          f"path (c)-(f) launches fwd/bwd {got}; batched evaluation "
          f"{rec_a['batched_ms']:.3f} ms vs {rec_a['single_ms']:.3f} ms in "
          f"turn at 4,000 rows, {rec_70['batched_ms']:.3f} vs "
          f"{rec_70['single_ms']:.3f} ms at {data70.n}")
    return got, fwd_recs, bwd_recs


def timed_collectives(fn):
    """(fn's result, [seconds of each all-reduce of parallel.sharded]) with
    every all-reduce between two synchronizations: what the collectives
    cost, not the pipelined wall time."""
    import torch
    from gpz_tpu_torch.parallel import sharded

    real, spent = sharded.all_reduce, []

    def timed(t, group):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real(t, group)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    sharded.all_reduce = timed
    try:
        return fn(), spent
    finally:
        sharded.all_reduce = real


def rank_data(prob, X, Y, psi, rows, device):
    """The training problem's rows `rows` (a boolean mask over X's rows)
    under the normalization of phase 18's problem file, on `device`."""
    import torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.model import _make_dataset

    Xn = (X - prob["muX"][None, :]) / prob["sdX"][None, :]
    Yc = Y[:, None] - prob["muY"][None, :]
    psi_c = datautils.fix_psi(psi, len(Y), prob["sdX"], True)
    return _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), rows,
                         torch.float64, device)


def first_rows(mask, lo, hi):
    """The mask of the rows lo:hi of those that `mask` selects."""
    out = np.zeros(len(mask), bool)
    out[np.where(mask)[0][lo:hi]] = True
    return out


def parallel_rank(rank: int, workdir: str) -> int:
    """Phase 18 (b) and (c) as rank `rank` of two gloo ranks on the card,
    started by phase_parallel: the problem from workdir/problem.npz, the
    results to workdir/rank<rank>.npz and the kernel pair's recorded
    arguments to workdir/rank<rank>_sites.pt."""
    import torch
    import torch.distributed as dist
    import gpz_tpu_torch
    from gpz_tpu_torch.config import ModelConfig, TrainConfig
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.dataset import pad_dataset
    from gpz_tpu_torch.inference import hmc_sample, nuts_sample
    from gpz_tpu_torch.ops import vc_phi
    from gpz_tpu_torch.params import GPzParams
    from gpz_tpu_torch.parallel import (
        RESTART_AXIS, distributed, ensemble_grad_step, make_mesh,
        shard_dataset, sharded, sharded_value_and_grad, train_sharded,
    )
    from make_torch_port_golden import train_problem

    with np.load(os.path.join(workdir, "problem.npz")) as z:
        prob = {k: z[k] for k in z.files}
    dev = torch.device(str(prob["device"]))
    f64 = torch.float64
    fields = json.loads(str(prob["fields"]))
    cfg = ModelConfig(**json.loads(str(prob["cfg"])))
    params0 = GPzParams.from_numpy(
        {f: prob[f"param.{f}"] for f in fields}, dev, f64)
    flat0, unravel = params0.flatten()
    n_train, n_valid = int(prob["n_train"]), int(prob["n_valid"])
    X, Y, psi, tr_all, va_all = train_problem(synthetic_sdss)
    tr = first_rows(tr_all, 0, n_train)
    va = first_rows(va_all, 0, n_valid)
    out, launches = {}, {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def step(name, fn):
        """fn() with its seconds, all-reduces and launches of the pair."""
        vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
        before = sharded.COLLECTIVES
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        out[f"{name}.s"] = time.perf_counter() - t0
        out[f"{name}.collectives"] = sharded.COLLECTIVES - before
        launches[name] = (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD)
        return result

    distributed.initialize(f"file://{os.path.join(workdir, 'gloo')}", 2,
                           rank, backend="gloo")
    sites = {k: {} for k in ("fwd", "bwd", "fwd_uneven", "bwd_uneven")}
    try:
        mesh = make_mesh()
        with pair_recorded(sites["fwd"], sites["bwd"]):
            # rows over the data group: this rank loads its range only
            lo, hi = distributed.host_row_range(n_train)
            local = rank_data(prob, X, Y, psi, first_rows(tr, lo, hi), "cpu")
            gdata, n_eff = distributed.global_dataset(local, mesh, device=dev)
            out["value.n_eff"], out["value.rows"] = n_eff, gdata.n
            fun = sharded_value_and_grad(unravel, cfg, mesh, True)
            f, g, _ = step("value", lambda: fun(flat0, gdata, n_eff))
            out["value.f"], out["value.g"] = float(f), g.cpu().numpy()
            # the first evaluation of a process starts cuBLAS and loads the
            # kernels: time a second one
            step("warm", lambda: fun(flat0, gdata, n_eff))
            _, spent = timed_collectives(lambda: fun(flat0, gdata, n_eff))
            out["value.collective_s"] = np.asarray(spent)
            del gdata

            # train_sharded takes the whole dataset and keeps its share
            data_tr = rank_data(prob, X, Y, psi, tr, dev)
            data_va = rank_data(prob, X, Y, psi, va, dev)
            res, _ = step("train", lambda: train_sharded(
                params0, data_tr, cfg, mesh, valid_data=data_va,
                tc=TrainConfig(max_iter=int(prob["iters"]),
                               max_attempts=int(prob["max_attempts"])),
                complete=True))
            out["train.f"] = res.trace["f"]
            out["train.fevals"] = res.trace["fevals"]
            out["train.iterations"] = res.iterations
            out["train.x"] = res.x.cpu().numpy()

        # the uneven split: n_train - 1 rows, the short rank padded
        with pair_recorded(sites["fwd_uneven"], sites["bwd_uneven"]):
            n_odd = n_train - 1
            lo, hi = distributed.host_row_range(n_odd)
            local = pad_dataset(rank_data(prob, X, Y, psi,
                                          first_rows(tr, lo, hi), "cpu"),
                                -(-n_odd // 2))
            gdata, n_eff = distributed.global_dataset(local, mesh,
                                                      device=dev)
            f, g, _ = step("uneven", lambda: fun(flat0, gdata, n_eff))
            out.update({"uneven.n_eff": n_eff, "uneven.rows": hi - lo,
                        "uneven.f": float(f), "uneven.g": g.cpu().numpy()})
            del gdata

        with pair_recorded(sites["fwd"], sites["bwd"]):
            # restarts over the restart group, all rows on each rank
            grid = make_mesh(n_data=1, n_restart=2)
            stacked = torch.as_tensor(prob["stacked"], device=dev)
            sdata, n_eff = shard_dataset(data_tr, grid)
            stepped = step("ensemble_step", lambda: ensemble_grad_step(
                unravel(stacked), sdata, cfg, grid, n_eff,
                lr=float(prob["lr"]), complete=True))
            out["ensemble_step.x"] = torch.cat(
                [getattr(stepped, f).reshape(2, -1) for f in fields],
                dim=1).cpu().numpy()
            model, info = step("fit_ensemble", lambda: (
                gpz_tpu_torch.fit_ensemble(
                    X, Y, "VC", cfg.m, n_restarts=2, training=tr,
                    validation=va, psi=psi, max_iter=int(prob["iters"]),
                    seed=1, dtype="float64", mesh=grid, device=dev)))
            for k in ("restart_scores", "best_restart", "iterations",
                      "fun_evals"):
                out[f"fit.{k}"] = info[k]
            for which in ("best", "last"):
                out[f"fit.{which}"] = getattr(
                    model, which).params.flatten()[0].cpu().numpy()

        # (c) the samplers' warmup pooled over the restart group, on
        # tests/test_collective_adapt.py's correlated Gaussian
        A = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 0.5]])
        prec = torch.as_tensor(np.linalg.inv(A), device=dev)
        mu = torch.tensor([1.0, -2.0, 0.5], dtype=f64, device=dev)

        def logp(x):
            d = x - mu
            return -0.5 * torch.sum((d @ prec) * d, dim=-1)

        for name, sampler, kw in (("hmc", hmc_sample, dict(num_leapfrog=16)),
                                  ("nuts", nuts_sample, {})):
            gen = torch.Generator(device=dev).manual_seed(100 + rank)
            samples, sinfo = step(name, lambda: sampler(
                logp, torch.zeros(3, dtype=f64, device=dev), gen,
                num_warmup=PAR_WARMUP, num_samples=PAR_DRAWS,
                num_chains=PAR_CHAINS, collective_adapt=True,
                axis_name=grid.get_group(RESTART_AXIS), **kw))
            out[f"{name}.step_size"] = sinfo["step_size"].cpu().numpy()
            out[f"{name}.accept"] = sinfo["accept_rate"].cpu().numpy()
            out[f"{name}.mean"] = samples.reshape(-1, 3).mean(0).cpu().numpy()
    finally:
        dist.destroy_process_group()
    for name, counts in launches.items():
        out[f"{name}.launches"] = list(counts)
    out["sites"] = json.dumps({kind: [[n, b, rec[0]] for (n, b), rec in
                                      recs.items()]
                               for kind, recs in sites.items()})
    torch.save({kind: {shape: moved(rec[1], "cpu")
                       for shape, rec in recs.items()}
                for kind, recs in sites.items()},
               os.path.join(workdir, f"rank{rank}_sites.pt"))
    np.savez(os.path.join(workdir, f"rank{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    print(f"parallel rank {rank}: done")
    return 0


def bit_equal(name, results, key):
    """The value of `key` in every rank's results, checked bit-equal."""
    first = results[0][key]
    check(all(np.array_equal(r[key], first) for r in results[1:]),
          f"{name}: {key} differs in its bits between the ranks")
    return first


def fit_launches(info, r) -> tuple:
    """(fwd, bwd) launches of one process of fit_ensemble that trained the
    one restart in `r` (a lane alone; phase 13's lockstep_sites counts
    several): init's posterior, the restart's evaluations and scored
    iterations, then `last` and `best` resolved."""
    evals = int(sum(info["fun_evals"][i] for i in r))
    its = int(sum(info["iterations"][i] for i in r))
    return len(r) + evals + its + len(r) + 4, evals


def phase_parallel(model, X, Y, psi, tr, va, data_tr, trace_f,
                   eval_ms) -> tuple:
    """18. Sharded and multi-process training at phase 7's problem and init
    point: (a) a world of one under NCCL in this process, (b) two gloo
    ranks on the card, each a copy of this script, (c) the samplers' warmup
    pooled over those ranks. Returns ((fwd, bwd) launches of the path, the
    kernel pair's records at every shape the ranks launched, forward and
    backward)."""
    import dataclasses
    import torch
    import torch.distributed as dist
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch import model as model_mod
    from gpz_tpu_torch.config import TrainConfig
    from gpz_tpu_torch.parallel import (
        distributed, make_mesh, sharded, sharded_nlog_ml, train_sharded,
    )
    from make_torch_port_golden import TRAIN_TOL

    t_phase = time.perf_counter()
    dev = data_tr.X.device
    cfg = model.cfg
    flat0, unravel = model.last.params.flatten()
    n = data_tr.n
    Xn = (X - model.muX[None, :]) / model.sdX[None, :]
    Yc = Y[:, None] - model.muY[None, :]
    psi_c = datautils.fix_psi(psi, len(Y), model.sdX, True)
    data_va = model_mod._make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), va,
                                      torch.float64, dev)

    # the references in one process, before the ranks share the card
    f1, g1 = objective_at(flat0, unravel, data_tr, cfg)
    f_odd, g_odd = objective_at(flat0, unravel, data_tr[:n - 1], cfg)
    rng = np.random.default_rng(18)
    stacked = flat0[None].cpu().numpy() + np.stack([
        np.zeros(flat0.numel()), 0.01 * rng.standard_normal(flat0.numel())])
    alone = [objective_at(torch.as_tensor(x, device=dev), unravel, data_tr,
                          cfg)[1] for x in stacked]
    ref_model, ref_info = gpz_tpu_torch.fit_ensemble(
        X, Y, "VC", cfg.m, n_restarts=2, training=tr, validation=va,
        psi=psi, max_iter=TRAIN_ITERS, seed=1, dtype="float64", device=dev)
    train_tc = TrainConfig(max_iter=TRAIN_ITERS, max_attempts=MAX_ATTEMPTS)
    torch.cuda.synchronize()

    with tempfile.TemporaryDirectory() as workdir:
        # (a) a world of one in this process
        reset_launches()
        sharded.COLLECTIVES = 0
        distributed.initialize(f"file://{os.path.join(workdir, 'one')}", 1,
                               0, backend=PARALLEL_BACKEND)
        try:
            check(dist.get_world_size() == 1 and dist.get_backend()
                  == PARALLEL_BACKEND, "parallel: no world of one")
            mesh = make_mesh()
            flat = flat0.clone().requires_grad_(True)
            f, _ = sharded_nlog_ml(unravel(flat), data_tr, cfg, mesh,
                                   float(n), complete=True)
            g, = torch.autograd.grad(f, flat)
            one_f = within("parallel (a) nlml", float(f.detach()), f1,
                               TRAIN_TOL["init.nlml"])
            one_g = within("parallel (a) gradient", g.cpu().numpy(), g1,
                               TRAIN_TOL["init.grad"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res, _ = train_sharded(model.last.params, data_tr, cfg, mesh,
                                   valid_data=data_va, tc=train_tc,
                                   complete=True)
            torch.cuda.synchronize()
            one_s = time.perf_counter() - t0
            one_l = launches()
            one_c = sharded.COLLECTIVES
            fun = sharded.sharded_value_and_grad(unravel, cfg, mesh, True)
            _, spent = timed_collectives(lambda: fun(flat0, data_tr,
                                                     float(n)))
        finally:
            dist.destroy_process_group()
        its, evals = res.iterations, int(res.trace["fevals"][-1])
        trace_ratio = within("parallel (a) train_sharded trace",
                                 res.trace["f"], trace_f,
                                 TRAIN_TOL["trace.f"])
        want_l = (1 + evals + its + 1, 1 + evals)
        # sharded_nlog_ml: the complete flag agreed, 7 sums forward, the
        # flat gradient's mean; train_sharded: the flag agreed twice, per
        # evaluation 7 sums and the gradient's mean, per scored iteration
        # the two sums of holdout_metrics
        want_c = 9 + 2 + 8 * evals + 2 * (its + 1)
        print(f"parallel (a): world of one under {PARALLEL_BACKEND}: "
              f"sharded nlml and gradient vs nlog_ml err/bound {one_f:.3f} / "
              f"{one_g:.3f}; train_sharded {its} iterations, {evals} "
              f"evaluations in {one_s:.3f} s ({one_s / evals * 1e3:.3f} ms "
              f"per evaluation vs phase 7's {eval_ms:.3f}), f trace vs "
              f"phase 7's err/bound {trace_ratio:.3f} (bit-equal: "
              f"{np.array_equal(res.trace['f'], trace_f)}); all-reduces "
              f"{one_c} (expected {want_c}: {len(spent)} per evaluation, "
              f"{sum(spent) * 1e3:.3f} ms of one evaluation between "
              f"synchronizations, {np.median(spent) * 1e6:.1f} us median); "
              f"launches fwd/bwd {one_l} (expected {want_l})")
        check(one_l == want_l, "parallel (a): launches differ from what the "
              "path implies")
        check(one_c == want_c and len(spent) == 8, "parallel (a): "
              "all-reduces differ from what the path implies")

        # (b) and (c): two gloo ranks on the card
        arrays = model.last.params.to_numpy()
        np.savez(os.path.join(workdir, "problem.npz"),
                 device=str(dev), cfg=json.dumps(dataclasses.asdict(cfg)),
                 fields=json.dumps(list(arrays)),
                 **{f"param.{k}": v for k, v in arrays.items()},
                 muX=model.muX, sdX=model.sdX, muY=model.muY, n_train=n,
                 n_valid=data_va.n, iters=TRAIN_ITERS,
                 max_attempts=MAX_ATTEMPTS, stacked=stacked, lr=PARALLEL_LR)
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-rank",
             str(r), workdir], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(2)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))[0])
        except subprocess.TimeoutExpired:
            check(False, f"parallel: the ranks ran past {RANK_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
        for r, p in enumerate(procs):
            check(p.returncode == 0, f"parallel: rank {r} exited "
                  f"{p.returncode}:\n{outs[r][-3000:]}")
        results = []
        for r in range(2):
            with np.load(os.path.join(workdir, f"rank{r}.npz")) as z:
                results.append({k: z[k] for k in z.files})
        saved = [torch.load(os.path.join(workdir, f"rank{r}_sites.pt"))
                 for r in range(2)]

    # (b) the values
    out = results
    check(all(float(r["value.n_eff"]) == n for r in out)
          and sorted(int(r["value.rows"]) for r in out) == [n // 2,
                                                           n - n // 2],
          "parallel (b): global_dataset's n_eff or rows")
    b_f = within("parallel (b) nlml", bit_equal("(b)", out, "value.f"),
                     f1, TRAIN_TOL["init.nlml"])
    b_g = within("parallel (b) gradient", bit_equal("(b)", out,
                                                         "value.g"),
                     g1, TRAIN_TOL["init.grad"])
    tr_f = bit_equal("(b) train", out, "train.f")
    bit_equal("(b) train", out, "train.x")
    b_t = within("parallel (b) train_sharded trace", tr_f, trace_f,
                     TRAIN_TOL["trace.f"])
    check(sorted(int(r["uneven.rows"]) for r in out) == [(n - 1) // 2,
                                                        n - (n - 1) // 2 - 1]
          and all(float(r["uneven.n_eff"]) == n - 1 for r in out),
          "parallel (b): the uneven split's rows or n_eff")
    u_f = within("parallel (b) uneven nlml", bit_equal(
        "(b) uneven", out, "uneven.f"), f_odd, TRAIN_TOL["init.nlml"])
    u_g = within("parallel (b) uneven gradient", bit_equal(
        "(b) uneven", out, "uneven.g"), g_odd, TRAIN_TOL["init.grad"])
    stepped = bit_equal("(b) ensemble step", out, "ensemble_step.x")
    e_g = max(within(f"parallel (b) ensemble step restart {r}",
                         (stacked[r] - stepped[r]) / PARALLEL_LR,
                         alone[r], BATCH_TOL["grad"]) for r in range(2))
    for key in ("fit.restart_scores", "fit.best_restart", "fit.iterations",
                "fit.fun_evals", "fit.best", "fit.last"):
        bit_equal("(b) fit_ensemble", out, key)
    fit = out[0]
    check(int(fit["fit.best_restart"]) == ref_info["best_restart"]
          and np.array_equal(fit["fit.iterations"], ref_info["iterations"])
          and np.array_equal(fit["fit.fun_evals"], ref_info["fun_evals"]),
          "parallel (b): fit_ensemble(mesh) took other branches than "
          "fit_ensemble(mesh=None)")
    f_s = within("parallel (b) fit_ensemble scores",
                     fit["fit.restart_scores"], ref_info["restart_scores"],
                     RESTART_TOL)
    f_p = max(within(f"parallel (b) fit_ensemble {w}", fit[f"fit.{w}"],
                         getattr(ref_model, w).params.flatten()[0].cpu(),
                         RESTART_TOL) for w in ("best", "last"))
    # launches of the path on each rank, against what it implies
    path_l = [0, 0]
    for r, res_r in enumerate(out):
        evals = int(res_r["train.fevals"][-1])
        its = int(res_r["train.iterations"])
        want = {"value": (1, 1), "warm": (1, 1),
                "train": (evals + its + 1, evals),
                "uneven": (1, 1), "ensemble_step": (1, 1),
                "fit_ensemble": fit_launches(ref_info, [r]),
                "hmc": (0, 0), "nuts": (0, 0)}
        got = {k: tuple(int(x) for x in res_r[f"{k}.launches"])
               for k in want}
        check(got == want, f"parallel (b): rank {r} launched {got}, the "
              f"path implies {want}")
        for k in ("value", "warm", "train", "uneven", "ensemble_step",
                  "fit_ensemble"):
            path_l[0] += got[k][0]
            path_l[1] += got[k][1]
    r0 = out[0]
    coll = r0["value.collective_s"]
    print(f"parallel (b): 2 gloo ranks on the card in {ranks_s:.1f} s "
          f"(start-up included); n_eff {n}; nlml and gradient vs one "
          f"process err/bound {b_f:.3f} / {b_g:.3f}, bit-equal on both "
          f"ranks; one warm evaluation {r0['warm.s'] * 1e3:.3f} ms (the "
          f"first {r0['value.s'] * 1e3:.3f}) with "
          f"{int(r0['warm.collectives'])} all-reduces "
          f"({coll.sum() * 1e3:.3f} ms between synchronizations, "
          f"{np.median(coll) * 1e6:.1f} us median); train_sharded "
          f"{int(r0['train.iterations'])} iterations, "
          f"{int(r0['train.fevals'][-1])} evaluations in "
          f"{float(r0['train.s']):.3f} s "
          f"({float(r0['train.s']) / int(r0['train.fevals'][-1]) * 1e3:.3f}"
          f" ms per evaluation vs phase 7's {eval_ms:.3f}), traces "
          f"bit-equal, vs phase 7's err/bound {b_t:.3f}")
    print(f"parallel (b): uneven {n - 1} rows as "
          f"{sorted(int(r['uneven.rows']) for r in out)}, n_eff "
          f"{n - 1}: err/bound {u_f:.3f} / {u_g:.3f}; ensemble_grad_step "
          f"on (restart 2, data 1) vs each restart alone err/bound "
          f"{e_g:.3f}; fit_ensemble(mesh) 2 restarts, best "
          f"{int(fit['fit.best_restart'])}, scores "
          f"{fit['fit.restart_scores'].tolist()} vs mesh=None err/bound "
          f"{f_s:.3f}, parameters {f_p:.3f}, the same model on both ranks "
          f"({float(r0['fit_ensemble.s']):.3f} s); launches fwd/bwd "
          f"{tuple(path_l)}")

    # (c) the samplers' pooled adaptation
    for name in ("hmc", "nuts"):
        eps = bit_equal(f"(c) {name}", out, f"{name}.step_size")
        check(eps.shape == () and np.isfinite(eps) and float(eps) > 0,
              f"parallel (c): {name} step size {eps}")
        acc = np.concatenate([r[f"{name}.accept"] for r in out])
        print(f"parallel (c): {name} {PAR_CHAINS} chains on each of 2 "
              f"ranks, {PAR_WARMUP} + {PAR_DRAWS}: step size {float(eps):.6f}"
              f" bit-equal on both ranks, acceptance {acc.round(3).tolist()}"
              f", pooled mean "
              f"{np.mean([r[f'{name}.mean'] for r in out], 0).round(3)} "
              f"(target [1, -2, 0.5]) in "
              f"{max(float(r[f'{name}.s']) for r in out):.2f} s")

    # the kernel pair against plain at every shape the ranks launched, on
    # each rank's first arguments there; launches summed over the ranks
    def gathered(kind):
        counts = {}
        for r in out:
            for nn, b, c in json.loads(str(r["sites"]))[kind]:
                counts[(nn, b)] = counts.get((nn, b), 0) + c
        return {shape: [counts[shape], moved(saved[0][kind].get(
            shape, saved[-1][kind].get(shape, ())), dev)]
                for shape in counts}

    fwd = gathered("fwd")
    bwd = gathered("bwd")
    # the uneven split's sites on the rank that holds the padded row
    fwd_u = {s_: [c, moved(saved[1]["fwd_uneven"][s_], dev)]
             for s_, (c, _) in gathered("fwd_uneven").items()}
    bwd_u = {s_: [c, moved(saved[1]["bwd_uneven"][s_], dev)]
             for s_, (c, _) in gathered("bwd_uneven").items()}
    del saved
    fwd_recs = compare_sites("parallel", fwd, "phase-18 main path (both "
                             "ranks)", key="launches")
    fwd_recs.update(compare_sites("parallel-uneven", fwd_u, "uneven split "
                                  "(both ranks)", key="launches"))
    bwd_recs = compare_bwd_sites("parallel", bwd, "phase-18 main path (both "
                                 "ranks)")
    bwd_recs.update(compare_bwd_sites("parallel-uneven", bwd_u,
                                      "uneven split (both ranks)"))
    got = (one_l[0] + path_l[0], one_l[1] + path_l[1])
    print(f"parallel: phase in {time.perf_counter() - t_phase:.1f} s; "
          f"launches fwd/bwd {got} ((a) {one_l}, (b) {tuple(path_l)})")
    return got, fwd_recs, bwd_recs


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils, metrics
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.model import _make_dataset, _moments_batch
    from gpz_tpu_torch.ops import vc_phi
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    if argv[:1] == ["--parallel-rank"]:
        return parallel_rank(int(argv[1]), argv[2])
    from make_torch_port_golden import (
        GOLDEN_TOL, MISSING_PATTERNS, MISSING_ROWS, MISSING_TOL,
        OBJECTIVE_ROWS, OUTPUTS, POINTS, TRACE_ITERS, TRAIN_TOL,
        inject_missing, load_golden, load_golden_missing, load_golden_train,
        missing_serve_rows, missing_train_problem, objective_rows,
        train_problem,
    )
    predict_mod = importlib.import_module("gpz_tpu_torch.predict")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    f64 = torch.float64

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi)  # as nvidia-smi prints it: name, power limit
    print(f"device: torch {torch.__version__} cuda {torch.version.cuda} "
          f"name {name!r} count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    so = vc_phi.build()
    vc_phi.library()
    build_s = time.perf_counter() - t0
    print(f"build: {os.path.relpath(so, ROOT)} in {build_s:.2f} s")
    log = so[:-3] + ".log"
    if os.path.exists(log):
        with open(log) as fh:
            lines = fh.read().splitlines()
        # ptxas names a function, then reports its registers and spills
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and (
                    "IdLi5E" in line or "IdLi8E" in line
                    or "wide_kernelI" in line):
                report = " ".join(s.strip() for s in lines[i + 1:i + 4]
                                  if "registers" in s or "spill" in s)
                what = "bwd" if "bwd_" in line else "fwd"
                if "wide_kernelI" in line:
                    kind = "double" if "wide_kernelId" in line else "float"
                    print(f"build: {what} wide <{kind}>: {report}")
                    continue
                dd = 5 if "IdLi5E" in line else 8
                print(f"build: {what} <double, {dd}>: {report}")
    sass_check(so)

    # 3. forward kernel vs plain
    rng = np.random.default_rng(0)
    random_cases = {}
    for dt_name, dt in (("float64", f64), ("float32", torch.float32)):
        # tests/test_ops.py's shapes, a pair-pass block of 8 x 100 pairs,
        # and the ends of the range of d the kernels are compiled for
        for n, d, m in ((37, 3, 5), (300, 3, 7), (23, 3, 11), (750, 5, 800),
                        (33, 1, 40), (300, 8, 37)):
            args = random_inputs(rng, n, d, m, dt, dev)
            random_cases[f"random-{dt_name}-{n}x{m}"] = (dt_name, args)
    # float32, d=8, pivots of A ~1e-6
    tiny = random_inputs(rng, 300, 8, 37, torch.float32, dev, scale=1e-3)
    random_cases["small-pivot-float32-300x37"] = ("float32", tiny)
    for case, (dt_name, args) in random_cases.items():
        compare_kernel(case, args, KERNEL_TOL[dt_name])
    # A = psi + Sigma indefinite for bases 1 and 4 on every row
    X_, psi_, P_, Sigma_, lds_ = random_inputs(rng, 23, 3, 6, f64, dev)
    Sigma_[[1, 4]] = -5.0 * torch.eye(3, dtype=f64, device=dev)
    lds_[[1, 4]] = 0.0
    non_pd = (X_, psi_, P_, Sigma_, lds_)
    compare_kernel("non-pd-float64-23x6", non_pd, KERNEL_TOL["float64"])
    nan = torch.isnan(vc_phi.vc_lnphi_complete(*non_pd))
    check(bool(nan[:, [1, 4]].all()) and not bool(nan[:, [0, 2, 3, 5]].any()),
          "non-pd: NaN is not exactly in the columns of the indefinite bases")
    # the first pivot of A exactly zero for basis 2 on every row: NaN in that
    # basis and nowhere else, forward and backward, as in the plain versions
    X_, psi_, P_, Sigma_, lds_ = random_inputs(rng, 23, 3, 6, f64, dev)
    psi_[:, 0, 0] = 0.25
    Sigma_[2, 0, 0] = -0.25
    zero_pivot = (X_, psi_, P_, Sigma_, lds_)
    compare_kernel("zero-pivot-float64-23x6", zero_pivot,
                   KERNEL_TOL["float64"])
    g_ = torch.ones((23, 6), dtype=f64, device=dev)
    outs = (vc_phi.vc_lnphi_complete(*zero_pivot),
            *vc_phi.vc_lnphi_bwd(*zero_pivot[:4], g_))
    plains = (vc_phi.vc_lnphi_plain(*zero_pivot),
              *vc_phi.vc_lnphi_bwd_plain(*zero_pivot[:4], g_))
    for basis_axis, got, want in zip((1, 0, 0), outs, plains):
        nan = torch.isnan(got)
        check(bool(nan.select(basis_axis, 2).all())
              and bool((nan == ~torch.isfinite(want)).all()),
              "zero-pivot: NaN is not exactly in basis 2, where the plain "
              "version is not finite")
    model32 = gpz_tpu_torch.load_model(CHECKPOINT)
    check(model32.best.params.P.device.type == "cuda",
          "load_model without a device did not load onto the card")
    model64 = model32.astype("float64")
    mags, errs, z = synthetic_sdss(n=20_000, seed=1)
    psi_all = errs ** 2
    _, _, test = datautils.split(len(z), 0.2, 0.2, 0.6,
                                 np.random.default_rng(1))
    rows = np.where(test)[0]
    check(len(rows) == REQUESTS * REQUEST_ROWS,
          f"{len(rows)} test rows, expected {REQUESTS * REQUEST_ROWS}")
    # every shape that phase 5's first request launches, from that request
    first = rows[:REQUEST_ROWS]
    _, serve_sites = site_calls(lambda: gpz_tpu_torch.predict(
        mags[first], model32, psi=psi_all[first]))
    want_sites = expected_sites(model32.cfg,
                                complete_calls(model32.cfg, REQUEST_ROWS))
    check(site_counts(serve_sites) == want_sites, "serving: one request "
          f"launched {site_counts(serve_sites)}, the budgets imply "
          f"{want_sites}")
    serve_cases = compare_sites("serve", serve_sites,
                                f"{REQUEST_ROWS}-row request")
    phi_args = next(iter(serve_sites.values()))[1]

    # 4. backward kernel vs plain backward and autograd
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bwd_errs = []
    for case, (dt_name, args) in random_cases.items():
        g = torch.randn((args[0].shape[0], args[2].shape[0]),
                        dtype=args[0].dtype, device=dev, generator=gen)
        compare_backward(case, args, g, KERNEL_BWD_TOL[dt_name])
    g_phi = torch.randn(phi_args[0].shape[0], phi_args[2].shape[0],
                        dtype=f64, device=dev, generator=gen)
    bwd_errs.append(compare_backward("serve-phi-site", phi_args, g_phi,
                                     KERNEL_BWD_TOL["trained"]))

    # 5. slice: 4 requests of 3,000 rows at the checkpoint's dtype
    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
    preds, secs = [], []
    for r in range(REQUESTS):
        idx = rows[r * REQUEST_ROWS:(r + 1) * REQUEST_ROWS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds.append(gpz_tpu_torch.predict(mags[idx], model32,
                                           psi=psi_all[idx]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    serve_launches = vc_phi.LAUNCHES_FWD
    check(vc_phi.LAUNCHES_BWD == 0, "serving launched the backward kernel")
    mu = np.concatenate([p.mu for p in preds])[:, 0]
    sigma = np.concatenate([p.sigma for p in preds])[:, 0]
    check(all(np.isfinite(getattr(p, k)).all() for p in preds
              for k in OUTPUTS + ("phi",)), "non-finite prediction")
    check(mu.shape == (len(rows),) and sigma.min() > 0,
          "prediction shapes or variances wrong")
    expected = REQUESTS * sum(want_sites.values())
    rmse = metrics.rmse_curve(z[rows], mu, sigma)[-1]
    mll = metrics.cumulative_by_confidence(z[rows], mu, sigma,
                                           metrics.log_likelihood)[-1]
    warm = [REQUEST_ROWS / s for s in secs[1:]]
    print(f"slice: {len(rows)} rows in {REQUESTS} requests, seconds "
          f"{[round(s, 4) for s in secs]}, warm rows/s "
          f"{[round(w, 1) for w in warm]}")
    print(f"slice: test RMSE {rmse:.6f}, mean test log-likelihood "
          f"{mll:.6f}, forward launches {serve_launches} (expected "
          f"{expected}: per batch 1 PHI site + the pair blocks)")
    check(serve_launches == expected, "kernel launch count differs from "
          "the serving path's two sites")

    # golden: the first 256 test rows against JAX
    golden = load_golden()
    check(np.array_equal(golden["rows"], rows[:256]),
          "golden rows differ from this data draw")
    sel = rows[:256]
    for dt_name, model in (("float32", model32), ("float64", model64)):
        pred = gpz_tpu_torch.predict(mags[sel], model, psi=psi_all[sel])
        for k in OUTPUTS:
            got, want = getattr(pred, k), golden[dt_name][k]
            rtol, atol = GOLDEN_TOL[dt_name][k]
            err = np.abs(got - want)
            worst = float(np.max(err / (atol + rtol * np.abs(want))))
            print(f"golden {dt_name} {k}: max_abs {err.max():.3e} max_rel "
                  f"{np.max(err / np.abs(want)):.3e} (err/bound {worst:.3f})")
            check(worst <= 1.0, f"golden {dt_name} {k} beyond rtol={rtol}, "
                  f"atol={atol}")

    # 6. objective: value and gradient against JAX at two points
    gold = load_golden_train()
    X, Y, psi, tr, va = train_problem(synthetic_sdss)
    check(int(tr.sum()) == N_TRAIN and int(va.sum()) == N_VALID,
          "training problem's split differs from bench_convergence.py's")
    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = gpz_tpu_torch.init(X, Y, "VC", TRAIN_M, psi=psi, training=tr,
                               seed=1, dtype="float64")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_launches = (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD)
    check(model.last.params.P.device.type == "cuda",
          "init without a device did not build the model on the card")
    flat0, unravel = model.last.params.flatten()
    err0 = float(np.max(np.abs(flat0.cpu().numpy() - gold["init.flat"])))
    print(f"objective: init in {init_s:.3f} s, flat parameters vs JAX's "
          f"init max_abs {err0:.3e}")
    check(err0 <= TRAIN_TOL["init.flat"], "init differs from the JAX "
          f"package's beyond {TRAIN_TOL['init.flat']}")
    trained_flat = model64.best.params.flatten()[0]
    points = {
        "init": (model, torch.as_tensor(gold["init.flat"], device=dev)),
        "trained": (model64, trained_flat),
    }
    check(tuple(points) == POINTS, "golden points differ")
    eval_rows = objective_rows(tr)
    for pname, (mdl, flat) in points.items():
        Xn = (X - mdl.muX[None, :]) / mdl.sdX[None, :]
        Yc = Y[:, None] - mdl.muY[None, :]
        psi_c = datautils.fix_psi(psi, len(Y), mdl.sdX, mdl.cfg.full_cov)
        data = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), eval_rows, f64,
                             dev)
        check(data.n == OBJECTIVE_ROWS, "objective rows differ")
        nlml, grad = objective_at(flat, unravel, data, mdl.cfg)
        want_f, want_g = float(gold[f"{pname}.nlml"]), gold[f"{pname}.grad"]
        (frt, fat), (grt, gat) = TRAIN_TOL[f"{pname}.nlml"], TRAIN_TOL[
            f"{pname}.grad"]
        f_ratio = abs(nlml - want_f) / (fat + frt * abs(want_f))
        g_err = np.abs(grad - want_g)
        g_ratio = float(np.max(g_err / (gat + grt * np.abs(want_g))))
        print(f"objective {pname}: nlml {nlml:.12f} (JAX {want_f:.12f}, "
              f"err/bound {f_ratio:.3f}); gradient max_abs {g_err.max():.3e} "
              f"of max {np.abs(want_g).max():.3e} (err/bound {g_ratio:.3f})")
        check(np.isfinite(nlml) and np.isfinite(grad).all(),
              f"objective {pname}: non-finite")
        check(f_ratio <= 1.0, f"objective {pname}: value beyond "
              f"rtol={frt}, atol={fat}")
        check(g_ratio <= 1.0, f"objective {pname}: gradient beyond "
              f"rtol={grt}, atol={gat}")

    # 7. train: 25 iterations at full width, then predict
    kw = dict(training=tr, validation=va, psi=psi, verbose=False,
              max_attempts=MAX_ATTEMPTS)
    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = gpz_tpu_torch.train(model, X, Y, max_iter=TRAIN_ITERS, **kw)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD)
    fit = fitted.fit_info
    trace = fit["trace"]
    n_it, evals = fit["iterations"], fit["fun_evals"]
    ex = trace["extras"]
    finite = all(np.isfinite(a).all() for a in (
        trace["f"], trace["opt_cond"], trace["step"], trace["score"],
        *ex.values()))
    check(finite, "train: non-finite trace value")
    check(n_it == TRAIN_ITERS and len(trace["f"]) == n_it + 1,
          f"train: {n_it} iterations, expected {TRAIN_ITERS}")
    check(bool(np.all(np.diff(trace["f"]) <= 0)),
          "train: f increased over an accepted iteration")
    k = TRACE_ITERS + 1
    rtol, atol = TRAIN_TOL["trace.f"]
    t_err = np.abs(trace["f"][:k] - gold["trace.f"])
    t_ratio = float(np.max(t_err / (atol + rtol * np.abs(gold["trace.f"]))))
    print(f"train: f at iterations 0..{TRACE_ITERS} "
          f"{np.round(trace['f'][:k], 8).tolist()} vs JAX max_abs "
          f"{t_err.max():.3e} (err/bound {t_ratio:.3f}); evaluations "
          f"{trace['fevals'][:k].tolist()} (JAX "
          f"{gold['trace.fevals'].tolist()})")
    check(t_ratio <= 1.0, f"train: f trace beyond rtol={rtol}, atol={atol} "
          "of JAX's float64 trace")
    check(np.array_equal(trace["fevals"][:k], gold["trace.fevals"]),
          "train: evaluation counts differ from JAX's over iterations 0..5")
    # forward: one per evaluation, one per scored iteration (0..n_it), and
    # posterior + prior for each of `last` and `best`; backward: one per
    # evaluation. init: the posterior's one forward.
    want_launches = (evals + (n_it + 1) + 4, evals)
    print(f"train: {n_it} iterations, {evals} evaluations in {train_s:.3f} s"
          f" ({train_s / evals * 1e3:.3f} ms per evaluation, the run's "
          f"scoring and resolving included; {evals / train_s:.2f} "
          f"evaluations/s); final nlml {fit['final_nlml']:.8f}; train RMSE "
          f"{ex['train_rmse'][-1]:.6f}, valid RMSE {ex['valid_rmse'][-1]:.6f}"
          f"; launches fwd/bwd {train_launches} (expected {want_launches}), "
          f"init {init_launches} (expected (1, 0))")
    check(init_launches == (1, 0), "init: launch counts differ from the "
          "posterior's one forward")
    check(train_launches == want_launches, "train: launch counts differ "
          "from what the path implies")
    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
    pred = gpz_tpu_torch.predict(mags[rows], fitted, psi=psi_all[rows])
    predict_l = (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD)
    check(all(np.isfinite(getattr(pred, k_)).all() for k_ in OUTPUTS)
          and pred.sigma.min() > 0, "train: prediction with the freshly "
          "trained model is not finite with positive variance")
    check(predict_l == (sum(expected_sites(fitted.cfg, complete_calls(
        fitted.cfg, len(rows))).values()), 0),
          "train: predict's launch counts differ")
    print(f"train: predict on {len(rows)} test rows finite, test RMSE "
          f"{metrics.rmse_curve(z[rows], pred.mu[:, 0], pred.sigma[:, 0])[-1]:.6f}"
          f", launches fwd/bwd {predict_l}")
    path_fwd = init_launches[0] + train_launches[0] + predict_l[0]
    path_bwd = train_launches[1]
    check(path_fwd > 0 and path_bwd > 0 and serve_launches > 0,
          "a kernel of the path was never launched")

    # kernel times at the training shape, on the trained model's arguments
    phi_mod = importlib.import_module("gpz_tpu_torch.phi")
    real = phi_mod.vc_lnphi_complete
    seen = []
    phi_mod.vc_lnphi_complete = lambda *a: (seen.append(a), real(*a))[1]
    try:
        Xn = (X - fitted.muX[None, :]) / fitted.sdX[None, :]
        Yc = Y[:, None] - fitted.muY[None, :]
        psi_c = datautils.fix_psi(psi, len(Y), fitted.sdX, True)
        data_tr = _make_dataset(Xn, Yc, psi_c, np.ones(len(Y)), tr, f64, dev)
        flat_t, unravel_t = fitted.last.params.flatten()
        objective_at(flat_t, unravel_t, data_tr, fitted.cfg)
    finally:
        phi_mod.vc_lnphi_complete = real
    big = tuple(a.detach() for a in seen[0][:5])
    g_big = torch.randn(big[0].shape[0], big[2].shape[0], dtype=f64,
                        device=dev, generator=gen)
    small = tuple(a[:4096].contiguous() for a in big[:2]) + big[2:]
    g_small = g_big[:4096].contiguous()
    fwd_big = compare_kernel("train-shape", big, KERNEL_TOL["trained"])
    bwd_errs.append(compare_backward("train-shape", big, g_big,
                                     KERNEL_BWD_TOL["trained"]))
    few = dict(trials=5, calls=5, warmup=2)
    bwd_rec = {}
    for label, a, g in (("4096x100", small, g_small),
                        ("70000x100", big, g_big)):
        bwd_rec[label] = {
            "ms": median_ms(lambda: vc_phi.vc_lnphi_bwd(*a[:4], g), **few),
            "plain_ms": median_ms(
                lambda: vc_phi.vc_lnphi_bwd_plain(*a[:4], g), **few),
        }
        fwd_ms = median_ms(lambda: vc_phi.vc_lnphi_complete(*a), **few)
        n_, m_, d_ = a[0].shape[0], a[2].shape[0], a[0].shape[1]
        bf, bb = bound("fwd", n_, m_, d_, "float64"), bound(
            "bwd", n_, m_, d_, "float64")
        print(f"times {label} d={d_} f64: fwd kernel {fwd_ms:.4f} ms, "
              f"{fwd_ms / bf['bound_ms']:.2f}x its bound (bound "
              f"{bf['bound_ms']:.4f} ms by {bf['bound_by']}: bytes "
              f"{bf['bytes_ms']:.4f}, operations {bf['ops_ms']:.4f}); bwd "
              f"kernel {bwd_rec[label]['ms']:.4f} ms, "
              f"{bwd_rec[label]['ms'] / bb['bound_ms']:.2f}x its bound, plain "
              f"{bwd_rec[label]['plain_ms']:.4f} ms (bound "
              f"{bb['bound_ms']:.4f} ms by {bb['bound_by']}: bytes "
              f"{bb['bytes_ms']:.4f}, operations {bb['ops_ms']:.4f})")

    def fun(flat):
        return objective_at(flat, unravel_t, data_tr, fitted.cfg)

    torch.cuda.synchronize()
    eval_ms = []
    for _ in range(8):
        t0 = time.perf_counter()
        fun(flat_t)
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    print(f"eval: one gradient evaluation at {data_tr.n} x {TRAIN_M}, host "
          f"clock with its result read back: median of the last 5 "
          f"{np.median(eval_ms[3:]):.3f} ms "
          f"({1e3 / np.median(eval_ms[3:]):.2f} evaluations/s)")
    if "--profile" in argv:
        profile_evaluation(fun, flat_t)

    # 8. north star: bench_convergence from a fresh process
    conv_launches, _ = phase_convergence()

    # 9. missing-serve: 2 requests of 3,000 rows with injected NaNs
    gm = load_golden_missing()
    m_idx, Xs, psis, zs, picks = missing_serve_rows(synthetic_sdss,
                                                    datautils.split)
    check(np.array_equal(gm["rows"], m_idx[picks])
          and len(picks) == MISSING_ROWS,
          "golden rows with missing values differ from this data draw")
    n_req = len(Xs) // REQUEST_ROWS
    requests = [slice(r * REQUEST_ROWS, (r + 1) * REQUEST_ROWS)
                for r in range(n_req)]
    vc_phi.LAUNCHES_FWD = vc_phi.LAUNCHES_BWD = 0
    mpreds, msecs, mcalls = [], [], []
    for rq in requests:
        (pred, sec), calls = moments_calls(
            lambda: timed_predict(Xs[rq], model32, psis[rq]))
        mpreds.append(pred)
        msecs.append(sec)
        mcalls.append(calls)
    missing_launches = vc_phi.LAUNCHES_FWD
    check(vc_phi.LAUNCHES_BWD == 0, "missing-serve launched the backward "
          "kernel")
    bs = _moments_batch(model32.cfg)
    want_calls, want_launches = 0, 0
    for rq, calls in zip(requests, mcalls):
        batches = expected_batches(Xs[rq], bs)
        escalated = [c for c in calls if c[2] == model32.cfg.m]
        guarded = [c for c in calls if c[3] is not None]
        check(sorted((c[0], c[1]) for c in calls if c not in escalated)
              == sorted(batches), "missing-serve: the moment batches differ "
              "from the patterns' groups")
        check(len(guarded) == sum(1 for b in batches if not b[1])
              and len(escalated) == sum(
                  1 for c in guarded
                  if c[3] < predict_mod.MIX_COVERAGE_MIN),
              "missing-serve: the coverage guard did not read every batch "
              "with missing values, or escalated another number than fell "
              "below MIX_COVERAGE_MIN")
        want_calls += len(calls)
        want_launches += sum(expected_sites(model32.cfg, calls).values())
    all_calls = [c for calls in mcalls for c in calls]
    coverages = [c[3] for c in all_calls if c[3] is not None]
    n_esc = sum(1 for c in all_calls if c[2] == model32.cfg.m)
    n_nan = int(np.isnan(Xs).any(axis=1).sum())
    for pred in mpreds:
        check(all(np.isfinite(getattr(pred, k_)).all()
                  for k_ in OUTPUTS + ("phi",)),
              "missing-serve: non-finite prediction")
        check(pred.nu.min() >= 0 and pred.gamma.min() >= 0
              and pred.sigma.min() > 0, "missing-serve: negative variance")
    mmu = np.concatenate([p.mu for p in mpreds])[:, 0]
    msig = np.concatenate([p.sigma for p in mpreds])[:, 0]
    print(f"missing-serve: {len(Xs)} rows ({n_nan} with NaNs) in {n_req} "
          f"requests, seconds {[round(s_, 4) for s_ in msecs]}, warm rows/s "
          f"{[round(REQUEST_ROWS / s_, 1) for s_ in msecs[1:]]} (complete "
          f"rows, phase 5: {[round(w, 1) for w in warm]}); test RMSE "
          f"{metrics.rmse_curve(zs, mmu, msig)[-1]:.6f}")
    print(f"missing-serve: {want_calls} moment calls, forward launches "
          f"{missing_launches} (expected {want_launches}); coverage of the "
          f"top {predict_mod.MIX_TOPL} of {model32.cfg.m} components over "
          f"{len(coverages)} guarded batches: min {min(coverages):.9f}, "
          f"{n_esc} escalated to the exact mixture (below "
          f"{predict_mod.MIX_COVERAGE_MIN})")
    check(missing_launches == want_launches and missing_launches > 0,
          "missing-serve: kernel launch count differs from what the calls "
          "imply")
    for dt_name, mdl in (("float32", model32), ("float64", model64)):
        pred = gpz_tpu_torch.predict(Xs[picks], mdl, psi=psis[picks])
        for k_ in OUTPUTS:
            got, want = getattr(pred, k_), gm[f"{dt_name}.{k_}"]
            rtol, atol = MISSING_TOL[dt_name][k_]
            err = np.abs(got - want)
            worst = float(np.max(err / (atol + rtol * np.abs(want))))
            print(f"missing-golden {dt_name} {k_}: max_abs {err.max():.3e} "
                  f"(err/bound {worst:.3f})")
            check(worst <= 1.0, f"missing-golden {dt_name} {k_} beyond "
                  f"rtol={rtol}, atol={atol}")

    # the kernel at every shape that the first request launches, recorded
    # from that request served once more: the complete rows' two sites, and
    # the mixture sums' X_hat and Psi_hat of each pattern with a lost band
    rq = requests[0]
    _, mix_sites = site_calls(lambda: gpz_tpu_torch.predict(
        Xs[rq], model32, psi=psis[rq]))
    want_sites = expected_sites(model32.cfg, mcalls[0])
    check(site_counts(mix_sites) == want_sites, "missing-serve: one request "
          f"launched {site_counts(mix_sites)}, the budgets imply "
          f"{want_sites}")
    mix_cases = compare_sites("missing", mix_sites,
                              f"{REQUEST_ROWS}-row request with NaNs")
    del mix_sites

    # the mixture sums in float32 against float64, at the trained point
    mix = {}
    for dt_name in ("float64", "float32", "float64", "float32"):
        with env_set("GPZ_MIX_DTYPE", dt_name):
            pred, sec = timed_predict(Xs[rq], model32, psis[rq])
        mix.setdefault(dt_name, []).append((pred, sec))
    p64, p32 = mix["float64"][-1][0], mix["float32"][-1][0]
    nan32 = sum(int((~np.isfinite(getattr(p32, k_))).sum())
                for k_ in OUTPUTS + ("phi",))
    fin = np.isfinite(p32.mu[:, 0]) & np.isfinite(p32.sigma[:, 0])
    print(f"mix-dtype: {REQUEST_ROWS} rows at the trained point, mixture "
          f"sums in float32 against float64: {nan32} non-finite output "
          f"values in float32 (float64: "
          f"{sum(int((~np.isfinite(getattr(p64, k_))).sum())
                 for k_ in OUTPUTS + ('phi',))}"
          f"), max |mu32 - mu64| "
          f"{np.abs(p32.mu - p64.mu)[fin].max():.3e}, max relative "
          f"difference of sigma "
          f"{(np.abs(p32.sigma - p64.sigma) / p64.sigma)[fin].max():.3e}; "
          f"seconds float64 {[round(x[1], 4) for x in mix['float64']]}, "
          f"float32 {[round(x[1], 4) for x in mix['float32']]}")

    # 10. missing-objective: the masked pass, VC m=100
    Xm, Ym, psim, omegam, trm, vam = missing_train_problem(
        synthetic_sdss, datautils.get_omega)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vc0 = gpz_tpu_torch.init(Xm, Ym, "VC", TRAIN_M, psi=psim, training=trm,
                             seed=1, dtype="float64")
    torch.cuda.synchronize()
    vc_init_s = time.perf_counter() - t0
    flat_m, unravel_m = vc0.last.params.flatten()
    err0 = float(np.max(np.abs(flat_m.cpu().numpy() - gm["init.flat"])))
    check(err0 <= MISSING_TOL["init.flat"], "missing-objective: init "
          f"differs from the JAX package's by {err0:.3e}")

    def masked_data(mdl, sel):
        Xn = (Xm - mdl.muX[None, :]) / mdl.sdX[None, :]
        Yc = Ym[:, None] - mdl.muY[None, :]
        psi_c = datautils.fix_psi(psim, len(Ym), mdl.sdX, mdl.cfg.full_cov)
        return _make_dataset(Xn, Yc, psi_c, np.ones(len(Ym)), sel, f64, dev)

    data_m = masked_data(vc0, objective_rows(trm))
    check(data_m.n == OBJECTIVE_ROWS and not bool(data_m.mask.all()),
          "missing-objective: rows differ")
    flat_g = torch.as_tensor(gm["init.flat"], device=dev)
    nlml, grad = objective_at(flat_g, unravel_m, data_m, vc0.cfg,
                              complete=False)
    (frt, fat), (grt, gat) = MISSING_TOL["init.nlml"], MISSING_TOL[
        "init.grad"]
    want_f, want_g = float(gm["init.nlml"]), gm["init.grad"]
    f_ratio = abs(nlml - want_f) / (fat + frt * abs(want_f))
    g_err = np.abs(grad - want_g)
    g_ratio = float(np.max(g_err / (gat + grt * np.abs(want_g))))
    print(f"missing-objective: init on {int(trm.sum())} rows with NaNs in "
          f"{vc_init_s:.3f} s (flat parameters vs JAX max_abs {err0:.3e}); "
          f"{OBJECTIVE_ROWS} rows: nlml {nlml:.12f} (JAX {want_f:.12f}, "
          f"err/bound {f_ratio:.3f}); gradient max_abs {g_err.max():.3e} of "
          f"max {np.abs(want_g).max():.3e} (err/bound {g_ratio:.3f})")
    check(np.isfinite(nlml) and np.isfinite(grad).all(),
          "missing-objective: non-finite")
    check(f_ratio <= 1.0 and g_ratio <= 1.0, "missing-objective: value or "
          "gradient beyond MISSING_TOL of JAX's")
    data_mt = masked_data(vc0, trm)

    def masked_eval():
        return objective_at(flat_m, unravel_m, data_mt, vc0.cfg,
                            complete=False)

    masked_eval()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    masked_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        masked_eval()
        masked_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    masked_launches = count_launches(masked_eval)
    print(f"missing-objective: one gradient evaluation of the masked pass at "
          f"{data_mt.n} x {TRAIN_M}, d=5, float64, host clock with its "
          f"result read back: {[round(t_, 1) for t_ in masked_ms]} ms, "
          f"{masked_launches} cudaLaunchKernel calls, peak device memory "
          f"{peak / 2**20:.0f} MiB ({(peak - base_mem) / 2**20:.0f} MiB "
          f"above what was held before)")
    del data_mt, data_m

    # 11. diag-train: VD m=100, psi (n, d), NaNs, balanced weights
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vd0 = gpz_tpu_torch.init(Xm, Ym, "VD", TRAIN_M, psi=psim, omega=omegam,
                             training=trm, seed=1, dtype="float64")
    torch.cuda.synchronize()
    vd_init_s = time.perf_counter() - t0
    err0 = float(np.max(np.abs(vd0.last.params.flatten()[0].cpu().numpy()
                               - gm["vd.init.flat"])))
    check(err0 <= MISSING_TOL["vd.init.flat"], "diag-train: init differs "
          f"from the JAX package's by {err0:.3e}")
    t0 = time.perf_counter()
    vd1 = gpz_tpu_torch.train(vd0, Xm, Ym, training=trm, validation=vam,
                              psi=psim, omega=omegam, max_iter=TRAIN_ITERS,
                              max_attempts=MAX_ATTEMPTS, verbose=False)
    torch.cuda.synchronize()
    vd_train_s = time.perf_counter() - t0
    vfit = vd1.fit_info
    vtrace = vfit["trace"]
    check(all(np.isfinite(a).all() for a in (
        vtrace["f"], vtrace["opt_cond"], vtrace["step"], vtrace["score"],
        *vtrace["extras"].values())), "diag-train: non-finite trace value")
    check(bool(np.all(np.diff(vtrace["f"]) <= 0)),
          "diag-train: f increased over an accepted iteration")
    check(vfit["iterations"] == TRAIN_ITERS, f"diag-train: "
          f"{vfit['iterations']} iterations, expected {TRAIN_ITERS}")
    rtol, atol = MISSING_TOL["vd.trace.f"]
    t_err = np.abs(vtrace["f"][:k] - gm["vd.trace.f"])
    t_ratio = float(np.max(t_err / (atol + rtol * np.abs(gm["vd.trace.f"]))))
    print(f"diag-train: VD m={TRAIN_M}, init {vd_init_s:.3f} s (vs JAX "
          f"max_abs {err0:.3e}); f at iterations 0..{TRACE_ITERS} "
          f"{np.round(vtrace['f'][:k], 8).tolist()} vs JAX max_abs "
          f"{t_err.max():.3e} (err/bound {t_ratio:.3f}); evaluations "
          f"{vtrace['fevals'][:k].tolist()} (JAX "
          f"{gm['vd.trace.fevals'].tolist()})")
    check(t_ratio <= 1.0, f"diag-train: f trace beyond rtol={rtol}, "
          f"atol={atol} of JAX's float64 trace")
    check(np.array_equal(vtrace["fevals"][:k], gm["vd.trace.fevals"]),
          "diag-train: evaluation counts differ from JAX's over iterations "
          "0..5")
    Xt_nan = inject_missing(mags[rows])
    vpred, vsec = timed_predict(Xt_nan, vd1, psi_all[rows])
    check(all(np.isfinite(getattr(vpred, k_)).all()
              for k_ in OUTPUTS + ("phi",)) and vpred.sigma.min() > 0,
          "diag-train: prediction is not finite with positive variance")
    print(f"diag-train: {vfit['iterations']} iterations, "
          f"{vfit['fun_evals']} evaluations in {vd_train_s:.3f} s "
          f"({vd_train_s / vfit['fun_evals'] * 1e3:.3f} ms per evaluation, "
          f"scoring and resolving included); final nlml "
          f"{vfit['final_nlml']:.8f}, valid RMSE "
          f"{vtrace['extras']['valid_rmse'][-1]:.6f}; predict on "
          f"{len(rows)} test rows with NaNs in {vsec:.3f} s "
          f"({len(rows) / vsec:.1f} rows/s, first call), test RMSE "
          f"{metrics.rmse_curve(z[rows], vpred.mu[:, 0], vpred.sigma[:, 0])[-1]:.6f}")

    # 12-16: the command line, restart ensembles, the host optimizer, the
    # gradient check and the bench command, each read with its own counts
    with tempfile.TemporaryDirectory() as workdir:
        new_paths = phase_cli(workdir)
    new_paths["ensemble"], ens_fwd, ens_bwd = phase_ensemble(X, Y, psi, tr,
                                                             va)
    new_paths["host_lbfgs"] = phase_host_lbfgs(model, X, Y, psi, tr,
                                               trace["f"])
    new_paths["derivcheck"] = phase_derivcheck(model, X, Y, psi, tr)
    new_paths["bench"] = phase_bench(smi)
    new_paths["inference"], inf_fwd, inf_bwd = phase_inference(
        model64, mags, errs, z, rows, data_tr, flat_t, unravel_t, fitted.cfg)
    new_paths["parallel"], par_fwd, par_bwd = phase_parallel(
        model, X, Y, psi, tr, va, data_tr, trace["f"],
        train_s / evals * 1e3)
    new_paths["demos"], demo_fwd, demo_bwd = phase_demos()
    new_paths["scale"], scale_fwd, scale_bwd, topl_batch = phase_scale()
    bands_launches, new_paths["mix_topl"], wide_rec, bands_fwd, bands_bwd = (
        phase_bands(topl_batch))
    del topl_batch
    new_paths["convergence"] = conv_launches
    new_fwd = sum(f for f, _ in new_paths.values())
    new_bwd = sum(b for _, b in new_paths.values())

    n_, m_, d_ = big[0].shape[0], big[2].shape[0], big[0].shape[1]
    source = "gpz_tpu_torch/csrc/vc_phi.cu"
    kernels = [{
        "name": "vc_lnphi_fwd", "route": "cuda", "source": source,
        "replaces": "gpz_tpu/ops/vc_phi.py:126",
        "launches": serve_launches + path_fwd + missing_launches + new_fwd,
        "launches_by_path": {"serve": serve_launches, "train": path_fwd,
                             "missing_serve": missing_launches,
                             **{k_: f for k_, (f, _) in new_paths.items()}},
        "max_abs_err": max(c["max_abs_err"] for c in (
            fwd_big, *serve_cases.values(), *mix_cases.values(),
            *ens_fwd.values(), *inf_fwd.values(), *par_fwd.values(),
            *demo_fwd.values(), *scale_fwd.values())),
        "sites": {**serve_cases, **mix_cases, **ens_fwd, **inf_fwd,
                  **par_fwd, **demo_fwd, **scale_fwd},
        "shape": [n_, m_, d_, "float64"],
        "ms": fwd_big["ms"], "plain_ms": fwd_big["plain_ms"],
        **{k_: v for k_, v in bound("fwd", n_, m_, d_, "float64").items()
           if k_ in ("bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "vc_lnphi_bwd", "route": "cuda", "source": source,
        "replaces": "gpz_tpu/ops/vc_phi.py:138",
        "launches": path_bwd + new_bwd,
        "launches_by_path": {"serve": 0, "train": path_bwd,
                             "missing_serve": 0,
                             **{k_: b for k_, (_, b) in new_paths.items()}},
        "max_abs_err": max(bwd_errs + [c["max_abs_err"] for c in (
            *ens_bwd.values(), *inf_bwd.values(), *par_bwd.values(),
            *demo_bwd.values(), *scale_bwd.values())]),
        "sites": {**ens_bwd, **inf_bwd, **par_bwd, **demo_bwd, **scale_bwd},
        "shape": [n_, m_, d_, "float64"],
        **bwd_rec["70000x100"],
        **{k_: v for k_, v in bound("bwd", n_, m_, d_, "float64").items()
           if k_ in ("bound_ms", "bound_by")},
        "library_ms": None,
    }]
    # the wide variant (d > 8) of each kernel: launched on the nine-band
    # path only; its times at (70,000 x 100), d = 9, from phase 21 (a)
    for kind, rec, launched, sites in (
            ("fwd", wide_rec[0], bands_launches[0], bands_fwd),
            ("bwd", wide_rec[1], bands_launches[1], bands_bwd)):
        kernels.append({
            "name": f"vc_lnphi_{kind}_wide", "route": "cuda",
            "source": source,
            "replaces": ("gpz_tpu/ops/vc_phi.py:126" if kind == "fwd"
                         else "gpz_tpu/ops/vc_phi.py:138"),
            "launches": launched,
            "launches_by_path": {"bands": launched},
            "max_abs_err": max([rec["max_abs_err"]] + [
                c["max_abs_err"] for c in sites.values()]),
            "sites": sites,
            "shape": [*rec["shape"], "float64"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": None,
        })
    for k_ in kernels:
        k_["ms_over_bound"] = k_["ms"] / k_["bound_ms"]
        print(f"ratio {k_['name']}: {k_['ms']:.4f} ms / bound "
              f"{k_['bound_ms']:.4f} ms = {k_['ms_over_bound']:.2f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
