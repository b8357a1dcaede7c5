"""Run the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py [--profile]

Phases, each printing its own lines; any failure exits non-zero:

1. device      the card's name and power limit (nvidia-smi), torch's name
2. build       gpz_tpu_torch/csrc/vc_phi.cu with nvcc (one library holding
               the forward and the backward kernel), timed, with ptxas'
               register and spill report
3. kernel      vc_lnphi_complete (the CUDA forward kernel) against
               vc_lnphi_plain (the same function in plain PyTorch), both on
               the card: random well-conditioned inputs at tests/test_ops.py's
               shapes in float64 and float32, and the two calls that
               prediction makes at the trained photo-z point in float64; max
               errors and median CUDA-event times
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
8. north star  (a report, not a gate) the same model continued for 175 more
               iterations; final nlml beside the target -2.67041538

With --profile, one warm gradient evaluation at the training shape is also
traced with torch.profiler and its kernel table printed.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits 1 and prints
no result. It never imports JAX.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
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
NORTH_STAR_ITERS = 175
NORTH_STAR_BUDGET_S = 60.0      # continue only if the 25 iterations took less
MAX_ATTEMPTS = 50
TARGET_NLML = -2.67041538       # benchmarks/convergence_target.json

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


def random_inputs(rng, n, d, m, dtype, device):
    """tests/test_ops.py::make_inputs: random, well conditioned."""
    import torch

    X = rng.standard_normal((n, d))
    A = rng.standard_normal((n, d, d)) * 0.3
    psi = A @ np.swapaxes(A, 1, 2) + 0.2 * np.eye(d)
    P = rng.standard_normal((m, d))
    B = rng.standard_normal((m, d, d)) * 0.2
    Sigma = B @ np.swapaxes(B, 1, 2) + 0.5 * np.eye(d)
    logdet = np.linalg.slogdet(Sigma)[1]
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (X, psi, P, Sigma, logdet))


def shape_line(args):
    n, d = args[0].shape
    return f"n={n} m={args[2].shape[0]} d={d} {args[0].dtype}"


def compare_kernel(name, args, tol):
    """Forward kernel vs plain on the same card inputs; returns the max abs
    error and both times."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    got = vc_phi.vc_lnphi_complete(*args)
    want = vc_phi.vc_lnphi_plain(*args)
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
        "plain_ms": median_ms(lambda: vc_phi.vc_lnphi_plain(*args)),
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


def compare_backward(name, args, g, tol):
    """Backward kernel vs the plain backward and vs autograd through the
    plain forward, and twice against itself; returns the worst max abs
    error."""
    import torch
    from gpz_tpu_torch.ops import vc_phi

    X, psi, P, Sigma = args[:4]
    got = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g)
    again = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, g)
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


def slice_inputs(model, X, psi):
    """The arguments of the two vc_lnphi_complete calls that one predict()
    batch makes first (the PHI site, then the first pair-pass block),
    recorded from a real predict() on the card."""
    import gpz_tpu_torch

    # the module, not the package's `predict` function of the same name
    predict_mod = importlib.import_module("gpz_tpu_torch.predict")
    real = predict_mod.vc_lnphi_complete
    calls = []

    def record(*args):
        calls.append(tuple(a.clone() for a in args))
        return real(*args)

    predict_mod.vc_lnphi_complete = record
    try:
        gpz_tpu_torch.predict(X, model, psi=psi)
    finally:
        predict_mod.vc_lnphi_complete = real
    return calls[0], calls[1]


def predict_launches(cfg, rows: int) -> int:
    """Forward launches of one predict() call: one PHI-site launch plus one
    per pair-pass block, for every batch of model.predict's moments_batch
    rows (f64 chain: 8-byte elements)."""
    from gpz_tpu_torch.predict import PAIR_BUDGET, _block_size

    bs = PAIR_BUDGET * 4 // 8 // (8 * cfg.m * cfg.d * cfg.d)
    blocks = -(-cfg.m // _block_size(bs, cfg.m, cfg.d * cfg.d, itemsize=8))
    return -(-rows // bs) * (1 + blocks)


def objective_at(flat, unravel, data, cfg):
    """(nlml, flat gradient) of nlog_ml as host arrays."""
    import torch
    from gpz_tpu_torch.objective import nlog_ml

    flat = flat.detach().clone().requires_grad_(True)
    nlml, _ = nlog_ml(unravel(flat), data, cfg, complete=True)
    grad, = torch.autograd.grad(nlml, flat)
    return float(nlml.detach()), grad.cpu().numpy()


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
    from gpz_tpu_torch.model import _make_dataset
    from gpz_tpu_torch.ops import vc_phi
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from make_torch_port_golden import (
        GOLDEN_TOL, OBJECTIVE_ROWS, OUTPUTS, POINTS, TRACE_ITERS, TRAIN_TOL,
        load_golden, load_golden_train, objective_rows, train_problem,
    )

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
                    "IdLi5E" in line or "IdLi8E" in line):
                report = " ".join(s.strip() for s in lines[i + 1:i + 4]
                                  if "registers" in s or "spill" in s)
                what = "bwd" if "bwd_kernel" in line else "fwd"
                dd = 5 if "IdLi5E" in line else 8
                print(f"build: {what} <double, {dd}>: {report}")

    # 3. forward kernel vs plain
    rng = np.random.default_rng(0)
    random_cases = {}
    for dt_name, dt in (("float64", f64), ("float32", torch.float32)):
        # tests/test_ops.py's shapes, the pair pass's (750 rows, B*m=800),
        # and the ends of the range of d the kernels are compiled for
        for n, d, m in ((37, 3, 5), (300, 3, 7), (23, 3, 11), (750, 5, 800),
                        (33, 1, 40), (300, 8, 37)):
            args = random_inputs(rng, n, d, m, dt, dev)
            random_cases[dt_name, n, m] = args
            compare_kernel(f"random-{dt_name}-{n}x{m}", args,
                           KERNEL_TOL[dt_name])
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
    batch = rows[:750]
    phi_args, pair_args = slice_inputs(model64, mags[batch], psi_all[batch])
    slice_cases = [
        compare_kernel("trained-phi-site", phi_args, KERNEL_TOL["trained"]),
        compare_kernel("trained-pair-site", pair_args,
                       KERNEL_TOL["trained"]),
    ]

    # 4. backward kernel vs plain backward and autograd
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    bwd_errs = []
    for (dt_name, n, m), args in random_cases.items():
        g = torch.randn((n, m), dtype=args[0].dtype, device=dev,
                        generator=gen)
        compare_backward(f"random-{dt_name}-{n}x{m}", args, g,
                         KERNEL_BWD_TOL[dt_name])
    g_phi = torch.randn(phi_args[0].shape[0], phi_args[2].shape[0],
                        dtype=f64, device=dev, generator=gen)
    bwd_errs.append(compare_backward("trained-phi-site", phi_args, g_phi,
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
    expected = REQUESTS * predict_launches(model32.cfg, REQUEST_ROWS)
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
    check(predict_l == (predict_launches(fitted.cfg, len(rows)), 0),
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
    big = tuple(a.detach() for a in seen[0])
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
        print(f"times {label} d={d_} f64: fwd kernel {fwd_ms:.4f} ms (bound "
              f"{bf['bound_ms']:.4f} ms by {bf['bound_by']}: bytes "
              f"{bf['bytes_ms']:.4f}, operations {bf['ops_ms']:.4f}); bwd "
              f"kernel {bwd_rec[label]['ms']:.4f} ms, plain "
              f"{bwd_rec[label]['plain_ms']:.4f} ms (bound "
              f"{bb['bound_ms']:.4f} ms by {bb['bound_by']}: bytes "
              f"{bb['bytes_ms']:.4f}, operations {bb['ops_ms']:.4f})")
    for label, a in (("phi-site 750x100", phi_args),
                     ("pair-site 750x800", pair_args)):
        b = bound("fwd", a[0].shape[0], a[2].shape[0], a[0].shape[1],
                  "float64")
        print(f"bound {label} d=5 f64 fwd: {b['bound_ms']:.5f} ms by "
              f"{b['bound_by']} (bytes {b['bytes_ms']:.5f}, operations "
              f"{b['ops_ms']:.5f})")

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

    # 8. north star, reported: continue the same model
    if train_s < NORTH_STAR_BUDGET_S:
        t0 = time.perf_counter()
        cont = gpz_tpu_torch.train(fitted, X, Y, max_iter=NORTH_STAR_ITERS,
                                   **kw)
        torch.cuda.synchronize()
        cont_s = time.perf_counter() - t0
        cfit = cont.fit_info
        gap = cfit["final_nlml"] - TARGET_NLML
        print(f"north-star: continued {cfit['iterations']} iterations, "
              f"{cfit['fun_evals']} evaluations in {cont_s:.3f} s, status "
              f"{cfit['status']}; final nlml {cfit['final_nlml']:.8f} vs "
              f"target {TARGET_NLML} (difference {gap:+.3e}, within "
              f"1e-3*|target|: {abs(gap) <= 1e-3 * abs(TARGET_NLML)}); best "
              f"validation log-likelihood {cont.best.score:.6f}")
    else:
        print(f"north-star: not run ({TRAIN_ITERS} iterations took "
              f"{train_s:.1f} s, budget {NORTH_STAR_BUDGET_S} s)")

    n_, m_, d_ = big[0].shape[0], big[2].shape[0], big[0].shape[1]
    source = "gpz_tpu_torch/csrc/vc_phi.cu"
    kernels = [{
        "name": "vc_lnphi_fwd", "route": "cuda", "source": source,
        "replaces": "gpz_tpu/ops/vc_phi.py:126",
        "launches": serve_launches + path_fwd,
        "launches_by_path": {"serve": serve_launches, "train": path_fwd},
        "max_abs_err": max(c["max_abs_err"]
                           for c in slice_cases + [fwd_big]),
        "shape": [n_, m_, d_, "float64"],
        "ms": fwd_big["ms"], "plain_ms": fwd_big["plain_ms"],
        **{k_: v for k_, v in bound("fwd", n_, m_, d_, "float64").items()
           if k_ in ("bound_ms", "bound_by")},
        "library_ms": None,
    }, {
        "name": "vc_lnphi_bwd", "route": "cuda", "source": source,
        "replaces": "gpz_tpu/ops/vc_phi.py:138",
        "launches": path_bwd,
        "launches_by_path": {"serve": 0, "train": path_bwd},
        "max_abs_err": max(bwd_errs),
        "shape": [n_, m_, d_, "float64"],
        **bwd_rec["70000x100"],
        **{k_: v for k_, v in bound("bwd", n_, m_, d_, "float64").items()
           if k_ in ("bound_ms", "bound_by")},
        "library_ms": None,
    }]
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
