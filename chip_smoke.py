"""Run the PyTorch/CUDA port once on one GPU, end to end.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device   the card's name and power limit (nvidia-smi), torch's name for it
2. build    gpz_tpu_torch/csrc/vc_phi.cu with nvcc, timed
3. kernel   vc_lnphi_complete (the CUDA kernel) against vc_lnphi_plain (the
            same function in plain PyTorch), both on the card: random
            well-conditioned inputs at tests/test_ops.py's shapes in float64
            and float32, and the two calls that prediction makes at the
            trained photo-z point in float64; max errors and median
            CUDA-event times
4. slice    benchmarks/photoz_trained_m100.npz (VC, m=100, d=5) loaded onto
            the card serves the 12,000 test rows of the photo-z parity data
            with psi = errs**2, as 4 requests of 3,000 rows; every output
            must be finite and every batch must have launched the kernel at
            both of its sites. The first 256 test rows are then held against
            JAX's outputs in tests/data/torch_port_golden_photoz.npz, at the
            checkpoint's float32 and cast to float64, within the tolerances
            that tests/make_torch_port_golden.py states.

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

REQUESTS = 4
REQUEST_ROWS = 3000


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


def compare_kernel(name, args, tol):
    """Kernel vs plain on the same card inputs; returns the max abs error
    and both times."""
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
    bound = atol + rtol * want.abs()[fin]
    max_abs = float(err.max())
    worst = float((err / bound).max())
    rec = {
        "max_abs_err": max_abs,
        "ms": median_ms(lambda: vc_phi.vc_lnphi_complete(*args)),
        "plain_ms": median_ms(lambda: vc_phi.vc_lnphi_plain(*args)),
    }
    print(f"kernel {name}: n={got.shape[0]} m={got.shape[1]} "
          f"d={args[0].shape[1]} {got.dtype} max_abs_err={max_abs:.3e} "
          f"(err/bound {worst:.3f}) kernel {rec['ms']:.4f} ms, "
          f"plain {rec['plain_ms']:.4f} ms")
    check(worst <= 1.0, f"{name}: kernel disagrees with the plain version "
          f"beyond rtol={rtol}, atol={atol}")
    return rec


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils, metrics
    from gpz_tpu_torch.predict import PAIR_BUDGET, _block_size
    from gpz_tpu_torch.data import synthetic_sdss
    from gpz_tpu_torch.ops import vc_phi
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from make_torch_port_golden import GOLDEN_TOL, OUTPUTS, load_golden

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

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
            for line in fh:
                if "registers" in line or "spill" in line:
                    print(f"build: {line.strip()}")

    # 3. kernel vs plain
    rng = np.random.default_rng(0)
    for dt_name, dt in (("float64", torch.float64),
                        ("float32", torch.float32)):
        # tests/test_ops.py's shapes, and the pair pass's (750 rows, B*m=800)
        for n, d, m in ((37, 3, 5), (300, 3, 7), (23, 3, 11), (750, 5, 800)):
            args = random_inputs(rng, n, d, m, dt, dev)
            compare_kernel(f"random-{dt_name}-{n}x{m}", args,
                           KERNEL_TOL[dt_name])
    model32 = gpz_tpu_torch.load_model(CHECKPOINT, device=dev)
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

    # 4. slice: 4 requests of 3,000 rows at the checkpoint's dtype
    vc_phi.LAUNCHES = 0
    preds, secs = [], []
    for r in range(REQUESTS):
        idx = rows[r * REQUEST_ROWS:(r + 1) * REQUEST_ROWS]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds.append(gpz_tpu_torch.predict(mags[idx], model32,
                                           psi=psi_all[idx]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    launches = vc_phi.LAUNCHES
    mu = np.concatenate([p.mu for p in preds])[:, 0]
    sigma = np.concatenate([p.sigma for p in preds])[:, 0]
    check(all(np.isfinite(getattr(p, k)).all() for p in preds
              for k in OUTPUTS + ("phi",)), "non-finite prediction")
    check(mu.shape == (len(rows),) and sigma.min() > 0,
          "prediction shapes or variances wrong")
    # one PHI-site launch plus one per pair-pass block, for every batch of
    # model.predict's moments_batch rows (f64 chain: 8-byte elements)
    cfg = model32.cfg
    bs = PAIR_BUDGET * 4 // 8 // (8 * cfg.m * cfg.d * cfg.d)
    blocks = -(-cfg.m // _block_size(bs, cfg.m, cfg.d * cfg.d, itemsize=8))
    expected = REQUESTS * -(-REQUEST_ROWS // bs) * (1 + blocks)
    rmse = metrics.rmse_curve(z[rows], mu, sigma)[-1]
    mll = metrics.cumulative_by_confidence(z[rows], mu, sigma,
                                           metrics.log_likelihood)[-1]
    warm = [REQUEST_ROWS / s for s in secs[1:]]
    print(f"slice: {len(rows)} rows in {REQUESTS} requests, seconds "
          f"{[round(s, 4) for s in secs]}, warm rows/s "
          f"{[round(w, 1) for w in warm]}")
    print(f"slice: test RMSE {rmse:.6f}, mean test log-likelihood "
          f"{mll:.6f}, launches {launches} (expected "
          f"{expected}: per batch of {bs} rows 1 PHI site + {blocks} pair "
          "blocks)")
    check(launches == expected, "kernel launch count differs from the "
          "path's two sites")

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

    pair = slice_cases[1]
    print(json.dumps({"kernels": [{
        "name": "vc_lnphi_fwd",
        "route": "cuda",
        "source": "gpz_tpu_torch/csrc/vc_phi.cu",
        "replaces": "gpz_tpu/ops/vc_phi.py:126",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in slice_cases),
        "ms": pair["ms"],
        "plain_ms": pair["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
