"""Benchmark: log-ML gradient evals/s on the SDSS-like VC config, on one
GPU — the port's copy of the repository's bench.py, which the CLI's `bench`
command runs (`python -m gpz_tpu_torch bench`).

The problem (`make_problem`): SDSS photo-z shape (d=5 magnitudes, input
noise), VC covariance, m=100 bases, heteroscedastic, n=100,000 rows in
float32 — the same NumPy arrays as bench.py's for the same seed. `main` times
20 value+gradient evaluations of `nlog_ml` on the CUDA device, enqueued back
to back and synchronized once, after one warm-up run of the same 20 (which
also builds the kernels).

Prints ONE JSON line with bench.py's keys: {"metric", "value", "unit",
"vs_baseline"}. vs_baseline is measured against the reference-derived budget
of 60 s to converged log-ML on one host (BASELINE.json): assuming ~250 grad
evals to convergence (200 iters x 1.25 evals), the baseline rate is ~4.2
evals/s.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch

from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.dataset import Dataset
from gpz_tpu_torch.objective import nlog_ml
from gpz_tpu_torch.params import FIELDS, GPzParams

ITERS = 20


def make_problem(n=100_000, d=5, m=100, k=1, method="VC", dtype=np.float32,
                 seed=0, device=None):
    """(cfg, params, data) on `device` (None: the CUDA device), drawn from
    the seed exactly as bench.py draws them; cfg.dtype is `dtype`'s name."""
    device = torch.device("cuda" if device is None else device)
    rng = np.random.default_rng(seed)
    cfg = ModelConfig(m=m, d=d, k=k, method=method,
                      dtype=np.dtype(dtype).name)
    X = rng.standard_normal((n, d)).astype(dtype)
    Y = (X @ rng.standard_normal((d, k)) * 0.3
         + 0.1 * rng.standard_normal((n, k))).astype(dtype)
    psi = np.zeros((n, d, d), dtype=dtype)
    psi[:, np.arange(d), np.arange(d)] = 0.05 + 0.1 * rng.random((n, d))

    def dev(a):
        return torch.as_tensor(a, device=device)

    data = Dataset(
        X=dev(X),
        mask=torch.ones((n, d), dtype=torch.bool, device=device),
        omega=torch.ones((n,), dtype=getattr(torch, cfg.dtype),
                         device=device),
        Y=dev(Y),
        psi=dev(psi),
    )
    gam = np.zeros((m, d, d), dtype=dtype)
    gam[:, np.arange(d), np.arange(d)] = 1.0 + 0.1 * rng.random((m, d))
    params = GPzParams(
        P=dev(rng.standard_normal((m, d)).astype(dtype)),
        gamma=dev(gam),
        ln_alpha=dev(np.zeros((m, k), dtype)),
        b=dev(np.zeros((k,), dtype)),
        v=dev(np.zeros((m, k), dtype)),
        ln_tau=dev(np.zeros((m, k), dtype)),
    )
    return cfg, params, data


def value_and_grad(params: GPzParams, data: Dataset, cfg: ModelConfig):
    """(nlml, GPzParams of gradients), on the device of the parameters."""
    leaves = {f: getattr(params, f).detach().requires_grad_(True)
              for f in FIELDS}
    with torch.enable_grad():
        nlml, _ = nlog_ml(GPzParams(**leaves), data, cfg, complete=True)
        grads = torch.autograd.grad(nlml, list(leaves.values()))
    return nlml.detach(), GPzParams(**dict(zip(leaves, grads)))


def main():
    cfg, params, data = make_problem()

    def run():
        # enqueued back to back; the device result is read once at the end
        acc = torch.zeros((), dtype=torch.float64, device=data.X.device)
        for _ in range(ITERS):
            f, g = value_and_grad(params, data, cfg)
            acc = acc + f + g.P[0, 0] * 1e-30
        return float(acc)

    run()  # build the kernels + warm up
    t0 = time.perf_counter()
    run()
    dt = time.perf_counter() - t0

    evals_per_sec = ITERS / dt
    baseline_rate = 250.0 / 60.0  # ~converged run inside the 60 s budget
    print(json.dumps({
        "metric": "logML_grad_evals_per_sec_VC_m100_n100k",
        "value": round(evals_per_sec, 3),
        "unit": "evals/s/chip",
        "vs_baseline": round(evals_per_sec / baseline_rate, 3),
    }))


if __name__ == "__main__":
    main()
