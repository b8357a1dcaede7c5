"""Worker process for tests/test_torch_parallel*.py: one rank of a gloo
process group on the CPU, running one test file's scenarios through
gpz_tpu_torch.parallel and writing its results (an .npz) for the test
process, which holds them against the port in one process and against
gpz_tpu. It imports torch and the port only.

Usage: python torch_parallel_worker.py <scenario> <init_method> <world>
       <rank> <outfile>

Scenarios: "pair" (2 ranks; tests/test_torch_parallel.py), "train" (2
ranks; tests/test_torch_parallel_train.py), "entry" (2 ranks;
tests/test_torch_parallel_entry.py), "grid" (4 ranks;
tests/test_torch_parallel_mesh.py), "adapt" (4 ranks;
tests/test_torch_parallel_adapt.py). The problems are made from numpy
seeds by `problem`, which the test files import too.
"""

import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from gpz_tpu_torch.config import ModelConfig, TrainConfig  # noqa: E402
from gpz_tpu_torch.dataset import Dataset, pad_dataset  # noqa: E402
from gpz_tpu_torch.params import GPzParams  # noqa: E402
from gpz_tpu_torch.parallel import (  # noqa: E402
    RESTART_AXIS, distributed, ensemble_grad_step, make_mesh, shard_dataset,
    sharded_nlog_ml, sharded_value_and_grad, train_sharded,
)

F64 = torch.float64

# (name, method, psi, rows, seed, NaNs): the loss cases mirror
# tests/test_sharding.py's three (n=37); the gradient cases are its VD case
# (n=29), the main path's VC with full psi, and rows with NaNs
LOSS_CASES = (("VL", "VL", False, 37, 3, False),
              ("VD-psi", "VD", True, 37, 3, False),
              ("VC-psi", "VC", True, 37, 3, False))
GRAD_CASES = (("VD-psi", "VD", True, 29, 4, False),
              ("VC-psi", "VC", True, 37, 8, False),
              ("VD-nan", "VD", True, 31, 9, True))
# tests/test_sharding.py's training cases: VL, n=64, 25 and 15 iterations
CONVERGE = ("VL", False, 64, 5, 25)
TRAJECTORY = ("VL", False, 64, 6, 15)
# train_sharded with a validation set scored through holdout_metrics
VALIDATED = ("VC", True, 48, 10, 8, 16)
# tests/test_distributed.py's scenario: 64 rows, then 63 split 32 / 31
DIST_ROWS, UNEVEN_ROWS = 64, 63
# the ensemble step on the (restart 2, data 2) grid: R restarts, lr
ENSEMBLE = ("VD", False, 32, 7, 4, 1e-3)
# fit_ensemble over the grid: rows, method, m, restarts, iterations, seed
FIT = (200, "VC", 6, 2, 10, 3)
# the sampler cases of tests/test_collective_adapt.py: chains per rank,
# warmup, draws, leapfrog steps
ADAPT = (2, 300, 400, 16)


def problem(method, with_psi, n, seed, missing=False, het=True, d=3, m=4,
            k=1):
    """(params, data, cfg kwargs) as numpy arrays: a seeded GPz problem with
    non-uniform omega; psi (n, d, d) for GC/VC and (n, d) otherwise when
    `with_psi`; with `missing`, about 15% of X's entries NaN (each row keeps
    one observed)."""
    rng = np.random.default_rng(seed)
    full = method in ("GC", "VC")
    gshape = ModelConfig(m=m, d=d, k=k, method=method).gamma_shape
    if full:
        gamma = np.eye(d) * 0.8 + 0.1 * rng.standard_normal(gshape)
    else:
        gamma = 0.8 + 0.4 * rng.random(gshape)
    params = {
        "P": rng.standard_normal((m, d)),
        "gamma": gamma,
        "ln_alpha": 0.3 * rng.standard_normal((m, k)),
        "b": np.log(0.05) + 0.1 * rng.standard_normal(k),
    }
    if het:
        params["v"] = 0.1 * rng.standard_normal((m, k))
        params["ln_tau"] = 0.2 * rng.standard_normal((m, k))
    X = rng.standard_normal((n, d))
    Y = np.sin(X[:, :1] + np.arange(k)[None, :]) + 0.1 * rng.standard_normal(
        (n, k))
    omega = rng.uniform(0.5, 1.5, n)
    psi = None
    if with_psi and full:
        A = rng.standard_normal((n, d, d)) * 0.2
        psi = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(d)
    elif with_psi:
        psi = 0.05 + 0.1 * rng.random((n, d))
    mask = np.ones((n, d), bool)
    if missing:
        mask = rng.random((n, d)) > 0.15
        mask[np.arange(n), rng.integers(0, d, n)] = True
    data = {"X": np.where(mask, X, 0.0), "mask": mask, "omega": omega,
            "Y": Y, "psi": psi}
    cfg = dict(m=m, d=d, k=k, method=method, heteroscedastic=het,
               dtype="float64")
    return params, data, cfg


def port_problem(*args, **kw):
    """problem() as the port's (GPzParams, Dataset, ModelConfig) on the
    CPU."""
    params, data, cfg = problem(*args, **kw)
    return (GPzParams.from_numpy(params, "cpu", F64), to_dataset(data),
            ModelConfig(**cfg))


def to_dataset(data, rows=slice(None)):
    return Dataset(**{f: None if v is None else torch.as_tensor(v[rows])
                      for f, v in data.items()})


def stacked_restarts(params, R, seed):
    """R jittered copies of a parameter dict, stacked on a leading axis (as
    tests/test_sharding.py's ensemble case makes them)."""
    rng = np.random.default_rng(seed)
    return {f: np.stack([v + 0.01 * rng.standard_normal(v.shape)
                         for _ in range(R)]) for f, v in params.items()}


def flat_grad(fun, params, data, n_eff):
    flat, _ = params.flatten()
    f, g, aux = fun(flat, data, n_eff)
    return float(f), g.numpy(), aux


def autograd_grad(params, data, cfg, mesh, n_eff):
    """The gradient by autograd through sharded_nlog_ml, as
    tests/test_sharding.py takes jax.grad of it."""
    flat, unravel = params.flatten()
    flat = flat.clone().requires_grad_(True)
    f, _ = sharded_nlog_ml(unravel(flat), data, cfg, mesh, n_eff,
                           complete=bool(data.mask.all()))
    f.backward()
    return flat.grad.numpy()


def gradients(out, prefix, mesh, cases=GRAD_CASES):
    """Value and flat gradient of each case on `mesh`'s data group, by
    sharded_value_and_grad and by autograd through sharded_nlog_ml."""
    for name, method, psi, n, seed, missing in cases:
        params, data, cfg = port_problem(method, psi, n, seed, missing)
        sdata, n_eff = shard_dataset(data, mesh)
        _, unravel = params.flatten()
        complete = bool(sdata.mask.all())   # per shard: agreed inside
        fun = sharded_value_and_grad(unravel, cfg, mesh, complete)
        f, g, _ = flat_grad(fun, params, sdata, n_eff)
        out[f"{prefix}.{name}.f"] = f
        out[f"{prefix}.{name}.g"] = g
        out[f"{prefix}.{name}.auto_g"] = autograd_grad(params, sdata, cfg,
                                                       mesh, n_eff)


def trace_of(res):
    return {"f": res.trace["f"], "score": res.trace["score"],
            "fevals": res.trace["fevals"], "x": res.x.numpy(),
            "iterations": res.iterations}


def run_pair(rank):
    out = {}
    mesh = make_mesh()
    out["mesh.shape"] = [mesh.size(RESTART_AXIS), mesh.size("data")]
    for name, method, psi, n, seed, missing in LOSS_CASES:
        params, data, cfg = port_problem(method, psi, n, seed, missing)
        sdata, n_eff = shard_dataset(data, mesh)
        f, aux = sharded_nlog_ml(params, sdata, cfg, mesh, n_eff,
                                 complete=True)
        out[f"loss.{name}.f"] = float(f)
        out[f"loss.{name}.w"] = aux.w.numpy()
        out[f"loss.{name}.rmse"] = float(aux.train_rmse)
        out[f"loss.{name}.rows"] = sdata.n
    gradients(out, "grad", mesh)
    return out


def run_train(rank):
    out = {}
    mesh = make_mesh()
    for key, (method, psi, n, seed, iters) in (("converge", CONVERGE),
                                               ("trajectory", TRAJECTORY)):
        params, data, cfg = port_problem(method, psi, n, seed)
        res, _ = train_sharded(params, data, cfg, mesh,
                               tc=TrainConfig(max_iter=iters),
                               complete=True)
        for k, v in trace_of(res).items():
            out[f"{key}.{k}"] = v
    method, psi, n_tr, n_va, seed, iters = VALIDATED
    params, data, cfg = port_problem(method, psi, n_tr + n_va, seed)
    res, _ = train_sharded(params, data[:n_tr], cfg, mesh,
                           valid_data=data[n_tr:],
                           tc=TrainConfig(max_iter=iters), complete=True)
    for k, v in trace_of(res).items():
        out[f"validated.{k}"] = v
    out["validated.valid_rmse"] = res.trace["extras"]["valid_rmse"]
    return out


def run_entry(rank):
    """The multi-process entry: each rank loads its row range only."""
    out = {}
    mesh = make_mesh()
    params, data, cfg = problem("VD", True, DIST_ROWS, 5)
    lo, hi = distributed.host_row_range(DIST_ROWS)
    out["dist.row_range"] = [lo, hi]
    port_params = GPzParams.from_numpy(params, "cpu", F64)
    cfg = ModelConfig(**cfg)
    for key, keep_psi in (("dist", True), ("dist_nopsi", False)):
        local = to_dataset(data, slice(lo, hi))
        if not keep_psi:
            local.psi = None
        gdata, n_eff = distributed.global_dataset(local, mesh, device="cpu")
        f, _ = sharded_nlog_ml(port_params, gdata, cfg, mesh, n_eff,
                               complete=True)
        out[f"{key}.n_eff"] = n_eff
        out[f"{key}.f"] = float(f)
    res, _ = train_sharded(port_params, to_dataset(data), cfg, mesh,
                           tc=TrainConfig(max_iter=2, history=4),
                           complete=True)
    out["dist.train_f"] = res.trace["f"]

    # unequal local rows, padded with omega=0 rows before assembly
    params, data, cfg = port_problem("VC", True, UNEVEN_ROWS, 11)
    lo, hi = distributed.host_row_range(UNEVEN_ROWS)
    target = -(-UNEVEN_ROWS // mesh.size("data"))
    local = pad_dataset(data[lo:hi], target)
    gdata, n_eff = distributed.global_dataset(local, mesh, device="cpu")
    _, unravel = params.flatten()
    f, g, _ = flat_grad(sharded_value_and_grad(unravel, cfg, mesh, True),
                        params, gdata, n_eff)
    out.update({"uneven.local_rows": hi - lo, "uneven.n_eff": n_eff,
                "uneven.f": f, "uneven.g": g})
    try:
        distributed.global_dataset(data[lo:hi], mesh, device="cpu")
    except ValueError as exc:
        out["uneven.unpadded_error"] = str(exc)
    return out


def run_grid(rank):
    out = {}
    for shape, args in (("3 restarts", dict(n_restart=3)),
                        ("2 x 3", dict(n_data=3, n_restart=2))):
        try:
            make_mesh(**args)
        except ValueError as exc:
            out[f"mesh_error.{shape}"] = str(exc)

    # the gradient on four ranks of one data group
    gradients(out, "grad4", make_mesh(n_data=4))

    mesh = make_mesh(n_data=2, n_restart=2)
    out["grid.coords"] = [mesh.get_local_rank(RESTART_AXIS),
                          mesh.get_local_rank("data")]
    method, psi, n, seed, R, lr = ENSEMBLE
    params, data, cfg = problem(method, psi, n, seed)
    stacked = stacked_restarts(params, R, seed)
    sdata, n_eff = shard_dataset(to_dataset(data), mesh)
    stepped = ensemble_grad_step(
        GPzParams.from_numpy(stacked, "cpu", F64), sdata, ModelConfig(**cfg),
        mesh, n_eff, lr=lr, complete=True)
    for f in stacked:
        out[f"ensemble.{f}"] = getattr(stepped, f).numpy()

    import gpz_tpu_torch
    model, info = fit_problem(gpz_tpu_torch.fit_ensemble, mesh=mesh)
    out["fit.scores"] = info["restart_scores"]
    out["fit.best_restart"] = info["best_restart"]
    out["fit.iterations"] = info["iterations"]
    out["fit.fun_evals"] = info["fun_evals"]
    for which in ("best", "last"):
        out[f"fit.{which}"] = getattr(model, which).params.flatten()[0].numpy()
    out["fit.best_w"] = model.best.post.w.numpy()
    return out


def fit_problem(fit_ensemble, **kw):
    """fit_ensemble on a seeded photo-z problem (FIT), on the CPU."""
    from gpz_tpu_torch.data import synthetic_sdss

    n, method, m, restarts, iters, seed = FIT
    mags, errs, z = synthetic_sdss(n, filters=5, seed=seed)
    rng = np.random.default_rng(seed)
    part = rng.permutation(n)
    tr = np.zeros(n, bool)
    va = np.zeros(n, bool)
    tr[part[:n * 3 // 5]] = True
    va[part[n * 3 // 5:n * 4 // 5]] = True
    return fit_ensemble(mags, z, method, m, n_restarts=restarts, training=tr,
                        validation=va, psi=errs ** 2, max_iter=iters,
                        seed=seed, dtype="float64", device="cpu", **kw)


def corr_gauss():
    """tests/test_collective_adapt.py's correlated Gaussian: (logp on a
    batch of chains, mean, covariance)."""
    A = np.array([[2.0, 0.5, 0.0], [0.5, 1.0, 0.3], [0.0, 0.3, 0.5]])
    prec = torch.as_tensor(np.linalg.inv(A))
    mu = torch.tensor([1.0, -2.0, 0.5], dtype=F64)

    def logp(x):
        d = x - mu
        return -0.5 * torch.sum((d @ prec) * d, dim=-1)

    return logp, mu.numpy(), A


def run_adapt(rank):
    from gpz_tpu_torch.inference import hmc_sample, nuts_sample

    mesh = make_mesh(n_data=1, n_restart=dist.get_world_size())
    group = mesh.get_group(RESTART_AXIS)
    logp, _, _ = corr_gauss()
    chains, warmup, draws, leapfrog = ADAPT
    out = {}
    for name, sampler, extra in (("hmc", hmc_sample,
                                  dict(num_leapfrog=leapfrog)),
                                 ("nuts", nuts_sample, {})):
        gen = torch.Generator().manual_seed(1000 * rank + 2)
        samples, info = sampler(
            logp, torch.zeros(3, dtype=F64), gen, num_warmup=warmup,
            num_samples=draws, num_chains=chains, collective_adapt=True,
            axis_name=group, **extra)
        out[f"{name}.samples"] = samples.numpy()
        out[f"{name}.accept"] = info["accept_rate"].numpy()
        out[f"{name}.step_size"] = info["step_size"].numpy()
    return out


SCENARIOS = {"pair": run_pair, "train": run_train, "entry": run_entry,
             "grid": run_grid, "adapt": run_adapt}


class Ranks:
    """`scenario` on `world` ranks, each a process of this module, that meet
    through a file:// rendezvous in the fresh directory `tmpdir`. The ranks
    start here and run while the caller computes its references;
    `results()` waits for them until one deadline, `timeout` seconds from
    the start, and gives one dict per rank. `close()` kills whatever is
    still running, so no rank outlives its owner."""

    def __init__(self, scenario, world, tmpdir, timeout=120.0):
        self.outfiles = [os.path.join(tmpdir, f"rank{r}.npz")
                         for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), scenario,
             f"file://{os.path.join(tmpdir, 'rendezvous')}", str(world),
             str(r), self.outfiles[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self.deadline = time.monotonic() + timeout
        self._results = None

    def results(self):
        if self._results is None:
            try:
                outputs = [p.communicate(timeout=max(
                    1.0, self.deadline - time.monotonic()))[0]
                    for p in self.procs]
            finally:
                self.close()
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, (
                    f"rank {r} failed:\n{outputs[r][-4000:]}")
            self._results = []
            for f in self.outfiles:
                with np.load(f) as z:
                    self._results.append({k: z[k] for k in z.files})
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main():
    scenario, init_method, world, rank, outfile = sys.argv[1:6]
    world, rank = int(world), int(rank)
    distributed.initialize(init_method, world, rank, backend="gloo")
    try:
        out = SCENARIOS[scenario](rank)
    finally:
        dist.destroy_process_group()
    np.savez(outfile, **{k: np.asarray(v) for k, v in out.items()})
    print("WORKER_OK", rank)


if __name__ == "__main__":
    main()
