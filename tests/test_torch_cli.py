"""The port's command line (`python -m gpz_tpu_torch train|predict|bench`)
against gpz_tpu.cli.main on the same CSV, in float64 on the CPU
(`--device cpu`): synthetic_sdss(800) as m_1..m_5,e_1..e_5,z, VD and VC at
m=8, 20 iterations.

The split and the initialization are NumPy in both packages, so the two
optimizers start from the same point and take the same branches: equal
iterations and evaluations. The tolerances are tests/test_torch_train.py's:
the best validation log-likelihood within TRACE, predictions within
PREDICTED, also when each package serves the other's checkpoint. The bench
problem's arrays are bench.py's to the bit; one value+gradient of nlog_ml on
it (n=2,000, float64) is within TRAIN_TOL's init-point bounds of JAX's.
"""

import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import jax
import jax.numpy as jnp

from gpz_tpu import cli as jcli
from gpz_tpu.data import synthetic_sdss
from gpz_tpu.objective import nlog_ml as jax_nlog_ml

from gpz_tpu_torch import bench as tbench
from gpz_tpu_torch import cli as tcli
from gpz_tpu_torch.checkpoint import load_model

from make_torch_port_golden import ROOT, TRAIN_TOL
from test_torch_train import PREDICTED, TRACE

sys.path.insert(0, ROOT)
import bench as jbench  # noqa: E402  (the repository's bench.py)

N, M, ITERS = 800, 8, 20
METHODS = ("VD", "VC")
PORT, REF = "port", "gpz_tpu"
MAINS = {PORT: tcli.main, REF: jcli.main}


def run(pkg, argv):
    """main(argv) of one package with its stdout captured: the JSON lines
    it printed, as dicts."""
    if pkg == PORT and argv[0] in ("train", "predict"):
        argv = [*argv, "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = MAINS[pkg](argv)
    assert rc in (None, 0)
    return [json.loads(ln) for ln in buf.getvalue().splitlines()
            if ln.startswith("{")]


@pytest.fixture(scope="module")
def catalog(tmp_path_factory):
    mags, errs, z = synthetic_sdss(n=N, seed=5)
    d = tmp_path_factory.mktemp("cli")
    path = d / "sample.csv"
    np.savetxt(path, np.column_stack([mags, errs, z]), delimiter=",")
    return d, str(path)


@pytest.fixture(scope="module", params=METHODS)
def trained(request, catalog):
    """{package: (JSON line of train, checkpoint path, prediction CSV of its
    own checkpoint, the JSON lines of that predict)}."""
    d, csv = catalog
    out = {}
    for pkg in (PORT, REF):
        ckpt = str(d / f"{request.param}-{pkg}.npz")
        lines = run(pkg, ["train", csv, "--out", ckpt, "--method",
                          request.param, "--m", str(M), "--max-iter",
                          str(ITERS), "--dtype", "float64"])
        pred = str(d / f"{request.param}-{pkg}-pred.csv")
        plines = run(pkg, ["predict", csv, "--model", ckpt, "--out", pred,
                           "--has-target", "--has-errors"])
        out[pkg] = (lines[-1], ckpt, pred, plines)
    return request.param, out


def read_pred(path):
    with open(path) as fh:
        header = fh.readline().strip()
    return header, np.loadtxt(path, delimiter=",", skiprows=1)


def test_train_equals_gpz_tpu(trained):
    _, out = trained
    got, want = out[PORT][0], out[REF][0]
    assert set(got) == set(want)
    assert got["iterations"] == want["iterations"] == ITERS
    assert got["fun_evals"] == want["fun_evals"]
    np.testing.assert_allclose(got["best_valid_ll"], want["best_valid_ll"],
                               **TRACE)
    assert os.path.exists(got["saved"])


def test_predict_csv_equals_gpz_tpu(trained):
    _, out = trained
    (h, got), (jh, want) = read_pred(out[PORT][2]), read_pred(out[REF][2])
    assert h == jh == "target,mu,sigma,nu,beta_i,gamma"
    assert got.shape == (N, 6) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PREDICTED)
    metrics, wrote = out[PORT][3]
    jmetrics, jwrote = out[REF][3]
    assert metrics["n"] == jmetrics["n"] == N
    np.testing.assert_allclose([metrics["rmse"], metrics["mll"]],
                               [jmetrics["rmse"], jmetrics["mll"]],
                               **PREDICTED)
    assert wrote == {"wrote": out[PORT][2]}


def test_each_package_serves_the_others_checkpoint(trained, catalog):
    """The port serves gpz_tpu's checkpoint as gpz_tpu does, and gpz_tpu
    serves the port's as the port does."""
    method, out = trained
    d, csv = catalog
    for server, owner in ((PORT, REF), (REF, PORT)):
        pred = str(d / f"{method}-{server}-serves-{owner}.csv")
        run(server, ["predict", csv, "--model", out[owner][1], "--out", pred,
                     "--has-target", "--has-errors"])
        np.testing.assert_allclose(read_pred(pred)[1],
                                   read_pred(out[owner][2])[1], **PREDICTED)
    model = load_model(out[REF][1], device="cpu")
    assert model.cfg.method == method and model.cfg.dtype == "float64"


@pytest.mark.parametrize("option", ["--no-input-noise", "--no-errors",
                                    "--checkpoint-every"])
def test_train_option_runs(option, catalog):
    d, csv = catalog
    if option == "--no-errors":
        raw = np.loadtxt(csv, delimiter=",")
        path = d / "no-errors.csv"
        np.savetxt(path, np.column_stack([raw[:, :5], raw[:, -1]]),
                   delimiter=",")
        csv, args = str(path), ["--no-errors"]
    elif option == "--checkpoint-every":
        args = ["--checkpoint-every", "4"]
    else:
        args = [option]
    ckpt = str(d / f"option{option}.npz")
    info = run(PORT, ["train", csv, "--out", ckpt, "--method", "VL", "--m",
                      "6", "--max-iter", "8", "--dtype", "float64", *args])
    assert info[-1]["saved"] == ckpt and np.isfinite(info[-1]["best_valid_ll"])
    model = load_model(ckpt, device="cpu")
    assert model.cfg.d == (10 if option == "--no-input-noise" else 5)
    # train_with_checkpoints reports the last segment's iterations
    want = 4 if option == "--checkpoint-every" else 8
    assert info[-1]["iterations"] == want


def test_bench_problem_equals_bench_py():
    cfg, params, data = tbench.make_problem(n=300, device="cpu")
    jcfg, jparams, jdata = jbench.make_problem(n=300)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    for f in ("X", "mask", "omega", "Y", "psi"):
        a, b = getattr(data, f), np.asarray(getattr(jdata, f))
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    for f, t in params._items():
        b = np.asarray(getattr(jparams, f))
        assert t.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(t.numpy(), b, err_msg=f)


def test_bench_value_and_grad_equals_jax():
    """One evaluation of the bench objective at n=2,000 in float64."""
    cfg, params, data = tbench.make_problem(n=2000, dtype=np.float64,
                                            device="cpu")
    jcfg, jparams, jdata = jbench.make_problem(n=2000, dtype=jnp.float64)
    jcfg = dataclasses.replace(jcfg, dtype="float64")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    f, g = tbench.value_and_grad(params, data, cfg)
    (jf, _), jg = jax.jit(jax.value_and_grad(
        lambda p: jax_nlog_ml(p, jdata, jcfg, complete=True),
        has_aux=True))(jparams)
    rtol, atol = TRAIN_TOL["init.nlml"]
    np.testing.assert_allclose(float(f), float(jf), rtol=rtol, atol=atol)
    rtol, atol = TRAIN_TOL["init.grad"]
    for name, t in g._items():
        np.testing.assert_allclose(t.numpy(), np.asarray(getattr(jg, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_module_help_exits_0_and_an_unknown_command_fails():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "gpz_tpu_torch", "--help"],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("usage: python -m gpz_tpu_torch")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["serve"]) == 1
    assert "unknown command 'serve'" in buf.getvalue()
