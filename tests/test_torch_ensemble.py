"""gpz_tpu_torch.fit_ensemble against gpz_tpu.ensemble.fit_ensemble in
float64 on the CPU: three restarts of VL, and of VC with full input noise, on
a seeded photo-z problem (400 rows: 240 training, 80 validation; m=8, 15
iterations).

gpz_tpu trains the restarts as one vmapped program and the port one after
another; each restart is the same optimization, so they take the same
branches (equal iterations and evaluations per restart, the same best
restart). The tolerances are tests/test_torch_train.py's: validation scores
within TRACE (measured 0.011 of it for VC), parameters within TRAINED,
predictions within PREDICTED.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu
from gpz_tpu.data import synthetic_sdss
from gpz_tpu.ensemble import fit_ensemble as jax_fit_ensemble

import gpz_tpu_torch
from gpz_tpu_torch.params import FIELDS

from test_torch_train import PREDICTED, TRACE, TRAINED

N, M, RESTARTS, ITERS, SEED = 400, 8, 3, 15, 3
CASES = ("VL", "VC-psi")


def problem():
    mags, errs, z = synthetic_sdss(N, filters=5, seed=1)
    tr, va, te = gpz_tpu.datautils.split(N, 0.6, 0.2, 0.2,
                                         np.random.default_rng(0))
    return mags, z, errs ** 2, tr, va, te


def kwargs(case):
    _, _, psi, tr, va, _ = problem()
    return dict(n_restarts=RESTARTS, training=tr, validation=va,
                psi=psi if case == "VC-psi" else None, max_iter=ITERS,
                seed=SEED, dtype="float64")


@pytest.fixture(scope="module", params=CASES)
def fitted(request):
    """(case, port's (model, info), gpz_tpu's (model, info))."""
    case = request.param
    X, Y = problem()[:2]
    method = case[:2]
    port = gpz_tpu_torch.fit_ensemble(X, Y, method, M, device="cpu",
                                      **kwargs(case))
    ref = jax_fit_ensemble(X, Y, method, M, **kwargs(case))
    return case, port, ref


def test_restart_scores_and_counts_equal_gpz_tpu(fitted):
    _, (model, info), (jmodel, jinfo) = fitted
    assert info is model.fit_info
    assert set(info) == set(jinfo)
    np.testing.assert_allclose(info["restart_scores"],
                               np.asarray(jinfo["restart_scores"]), **TRACE)
    assert info["best_restart"] == jinfo["best_restart"]
    assert info["best_restart"] == int(np.argmax(info["restart_scores"]))
    for key in ("iterations", "fun_evals"):
        assert info[key].shape == (RESTARTS,)
        np.testing.assert_array_equal(info[key], np.asarray(jinfo[key]))
    assert model.best.score == info["restart_scores"][info["best_restart"]]


def test_best_and_last_equal_gpz_tpu(fitted):
    case, (model, _), (jmodel, _) = fitted
    assert model.last.score == jmodel.last.score == -np.inf
    np.testing.assert_allclose(model.best.score, jmodel.best.score, **TRACE)
    for which in ("best", "last"):
        pset, jpset = getattr(model, which), getattr(jmodel, which)
        for f in FIELDS:
            np.testing.assert_allclose(
                getattr(pset.params, f).numpy(),
                np.asarray(getattr(jpset.params, f)), err_msg=f"{which}.{f}",
                **TRAINED)
    X, _, psi, _, _, te = problem()
    psi = psi[te] if case == "VC-psi" else None
    pred = gpz_tpu_torch.predict(X[te], model, psi=psi)
    jpred = gpz_tpu.predict(X[te], jmodel, psi=psi)
    for k in ("mu", "sigma", "nu", "beta_i", "gamma"):
        np.testing.assert_allclose(getattr(pred, k),
                                   np.asarray(getattr(jpred, k)), err_msg=k,
                                   **PREDICTED)


def test_mesh_raises_and_names_the_parallel_slice():
    """mesh takes a gpz_tpu_torch.parallel mesh; anything else raises and
    names it (the mesh itself: tests/test_torch_parallel_mesh.py)."""
    X, Y = problem()[:2]
    with pytest.raises(TypeError, match="parallel"):
        gpz_tpu_torch.fit_ensemble(X, Y, "VL", M, mesh=object(),
                                   device="cpu", **kwargs("VL"))


def test_default_device_is_the_gpu():
    """device=None is the CUDA device: without one fit_ensemble raises
    torch's error, and does not train on the CPU."""
    X, Y = problem()[:2]
    kw = dict(kwargs("VL"), n_restarts=1, max_iter=1)
    if torch.cuda.is_available():
        model, _ = gpz_tpu_torch.fit_ensemble(X, Y, "VL", M, **kw)
        assert model.best.params.P.device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        gpz_tpu_torch.fit_ensemble(X, Y, "VL", M, **kw)
