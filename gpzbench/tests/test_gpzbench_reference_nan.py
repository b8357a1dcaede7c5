"""The NaN-aware plain reference (reference/gpz_nan.py) agrees with
gpz_tpu_torch on the CPU at a tiny size: nine bands, rows that lack u,
Ks, both or neither, m = 8. Init, the objective's value and gradient, the
optimizer's first steps, and the pattern-by-pattern design matrix against
the program's masked pass at d = 5 and d = 9; and the reference loads
neither the program nor JAX."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from gpzbench import data, harness
from gpzbench.reference import gpz_nan, lbfgs as ref_lbfgs
from gpzbench.reference.gpz import LEAVES

SEED = 2**31 + 4_242
M = 8
MISSING = {"first": 0.25, "last": 0.10, "both": 0.05}
f64 = torch.float64


def _problem(d):
    cfg = {"n_train": 300, "n_valid": 100, "d": d}
    X, Y, psi, tr, va = data.training_problem(cfg, SEED)
    return data.inject_missing(X, MISSING, data.rng_for(SEED, 5)), Y, psi, \
        tr, va


@pytest.fixture(scope="module")
def nine():
    import gpz_tpu_torch as g

    X, Y, psi, tr, va = _problem(9)
    model0 = g.init(X, Y, "VC", M, heteroscedastic=True, training=tr,
                    psi=psi, seed=11, dtype="float64", device="cpu")
    return X, Y, psi, tr, va, model0


def _program_data(model, X, Y, psi, rows):
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch import model as gm

    Xn = (X - model.muX) / model.sdX
    psi_c = datautils.fix_psi(psi, len(X), model.sdX, True)
    return gm._make_dataset(Xn, Y[:, None] - model.muY, psi_c,
                            np.ones(len(X)), rows, f64, "cpu")


def test_every_pattern_is_there(nine):
    X, _, _, tr, va, _ = nine
    for rows in (tr, va):
        nan = np.isnan(X[rows])
        assert not nan[:, 1:8].any()
        pats = {(bool(a), bool(b)) for a, b in zip(nan[:, 0], nan[:, 8])}
        assert pats == {(False, False), (True, False), (False, True),
                        (True, True)}
    assert len(gpz_nan.patterns(X[tr])) == 4


def test_init(nine):
    X, Y, psi, tr, _, model0 = nine
    p_ref, (muX, sdX, muY) = gpz_nan.init_vc(X, Y, psi, tr, M, 11, "cpu")
    got = model0.last.params.to_numpy()
    for leaf in LEAVES:
        np.testing.assert_allclose(got[leaf], p_ref[leaf], rtol=1e-12,
                                   atol=1e-14)
    np.testing.assert_allclose(model0.muX, muX, rtol=1e-14)
    np.testing.assert_allclose(model0.sdX, sdX, rtol=1e-14)
    np.testing.assert_allclose(model0.muY, muY, rtol=1e-14)


def test_objective_and_first_steps(nine):
    import gpz_tpu_torch as g
    from gpz_tpu_torch import model as gm

    X, Y, psi, tr, va, model0 = nine
    _, stats = gpz_nan.init_vc(X, Y, psi, tr, M, 11, "cpu")
    prob = gpz_nan.Problem(X, Y, psi, tr, stats, "cpu")
    x0 = torch.as_tensor(gpz_nan.flatten(model0.last.params.to_numpy()),
                         dtype=f64)
    f, grad = gpz_nan.nlml_grad(x0, prob, M, 9, 1)
    flat, unravel = model0.last.params.flatten()
    data_tr = _program_data(model0, X, Y, psi, tr)
    assert not bool(data_tr.mask.all())
    cfg64 = dataclasses.replace(model0.cfg, dtype="float64")
    fp, gp, _ = gm._objective(unravel, data_tr, cfg64, False)(flat)
    assert abs(float(fp) - f) <= 1e-12 * abs(f)
    assert float((gp - grad).abs().max()) <= 1e-10 * float(grad.abs().max())
    xs, fs, _, _ = ref_lbfgs.minimize(
        lambda x: gpz_nan.nlml_grad(x, prob, M, 9, 1), x0, 3)
    fit = g.train(model0, X, Y, training=tr, validation=va, psi=psi,
                  max_iter=3, verbose=False)
    assert fit.fit_info["iterations"] == 3
    np.testing.assert_allclose(fit.fit_info["trace"]["f"], fs, rtol=1e-10)
    np.testing.assert_allclose(gpz_nan.flatten(fit.last.params.to_numpy()),
                               xs[-1].numpy(), rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("d", [5, 9])
def test_design_matrix_by_patterns(d):
    """gpz_nan's lnPHI, each pattern's Gaussian over its observed bands,
    against phi.log_phi's masked pass (the observed block embedded in
    full size), at parameters with full covariances."""
    import gpz_tpu_torch as g
    from gpz_tpu_torch import phi
    from gpz_tpu_torch.params import GPzParams

    X, Y, psi, tr, _ = _problem(d)
    model0 = g.init(X, Y, "VC", M, heteroscedastic=True, training=tr,
                    psi=psi, seed=5, dtype="float64", device="cpu")
    rng = np.random.default_rng(d)
    arrays = model0.last.params.to_numpy()
    # off-diagonals of a third of the diagonal: full covariances of
    # condition ~10-100, where the two routes agree to ~1e-14
    g0 = arrays["gamma"][:, :1, :1]
    arrays["gamma"] = arrays["gamma"] + np.tril(
        rng.standard_normal((M, d, d)), -1) * g0 / 3
    params = GPzParams.from_numpy(arrays, "cpu", f64)
    dset = _program_data(model0, X, Y, psi, tr)
    got = phi.log_phi(params, model0.cfg, dset.X, dset.mask, dset.psi)[0]
    prob = gpz_nan.Problem(X, Y, psi, tr,
                           (model0.muX, model0.sdX, model0.muY), "cpu")
    want = gpz_nan.log_design({k: torch.as_tensor(v, dtype=f64)
                               for k, v in arrays.items()}, prob)
    assert len(prob.groups) == 4
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-11,
                               atol=1e-11)


def test_loads_neither_the_program_nor_jax():
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r}); "
            "import gpzbench.reference.gpz_nan; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax') "
            "or m.split('.')[0].startswith('gpz_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
