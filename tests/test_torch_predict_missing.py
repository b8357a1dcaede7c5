"""gpz_tpu_torch.predict.predict_moments_full on rows with missing values
against gpz_tpu's, called directly (not through gpz_tpu's jitted
model.predict), on the CPU: conditional imputation, top-L truncation with its
coverage, the two mixture sums through vc_lnphi_complete's plain version, and
model.predict's coverage guard.

Tolerances. With gpz_tpu's mixture scans in float64 (GPZ_MIX_DTYPE=float64)
both sides run one float64 chain on a well-conditioned random model and differ
in summation order only: 1e-10 relative, 1e-12 absolute (nu and gamma are
differences of sums of order 1). Against gpz_tpu's float32 default the
mixture sums carry float32's ~1e-6 relative error into PHI and the pair
expectations; nu and gamma then differ by ~1e-6 of sums of order 1: 1e-4
relative, 1e-5 absolute.
"""

import importlib

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax.numpy as jnp
import pytest
import torch

import gpz_tpu
from gpz_tpu.config import ModelConfig as JaxConfig

import gpz_tpu_torch
from gpz_tpu_torch import datautils
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.ops import vc_phi

from make_torch_port_golden import CHECKPOINT, golden_rows
from test_torch_predict_diag import as_models, assert_outputs, both_sides

jpredict = importlib.import_module("gpz_tpu.predict")
tpredict = importlib.import_module("gpz_tpu_torch.predict")

F64 = dict(rtol=1e-10, atol=1e-12)
MIX32 = dict(rtol=1e-4, atol=1e-5)
M, D, N = 12, 4, 16
PATTERNS = {
    "one-missing": [True, False, True, True],
    "two-missing": [False, True, True, False],
    "one-observed": [False, False, True, False],
    "none-observed": [False, False, False, False],
    "all-observed": [True, True, True, True],
}


def small_model(method="VC", seed=0, k=1, spread=1.0):
    """Arrays of a random full-covariance model; `spread` scales the centers
    (0: every basis in one place, so responsibilities follow the priors)."""
    rng = np.random.default_rng(seed)
    cfg = dict(m=M, d=D, k=k, method=method, dtype="float64")
    gm = 1 if method == "GC" else M
    arrays = {
        "P": rng.standard_normal((M, D)) * spread,
        "gamma": np.eye(D) * rng.uniform(0.5, 1.5, (gm, 1, 1))
        + 0.1 * rng.standard_normal((gm, D, D)),
        "ln_alpha": rng.standard_normal((M, k)),
        "b": rng.standard_normal(k) * 0.1 - 3.0,
        "v": rng.standard_normal((M, k)) * 0.1,
        "ln_tau": np.zeros((M, k)),
    }
    Q = rng.standard_normal((k, M, M))
    post = {"w": rng.standard_normal((M, k)),
            "iSigma_w": Q @ np.swapaxes(Q, 1, 2) / M + 0.1 * np.eye(M),
            "logdet": np.zeros(k)}
    priors = rng.dirichlet(np.ones(M))
    return arrays, post, priors, cfg


def rows(seed, with_psi, pattern, n=N):
    rng = np.random.default_rng(seed)
    mask = np.asarray(pattern, bool)
    X = rng.standard_normal((n, D)) * mask[None, :]
    psi = np.zeros((n, D, D))
    if with_psi:
        A = rng.standard_normal((n, D, D)) * 0.2
        psi = A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)
    return X, psi, mask


def port(model, X, psi, mask, complete=False, **kw):
    _, (tp, tpost, tpri, tcfg) = both_sides(*model)
    return tpredict.predict_moments_full(
        tp, tpost, tpri, tcfg, torch.from_numpy(X), torch.from_numpy(mask),
        torch.from_numpy(psi), complete, **kw)


def jax(model, X, psi, mask, complete=False, **kw):
    (jp, jpost, jpri, jcfg), _ = both_sides(*model)
    return jpredict.predict_moments_full(
        jp, jpost, jpri, jcfg, jnp.asarray(X), jnp.asarray(mask),
        jnp.asarray(psi), complete, **kw)


@pytest.fixture
def jax_mix64(monkeypatch):
    monkeypatch.setenv("GPZ_MIX_DTYPE", "float64")


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
@pytest.mark.parametrize("pattern", list(PATTERNS))
def test_missing_branch_matches_jax(pattern, with_psi, jax_mix64):
    """Every pattern through the missing branch (complete=False), the pattern
    with nothing observed and the one with nothing missing included."""
    model = small_model("VC", 1)
    data = rows(2, with_psi, PATTERNS[pattern])
    got = port(model, *data, return_coverage=True)
    want = jax(model, *data, return_coverage=True)
    assert got[0].shape == (N, 1) and got[4].shape == (N, M)
    assert float(got[5]) == 1.0
    assert_outputs(got, want)


def test_gc_two_outputs_homoscedastic_matches_jax(jax_mix64):
    arrays, post, priors, cfg = small_model("GC", 3, k=2)
    del arrays["v"], arrays["ln_tau"]
    cfg["heteroscedastic"] = False
    data = rows(4, True, PATTERNS["two-missing"])
    assert_outputs(port((arrays, post, priors, cfg), *data),
                   jax((arrays, post, priors, cfg), *data))


def test_jaxs_float32_mixture_default_is_close():
    """gpz_tpu's default runs the mixture scans in float32; the port's
    float64 sums are within float32's reach of it, and its own float32
    setting (GPZ_MIX_DTYPE) is as close to the float64 one."""
    model, data = small_model("VC", 5), rows(6, True, PATTERNS["one-missing"])
    got = port(model, *data)
    assert_outputs(got, jax(model, *data), **MIX32)


def test_mix_dtype_float32_is_selectable(monkeypatch):
    model, data = small_model("VC", 5), rows(6, True, PATTERNS["one-missing"])
    want = port(model, *data)
    seen = []
    real = tpredict.vc_lnphi_complete
    monkeypatch.setenv("GPZ_MIX_DTYPE", "float32")
    monkeypatch.setattr(
        tpredict, "vc_lnphi_complete",
        lambda *a: (seen.append(a[0].dtype), real(*a))[1])
    got = port(model, *data)
    assert set(seen) == {torch.float32}
    assert all(g.dtype == torch.float64 for g in got)
    assert_outputs(got, want, **MIX32)


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
def test_nothing_missing_collapses_to_the_complete_branch(with_psi):
    """An all-True mask through the missing branch: X_hat = x, Psi_hat = psi
    for every component, the responsibilities sum to 1, and the result is the
    complete branch's (and predict_clean's when psi == 0). Different algebra
    on the way (masked embeddings, the precision-form conditional): 1e-9."""
    model = small_model("VC", 7)
    data = rows(8, with_psi, PATTERNS["all-observed"])
    tol = dict(rtol=1e-9, atol=1e-11)
    mixed = port(model, *data, complete=False)
    assert_outputs(mixed, port(model, *data, complete=True), **tol)
    if not with_psi:
        _, (tp, tpost, _, tcfg) = both_sides(*model)
        Xt = torch.from_numpy(data[0])
        clean = tpredict.predict_clean(tp, tpost, tcfg, Xt,
                                       torch.ones_like(Xt, dtype=torch.bool))
        assert_outputs(mixed, clean, **tol)


def test_many_blocks_and_launches_give_one_blocks_result(monkeypatch,
                                                         jax_mix64):
    """MISSING_PAIR_BUDGET = 800 f32 elements gives B = 2 at n=16, m=12 in
    float64: six pair blocks with one component per vc_lnphi_complete call
    (gpz_tpu's scan order) and two components per call at the PHI site; the
    default takes all twelve components in one call at both sites. Same
    terms, another order."""
    model, data = small_model("VC", 9), rows(10, True, PATTERNS["two-missing"])
    calls = []
    real = tpredict.vc_lnphi_complete
    monkeypatch.setattr(
        tpredict, "vc_lnphi_complete",
        lambda *a: (calls.append((a[0].shape[0], a[2].shape[0])),
                    real(*a))[1])
    one = port(model, *data)
    assert calls == [(M * N, M), (M * N, M * M)]
    del calls[:]
    monkeypatch.setattr(tpredict, "MISSING_PAIR_BUDGET", 800)
    assert tpredict._block_size(N, M, 1, 800, itemsize=8) == 2
    many = port(model, *data)
    assert calls == [(2 * N, M)] * (M // 2) + [(N, 2 * M)] * (M * 6)
    assert_outputs(many, one, rtol=1e-12, atol=1e-14)
    monkeypatch.setattr(jpredict, "MISSING_PAIR_BUDGET", 800 * D * D)
    assert_outputs(many, jax(model, *data))


def test_truncation_matches_jax_and_reports_its_coverage(jax_mix64):
    """mix_topl = 4 of 12 components. The responsibilities of a random model
    are distinct, so torch.topk and jax.lax.top_k keep the same components;
    the coverage is the least kept mass of any row."""
    model, data = small_model("VC", 11), rows(12, True,
                                              PATTERNS["one-missing"])
    got = port(model, *data, mix_topl=4, return_coverage=True)
    want = jax(model, *data, mix_topl=4, return_coverage=True)
    assert_outputs(got, want)
    assert 0.0 < float(got[5]) < 1.0
    exact = port(model, *data, mix_topl=M)
    assert np.abs(np.asarray(got[4]) - np.asarray(exact[4])).max() > 1e-9


@pytest.mark.parametrize("topl", [M, M + 5, None], ids=["m", "above", "none"])
def test_topl_at_least_m_is_the_exact_sum(topl, monkeypatch):
    """L >= m (given, or the module's MIX_TOPL = 64 > 12) takes no top-k at
    all: equal results, coverage exactly 1."""
    model, data = small_model("VC", 13), rows(14, True,
                                              PATTERNS["two-missing"])
    monkeypatch.setattr(
        torch, "topk", lambda *a, **k: pytest.fail("top-k with L >= m"))
    got = port(model, *data, mix_topl=topl, return_coverage=True)
    want = port(model, *data, mix_topl=M)
    assert float(got[5]) == 1.0
    assert_outputs(got[:5], want, rtol=0, atol=0)


def test_log_priors_floor_is_taken_after_the_upcast():
    """Priors stored in float32 collapse to exactly 0 on trained models; the
    floor is float64's tiny (log ~ -708), as in gpz_tpu, not float32's
    (~ -87): the logits would differ by hundreds of nats."""
    pri32 = torch.tensor([0.0, 1e-30, 0.25], dtype=torch.float32)
    got = tpredict._log_priors(pri32.to(torch.float64)).numpy()
    want = np.asarray(jpredict._log_priors(
        jnp.asarray(pri32.numpy()).astype(jnp.float64)))
    np.testing.assert_allclose(got, want, rtol=1e-15)
    assert got[0] < -700
    # and through the function: a model whose priors are mostly exactly 0
    arrays, post, priors, cfg = small_model("VC", 15)
    priors = np.where(np.arange(M) < 3, priors, 0.0).astype(np.float32)
    priors = (priors / priors.sum()).astype(np.float64)
    data = rows(16, True, PATTERNS["one-missing"])
    got = port((arrays, post, priors, cfg), *data)
    assert all(torch.isfinite(g).all() for g in got)


def mixed_rows(rng, n=24):
    X = rng.standard_normal((n, D)) * 1.5
    X[::3, 1] = np.nan
    X[1::4, 0] = np.nan
    X[5::7, 3] = np.nan
    X[7] = np.nan
    A = rng.standard_normal((n, D, D)) * 0.2
    return X, A @ np.swapaxes(A, 1, 2) + 0.05 * np.eye(D)


@pytest.mark.parametrize("with_psi", [False, True], ids=["nopsi", "psi"])
def test_model_predict_with_nans_matches_jax(with_psi, jax_mix64):
    """model.predict on rows of several patterns (one with nothing observed):
    m = 12 <= MIX_TOPL, so no guard and the exact mixture on both sides."""
    rng = np.random.default_rng(17)
    jm, tm = as_models(*small_model("VC", 18), muX=rng.standard_normal(D),
                       sdX=0.5 + rng.random(D), muY=np.array([0.3]))
    X, psi = mixed_rows(rng)
    psi = psi if with_psi else None
    want = gpz_tpu.predict(X, jm, psi=psi)
    got = gpz_tpu_torch.predict(X, tm, psi=psi)
    for key in ("mu", "sigma", "nu", "beta_i", "gamma", "phi"):
        np.testing.assert_allclose(getattr(got, key),
                                   np.asarray(getattr(want, key)),
                                   err_msg=key, **F64)
    assert np.isfinite(got.sigma).all() and (got.sigma > 0).all()


@pytest.mark.parametrize("flat", [True, False], ids=["flat", "peaked"])
def test_guard_escalates_flat_responsibilities(flat, monkeypatch):
    """With MIX_TOPL = 4 < m model.predict guards every batch of the missing
    path. Equal bases with equal priors give flat responsibilities
    (top-4 mass 1/3): the batch is run again with mix_topl = m and the result
    is the exact one. Well-separated narrow bases keep the mass in the top 4:
    no second run."""
    monkeypatch.setattr(tpredict, "MIX_TOPL", 4)
    arrays, post, priors, cfg = small_model("VC", 19,
                                            spread=0.0 if flat else 6.0)
    if flat:
        priors = np.full(M, 1.0 / M)
        arrays["gamma"] = np.repeat(arrays["gamma"][:1], M, axis=0)
    else:
        arrays["gamma"] = arrays["gamma"] * 6.0
    rng = np.random.default_rng(20)
    _, tm = as_models(arrays, post, priors, cfg, muX=np.zeros(D),
                      sdX=np.ones(D), muY=np.zeros(1))
    centers = arrays["P"][rng.integers(0, M, 10)]
    X = centers + 0.05 * rng.standard_normal((10, D))
    X[:, 2] = np.nan
    calls = []
    real = tpredict.predict_moments_full

    def record(*a, **kw):
        out = real(*a, **kw)
        calls.append((kw.get("mix_topl"), float(out[5])
                      if kw.get("return_coverage") else None))
        return out

    monkeypatch.setattr(tpredict, "predict_moments_full", record)
    got = gpz_tpu_torch.predict(X, tm)
    if flat:
        assert [c[0] for c in calls] == [None, M]
        assert calls[0][1] == pytest.approx(4.0 / M, rel=1e-6)
    else:
        assert [c[0] for c in calls] == [None]
        assert calls[0][1] >= tpredict.MIX_COVERAGE_MIN
    monkeypatch.setattr(tpredict, "MIX_TOPL", 64)
    exact = gpz_tpu_torch.predict(X, tm)
    tol = dict(rtol=0, atol=0) if flat else dict(rtol=1e-5, atol=1e-9)
    for key in ("mu", "sigma", "gamma", "phi"):
        np.testing.assert_allclose(getattr(got, key), getattr(exact, key),
                                   err_msg=key, **tol)


def test_trained_checkpoint_with_missing_bands_is_finite(monkeypatch):
    """The trained photo-z model (VC, m=100, d=5, float32 parameters, most
    priors exactly 0, Sigma's eigenvalues up to ~1e9): eight rows of four
    patterns come out finite with positive variances, through the guard
    (m > MIX_TOPL), and the float64 model agrees with the float32 one as far
    as float32 contractions allow (cf. tests/test_predict_cov.py's finiteness
    check at trained scales)."""
    _, X, psi, _ = golden_rows(synthetic_sdss, datautils.split)
    X, psi = X[:8].copy(), psi[:8]
    X[0:2, 0] = np.nan
    X[2:4, 4] = np.nan
    X[4:6, [0, 4]] = np.nan
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu")
    monkeypatch.setattr(vc_phi, "LAUNCHES_FWD", 0)
    p32 = gpz_tpu_torch.predict(X, model, psi=psi)
    p64 = gpz_tpu_torch.predict(X, model.astype("float64"), psi=psi)
    assert vc_phi.LAUNCHES_FWD == 0  # CPU tensors: the plain version
    for pred in (p32, p64):
        for key in ("mu", "sigma", "nu", "beta_i", "gamma", "phi"):
            assert np.isfinite(getattr(pred, key)).all(), key
        assert (pred.sigma > 0).all() and (pred.nu >= 0).all()
        assert (pred.gamma >= 0).all()
    np.testing.assert_allclose(p32.mu, p64.mu, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(p32.sigma, p64.sigma, rtol=1e-2, atol=1e-5)
