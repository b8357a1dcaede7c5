"""gpz_tpu's environment knobs and the last of its public names in
gpz_tpu_torch, each held to gpz_tpu under the same environment on the CPU.

predict's four sizes (GPZ_PAIR_BUDGET, GPZ_PAIR_BUDGET_MISSING,
GPZ_MIX_TOPL, GPZ_MIX_COVERAGE_MIN) are read when the module is imported, in
both packages, so a test sets them and reloads both predict modules (and
reloads them again after it, with the environment restored); the two dtypes
(GPZ_VARIANCE_DTYPE, GPZ_MIX_DTYPE) are read at each call. Each knob is
shown to change what the port does, and both packages then serve a small VC
model (init on 100 rows is host NumPy in both: the same parameters) on rows
with NaNs with the same results: MISSING_TOL's float64 bounds, or, where a
knob puts a chain in float32, tests/test_torch_predict_missing.py's MIX32
bounds (float32 rounding of sums of ~1). gpz_tpu's predict runs with a
fresh cache of jitted functions, so no trace taken under a knob outlives
the test. GPZ_PROFILE makes train write a torch.profiler trace;
zeros_like_params and __version__ are gpz_tpu's.
"""

import dataclasses
import glob
import importlib
import json

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import gpz_tpu
import gpz_tpu.model as jmodel
from gpz_tpu.params import zeros_like_params as jax_zeros_like_params

import gpz_tpu_torch
from gpz_tpu_torch.data import synthetic_sdss
from gpz_tpu_torch.params import FIELDS, zeros_like_params

from make_torch_port_golden import MISSING_TOL, OUTPUTS

jpredict = importlib.import_module("gpz_tpu.predict")
tpredict = importlib.import_module("gpz_tpu_torch.predict")

M, TRAIN_ROWS, SERVED_ROWS = 8, 100, 60
MIX32 = dict(rtol=1e-4, atol=1e-5)

#: the knobs read at import: (env, module attribute, a value to set)
SIZES = (("GPZ_PAIR_BUDGET", "PAIR_BUDGET", "4321"),
         ("GPZ_PAIR_BUDGET_MISSING", "MISSING_PAIR_BUDGET", "765"),
         ("GPZ_MIX_TOPL", "MIX_TOPL", "3"),
         ("GPZ_MIX_COVERAGE_MIN", "MIX_COVERAGE_MIN", "0.25"))


@pytest.fixture
def env(monkeypatch):
    """set(**vars): the variables set and both predict modules reloaded;
    after the test, the environment restored and both reloaded again."""
    def set_(**names):
        for k, v in names.items():
            monkeypatch.setenv(k, v)
        importlib.reload(jpredict)
        importlib.reload(tpredict)

    monkeypatch.delenv("GPZ_MIX_DTYPE", raising=False)
    monkeypatch.delenv("GPZ_VARIANCE_DTYPE", raising=False)
    yield set_
    monkeypatch.undo()
    importlib.reload(jpredict)
    importlib.reload(tpredict)


@pytest.fixture(scope="module")
def models():
    """(gpz_tpu's, the port's) VC m=8 model at its init point, psi (n, d,
    d), and rows to serve: every other one without band 0."""
    mags, errs, z = synthetic_sdss(n=TRAIN_ROWS + SERVED_ROWS, filters=5,
                                   seed=4)
    psi = np.einsum("ni,ij->nij", errs ** 2, np.eye(5))
    tr = slice(0, TRAIN_ROWS)
    kw = dict(psi=psi[tr], seed=1, dtype="float64")
    jm = gpz_tpu.init(mags[tr], z[tr], "VC", M, **kw)
    tm = gpz_tpu_torch.init(mags[tr], z[tr], "VC", M, device="cpu", **kw)
    X = mags[TRAIN_ROWS:].copy()
    X[::2, 0] = np.nan
    return jm, tm, X, psi[TRAIN_ROWS:]


def serve_both(models, monkeypatch):
    """(gpz_tpu's, the port's) predictions and the port's calls of the
    design-matrix function (dtype, rows, bases) and of the moments with
    their mixture width."""
    jm, _, X, psi = models
    monkeypatch.setattr(jmodel, "_PREDICT_FN_CACHE", {})
    return (gpz_tpu.predict(X, jm, psi=psi),
            *serve_port(models, monkeypatch))


def serve_port(models, monkeypatch):
    """The port's prediction, its calls of the design-matrix function
    (dtype, rows, bases) and of the moments (mixture width, coverage)."""
    _, tm, X, psi = models
    calls, widths = [], []
    real_phi, real_moments = (tpredict.vc_lnphi_complete,
                              tpredict.predict_moments_full)

    def phi(*a):
        calls.append((a[0].dtype, a[0].shape[0], a[2].shape[0]))
        return real_phi(*a)

    def moments(*a, **kw):
        widths.append((kw.get("mix_topl"), kw.get("return_coverage")))
        return real_moments(*a, **kw)

    monkeypatch.setattr(tpredict, "vc_lnphi_complete", phi)
    monkeypatch.setattr(tpredict, "predict_moments_full", moments)
    got = gpz_tpu_torch.predict(X, tm, psi=psi)
    monkeypatch.setattr(tpredict, "vc_lnphi_complete", real_phi)
    monkeypatch.setattr(tpredict, "predict_moments_full", real_moments)
    return got, calls, widths


def assert_same(got, want, tol=None):
    for k in OUTPUTS:
        a, b = getattr(got, k), np.asarray(getattr(want, k))
        assert np.isfinite(a).all(), k
        rtol, atol = (tol["rtol"], tol["atol"]) if tol else MISSING_TOL[
            "float64"][k]
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name,attr,value", SIZES, ids=[s[0] for s in SIZES])
def test_size_is_read_at_import_as_gpz_tpu_reads_it(env, name, attr, value):
    env(**{name: value})
    want = type(getattr(tpredict, attr))(value)
    assert getattr(tpredict, attr) == getattr(jpredict, attr) == want


def test_ports_defaults(env):
    """The port's own defaults (ROADMAP: deliberate differences): larger
    budgets for the card's memory, float64 mixture sums."""
    env()
    assert (tpredict.PAIR_BUDGET, tpredict.MISSING_PAIR_BUDGET,
            tpredict.MIX_TOPL, tpredict.MIX_COVERAGE_MIN) == (
                10**8, 3 * 10**7, 64, 0.999999)
    assert tpredict.variance_dtype() == torch.float64
    assert tpredict.mix_dtype() == torch.float64


@pytest.mark.parametrize("name", ["GPZ_VARIANCE_DTYPE", "GPZ_MIX_DTYPE"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dtype_is_read_at_call_as_gpz_tpu_reads_it(env, monkeypatch, name,
                                                   dtype):
    env()
    monkeypatch.setenv(name, dtype)
    fn = "variance_dtype" if name == "GPZ_VARIANCE_DTYPE" else "mix_dtype"
    assert getattr(tpredict, fn)() == getattr(torch, dtype)
    assert getattr(jpredict, fn)().name == dtype


def test_sizes_held_to_jax(env, models, monkeypatch):
    """The four sizes at once: the top 3 of 8 components with no escalation
    (coverage floor 0), and budgets of a few hundred elements (one basis
    index per pair block, one component per mixture launch). The port runs
    the guard, never the exact sum, and more, smaller launches; both
    packages serve the same truncated mixture, which differs from the
    exact one."""
    env(GPZ_MIX_DTYPE="float64", GPZ_MIX_TOPL=str(M))
    exact, calls0, _ = serve_port(models, monkeypatch)
    env(GPZ_MIX_TOPL="3", GPZ_MIX_COVERAGE_MIN="0", GPZ_PAIR_BUDGET="400",
        GPZ_PAIR_BUDGET_MISSING="200")
    want, got, calls, widths = serve_both(models, monkeypatch)
    assert (None, True) in widths and all(w != M for w, _ in widths)
    assert max(b for _, _, b in calls0) == M * M
    assert max(b for _, _, b in calls) == M
    assert len(calls) > 2 * len(calls0)
    assert_same(got, want)
    assert not np.array_equal(exact.mu, got.mu)


def test_float32_chains_held_to_jax(env, models, monkeypatch):
    env(GPZ_VARIANCE_DTYPE="float32", GPZ_MIX_DTYPE="float32")
    want, got, calls, _ = serve_both(models, monkeypatch)
    assert {dt for dt, _, _ in calls} == {torch.float32}
    assert_same(got, want, MIX32)


def test_mix_dtype_float32_leaves_the_variance_chain(env, models,
                                                     monkeypatch):
    """GPZ_MIX_DTYPE=float32 alone: the mixture sums' launches in float32,
    the complete rows' sites in the variance chain's float64."""
    env(GPZ_MIX_DTYPE="float32")
    _, calls, _ = serve_port(models, monkeypatch)
    assert {dt for dt, _, _ in calls} == {torch.float32, torch.float64}


def test_mix_topl_at_m_equals_the_escalated_sum(env, models):
    """GPZ_MIX_TOPL >= m serves the exact mixture with no guard; a top-3 run
    whose every batch escalates (coverage floor 1) gives the same bits."""
    _, tm, X, psi = models
    env(GPZ_MIX_TOPL=str(M))
    exact = gpz_tpu_torch.predict(X, tm, psi=psi)
    env(GPZ_MIX_TOPL="3", GPZ_MIX_COVERAGE_MIN="1.0")
    escalated = gpz_tpu_torch.predict(X, tm, psi=psi)
    for k in OUTPUTS + ("phi",):
        np.testing.assert_array_equal(getattr(exact, k),
                                      getattr(escalated, k), err_msg=k)


def test_gpz_profile_writes_a_trace(models, monkeypatch, tmp_path):
    """The trace covers the whole of train (its data, the L-BFGS phases and
    both resolves) and carries the program's spans; any profiler session,
    an operator's around predict too, turns the spans on."""
    jm, tm, X, psi_s = models
    mags, errs, z = synthetic_sdss(n=TRAIN_ROWS, filters=5, seed=4)
    psi = np.einsum("ni,ij->nij", errs ** 2, np.eye(5))
    monkeypatch.setenv("GPZ_PROFILE", str(tmp_path))
    fit = gpz_tpu_torch.train(tm, mags, z, psi=psi, max_iter=1,
                              verbose=False).fit_info
    assert fit["iterations"] == 1
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("vc_lnphi" in str(e.get("name", "")) or
               "aten::" in str(e.get("name", "")) for e in events)
    names = {str(e.get("name", "")) for e in events}
    assert {"gpz.train", "gpz.train.data", "gpz.train.minimize",
            "gpz.lbfgs.eval", "gpz.train.resolve", "gpz.posterior",
            "gpz.prior.em"} <= names
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gpz_tpu_torch.predict(X, tm, psi=psi_s)
    served = tmp_path / "predict.json"
    prof.export_chrome_trace(str(served))
    with open(served) as fh:
        names = {str(e.get("name", "")) for e in json.load(fh)["traceEvents"]}
    assert {"gpz.predict", "gpz.predict.batch", "gpz.predict.moments",
            "gpz.predict.readback"} <= names


@pytest.mark.parametrize("hetero", [True, False], ids=["hetero", "homo"])
def test_zeros_like_params_matches_jax(models, hetero):
    jm, tm, _, _ = models
    jp, tp = jm.last.params, tm.last.params
    if not hetero:
        jp = dataclasses.replace(jp, v=None, ln_tau=None)
        tp = dataclasses.replace(tp, v=None, ln_tau=None)
    got, want = zeros_like_params(tp), jax_zeros_like_params(jp)
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == getattr(tp, f).dtype
            assert tuple(a.shape) == b.shape
            assert not a.any() and not np.asarray(b).any()


def test_version_is_gpz_tpus():
    assert gpz_tpu_torch.__version__ == gpz_tpu.__version__
