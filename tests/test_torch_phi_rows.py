"""The design matrix's row counters and its masked span
(gpz_tpu_torch.phi._log_phi_full): `phi.rows_total` counts the rows of
every call on every branch, `phi.rows_masked` the rows that take the
masked pass, and the span `gpz.phi.masked` (rows, blocks, d) is recorded
once a call, only while a profiler runs, without changing a bit of the
outputs. At d = 5 (the unrolled solves) and d = 9 (torch.linalg's, past
linalg's unroll_max), in one row block and in several.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gpz_tpu_torch import phi, trace
from gpz_tpu_torch.config import ModelConfig
from gpz_tpu_torch.params import GPzParams

N, M = 40, 6


def _case(d, nan=True):
    """VC parameters, inputs with a NaN in a third of the rows (or none),
    their mask and a full (n, d, d) psi."""
    rng = np.random.default_rng(d)
    cfg = ModelConfig(m=M, d=d, method="VC", dtype="float64")
    A = rng.standard_normal((M, d, d)) * 0.2
    params = GPzParams.from_numpy({
        "P": rng.standard_normal((M, d)),
        "gamma": np.eye(d)[None] * 1.5 + np.tril(A),
        "ln_alpha": np.zeros((M, 1)), "b": np.zeros(1),
        "v": np.zeros((M, 1)), "ln_tau": np.zeros((M, 1))},
        "cpu", torch.float64)
    X = rng.standard_normal((N, d))
    if nan:
        X[::3, 0] = np.nan
        X[1::6, d - 1] = np.nan
    mask = ~np.isnan(X)
    B = rng.standard_normal((N, d, d)) * 0.1
    psi = np.einsum("nab,ncb->nac", B, B) + 0.01 * np.eye(d)
    return (params, cfg, torch.tensor(np.where(mask, X, 0.0)),
            torch.tensor(mask), torch.tensor(psi))


def _counts():
    return (trace.COUNTS.get("phi.rows_masked", 0),
            trace.COUNTS.get("phi.rows_total", 0))


@pytest.fixture(params=[None, 16], ids=["one_block", "blocks"])
def block(request, monkeypatch):
    if request.param is not None:
        monkeypatch.setattr(phi, "PHI_BLOCK_ROWS", request.param)
    return phi.PHI_BLOCK_ROWS


@pytest.mark.parametrize("d", [5, 9])
def test_masked_rows_are_counted(d, block):
    params, cfg, X, mask, psi = _case(d)
    for calls in (1, 2):
        before = _counts()
        for _ in range(calls):
            phi.log_phi(params, cfg, X, mask, psi)
        after = _counts()
        assert (after[0] - before[0], after[1] - before[1]) == (
            calls * N, calls * N)


@pytest.mark.parametrize("d", [5, 9])
def test_complete_rows_count_none_masked(d):
    params, cfg, X, mask, psi = _case(d, nan=False)
    for p in (psi, None):
        before = _counts()
        phi.log_phi(params, cfg, X, mask, p, complete=True)
        after = _counts()
        assert (after[0] - before[0], after[1] - before[1]) == (0, N)


@pytest.mark.parametrize("d", [5, 9])
def test_backward_recompute_counts_nothing(d, block):
    """The checkpointed blocks run again in the backward; the counters
    count the call, not the recompute."""
    params, cfg, X, mask, psi = _case(d)
    params.P.requires_grad_(True)
    params.gamma.requires_grad_(True)
    ln_phi, ln_n = phi.log_phi(params, cfg, X, mask, psi)
    before = _counts()
    (ln_phi.sum() + ln_n.sum()).backward()
    assert _counts() == before
    assert torch.isfinite(params.gamma.grad).all()
    assert torch.isfinite(params.P.grad).all()


@pytest.mark.parametrize("d", [5, 9])
def test_bits_equal_with_and_without_a_profiler(d, block):
    params, cfg, X, mask, psi = _case(d)
    off = phi.log_phi(params, cfg, X, mask, psi)
    with profile(activities=[ProfilerActivity.CPU]):
        on = phi.log_phi(params, cfg, X, mask, psi)
    trace.reset()
    for a, b in zip(off, on):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [5, 9])
def test_masked_span_only_under_a_profiler(d, block):
    params, cfg, X, mask, psi = _case(d)
    trace.reset()
    phi.log_phi(params, cfg, X, mask, psi)
    assert not [r for r in trace.records() if r["name"] == "gpz.phi.masked"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        phi.log_phi(params, cfg, X, mask, psi)
        phi.log_phi(params, cfg, X, torch.ones_like(mask), psi,
                    complete=True)
    spans = [r for r in trace.records() if r["name"] == "gpz.phi.masked"]
    trace.reset()
    assert len(spans) == 1
    assert spans[0]["attrs"] == {"rows": N, "blocks": -(-N // block),
                                 "d": d}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "gpz.phi.masked" in names
