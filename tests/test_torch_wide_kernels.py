"""The wide kernel pair of gpz_tpu_torch (csrc/vc_phi.cu past d = 8) on the
CPU, where no CUDA kernel runs: the group kernels' order of operations
transcribed in torch and held to the plain twins and to JAX's dense
reference at d = 13 and 16 (tests/test_torch_wide_build.py takes d = 32).

The group kernels (vc_lnphi_{fwd,bwd}_group_kernel: the forward past d =
18, the backward past 13, to d = 32; the arithmetic does not depend on the
group's width, so d = 13 and 16 describe both widths) factor a
pair right-looking, lane r holding row r: each entry of L takes its updates
in the templates' order, so their forward is the templates' arithmetic up
to the log-product (the exponent split after every second factor in both
types, and once more before the logarithm). Their backward differs from the
templates': L^-1 is built in place row by row, h = L^-T z is read off
L^-1's columns instead of a back substitution, and A^-1's upper triangle
comes from L^-1's columns in the templates' order. Tolerances as
chip_smoke.py holds the kernels on the card: KERNEL_TOL (rtol, atol on
lnPHI) float64 (1e-8, 1e-10), float32 (1e-4, 1e-5); KERNEL_BWD_TOL
(against each output's largest entry) float64 (1e-7, 1e-9), float32 (2e-3,
2e-4).
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

import chip_smoke
from gpz_tpu_torch.ops import vc_phi
from test_torch_vc_phi import (
    bwd_case, jax_side, kernel_rsqrt, kernel_split_exponent, make_inputs,
)

LN2 = 0.69314718055994530942


def group_factor(A, delta):
    """group_cholesky: the lower triangle of A (..., d, d) as a dict of
    entries, factored right-looking in reciprocal form with the forward
    substitution of delta (a list of d entries) folded in; returns (L, z,
    rcs) with L's diagonal slots holding 1 / L_cc."""
    d = A.shape[-1]
    a = {(r, t): A[..., r, t] for r in range(d) for t in range(r + 1)}
    dl = list(delta)
    z, rcs = [], []
    for c in range(d):
        rc = kernel_rsqrt(a[c, c])
        zc = dl[c] * rc
        z.append(zc)
        rcs.append(rc)
        a[c, c] = rc
        for r in range(c + 1, d):
            a[r, c] = a[r, c] * rc
            dl[r] = dl[r] - a[r, c] * zc
        for r in range(c + 1, d):
            for t in range(c + 1, r + 1):
                a[r, t] = a[r, t] - a[r, c] * a[t, c]
    return a, z, rcs


def group_log_prod(rcs, dtype):
    """QuadLogProd.log_prod: the product of the reciprocal pivots in double,
    its exponent split off after every second factor and at the end."""
    prod = rcs[0].double()
    e2 = torch.zeros_like(prod, dtype=torch.int64)
    for c in range(1, len(rcs)):
        if c % 2 == 0:
            prod, e = kernel_split_exponent(prod)
            e2 = e2 + e
        prod = prod * rcs[c].double()
    f, e = kernel_split_exponent(prod)
    return torch.log(f.to(dtype)) + (e2 + e).to(dtype) * LN2


def group_forward(X, psi, P, Sigma, lds):
    d = X.shape[1]
    delta = X[:, None, :] - P[None]
    _, z, rcs = group_factor(psi[:, None] + Sigma[None],
                             [delta[..., r] for r in range(d)])
    quad = z[0] * z[0]
    for r in range(1, d):
        quad = quad + z[r] * z[r]
    return -0.5 * quad + 0.5 * lds[None] + group_log_prod(rcs, X.dtype)


def group_backward(X, psi, P, Sigma, g):
    d = X.shape[1]
    delta = X[:, None, :] - P[None]
    a, z, _ = group_factor(psi[:, None] + Sigma[None],
                           [delta[..., r] for r in range(d)])
    # L^-1 in place: step k finishes row k, the rows below take L_rk times it
    for k in range(d):
        for c in range(k):
            a[k, c] = -a[k, c] * a[k, k]
        for r in range(k + 1, d):
            lrk = a[r, k]
            for c in range(k):
                a[r, c] = a[r, c] + lrk * a[k, c]
            a[r, k] = lrk * a[k, k]
    # h_r = sum_{t >= r} (L^-1)_tr z_t
    h = []
    for r in range(d):
        s = a[r, r] * z[r]
        for t in range(r + 1, d):
            s = s + a[t, r] * z[t]
        h.append(s)
    dP = torch.stack([(g * h[r]).sum(0) for r in range(d)], -1)
    dS = torch.zeros_like(Sigma)
    half_g = 0.5 * g
    for r in range(d):
        for b in range(r, d):
            inv_rb = a[b, r] * a[b, b]
            for t in range(b + 1, d):
                inv_rb = inv_rb + a[t, r] * a[t, b]
            dS[:, r, b] = dS[:, b, r] = (
                half_g * (h[r] * h[b] - inv_rb)).sum(0)
    return dP, dS


GROUP_CASES = [(13, "float64"), (16, "float64"), (16, "float32")]


def group_case(d, dtype):
    np_dtype = np.float64 if dtype == "float64" else np.float32
    arrays, g = bwd_case(60 + d, 24, d, 7)
    return tuple(a.astype(np_dtype) for a in arrays), g.astype(np_dtype)


def check_group_forward(d, dtype):
    arrays, _ = group_case(d, dtype)
    rtol, atol = chip_smoke.KERNEL_TOL[dtype]
    args = tuple(map(torch.from_numpy, arrays))
    got = group_forward(*args).numpy()
    assert got.dtype == arrays[0].dtype and np.isfinite(got).all()
    np.testing.assert_allclose(got, vc_phi.vc_lnphi_plain(*args).numpy(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, jax_side(arrays), rtol=rtol, atol=atol)


def check_group_backward(d, dtype):
    arrays, g = group_case(d, dtype)
    rtol, atol = chip_smoke.KERNEL_BWD_TOL[dtype]
    args = tuple(map(torch.from_numpy, arrays[:4])) + (torch.from_numpy(g),)
    got = [a.numpy() for a in group_backward(*args)]
    np.testing.assert_array_equal(got[1], got[1].transpose(0, 2, 1))
    plain = [a.numpy() for a in vc_phi.vc_lnphi_bwd_plain(*args)]
    for name, a, b, c in zip(("dP", "dSigma"), got, plain,
                             jax_side(arrays, g)):
        for what, want in (("plain", b), ("jax", c)):
            err = np.abs(a - want).max()
            assert err <= atol + rtol * np.abs(want).max(), (name, what, err)


@pytest.mark.parametrize("d,dtype", GROUP_CASES)
def test_group_forward_arithmetic(d, dtype):
    check_group_forward(d, dtype)


@pytest.mark.parametrize("d,dtype", GROUP_CASES)
def test_group_backward_arithmetic(d, dtype):
    check_group_backward(d, dtype)


def test_group_arithmetic_gives_nan_for_a_non_pd_system():
    """A = psi + Sigma indefinite for bases 1 and 4 at d = 16: NaN exactly
    in their columns, forward and backward, where plain has it."""
    X, psi, P, Sigma, logdet = make_inputs(np.random.default_rng(4), 23, 16,
                                           6)
    Sigma[[1, 4]] = -5.0 * np.eye(16)
    logdet[[1, 4]] = 0.0
    args = tuple(map(torch.from_numpy, (X, psi, P, Sigma, logdet)))
    g = torch.ones((23, 6), dtype=torch.float64)
    got = group_forward(*args)
    nan = torch.isnan(got)
    assert nan[:, [1, 4]].all() and not nan[:, [0, 2, 3, 5]].any()
    assert torch.equal(nan, torch.isnan(vc_phi.vc_lnphi_plain(*args)))
    dP, dS = group_backward(*args[:4], g)
    assert torch.isnan(dP[[1, 4]]).all() and torch.isnan(dS[[1, 4]]).all()
    assert not torch.isnan(dP[[0, 2, 3, 5]]).any()


def test_group_log_prod_keeps_float32_range_past_16_factors():
    """32 float32 reciprocal pivots of 1e-37 pivots: their product leaves
    double's range unless the exponent is split along the way, as the
    group kernels (and the strided ones) split it in both types."""
    pivot = 1e-37
    rcs = [torch.rsqrt(torch.full((3,), pivot, dtype=torch.float32))
           for _ in range(32)]
    got = group_log_prod(rcs, torch.float32)
    np.testing.assert_allclose(got.numpy(), -16 * np.log(pivot), rtol=1e-6)
    rcs[5] = torch.full((3,), float("nan"))
    assert torch.isnan(group_log_prod(rcs, torch.float32)).all()
