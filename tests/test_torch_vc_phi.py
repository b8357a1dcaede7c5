"""gpz_tpu_torch.ops.vc_phi on the CPU: vc_lnphi_complete and its backward
(which run their plain PyTorch twins for CPU tensors) against gpz_tpu's
Pallas kernels in interpret mode, against tests/test_ops.py's dense
reference and against autograd through the plain forward. The CUDA kernels
themselves are checked against the same twins on the GPU by chip_smoke.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.ops.vc_phi import vc_lnphi_complete as pallas_lnphi
from test_ops import make_inputs as jax_inputs, ref_lnphi

from gpz_tpu_torch.ops import vc_phi

# rtol / atol as tests/test_ops.py holds the Pallas kernel to its reference
F64 = dict(rtol=1e-8, atol=1e-10)


def make_inputs(rng, n, d, m, dtype=np.float64):
    """tests/test_ops.py::make_inputs, as writable numpy arrays."""
    return tuple(np.array(a) for a in jax_inputs(rng, n, d, m, dtype))


def port(arrays):
    return vc_phi.vc_lnphi_complete(*map(torch.from_numpy, arrays)).numpy()


def jax_both(arrays):
    args = tuple(map(jnp.asarray, arrays))
    return np.asarray(pallas_lnphi(*args)), np.asarray(ref_lnphi(*args))


@pytest.mark.parametrize("n,d,m", [(37, 3, 5), (300, 3, 7), (23, 3, 11),
                                   (64, 5, 100)])
def test_plain_matches_pallas_and_reference(n, d, m):
    arrays = make_inputs(np.random.default_rng(n), n, d, m)
    got = port(arrays)
    pallas, ref = jax_both(arrays)
    np.testing.assert_allclose(got, pallas, **F64)
    np.testing.assert_allclose(got, ref, **F64)


def test_plain_matches_pallas_float32():
    arrays = make_inputs(np.random.default_rng(1), 37, 3, 5, np.float32)
    got = port(arrays)
    assert got.dtype == np.float32
    pallas, ref = jax_both(arrays)
    np.testing.assert_allclose(got, pallas, rtol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_non_pd_gives_nan_where_pallas_does():
    X, psi, P, Sigma, logdet = make_inputs(np.random.default_rng(2), 23, 3, 6)
    # A = psi + Sigma is indefinite for bases 1 and 4 on every row
    Sigma[[1, 4]] = -5.0 * np.eye(3)
    logdet[[1, 4]] = 0.0
    arrays = (X, psi, P, Sigma, logdet)
    got = port(arrays)
    pallas, _ = jax_both(arrays)
    nan = np.isnan(pallas)
    assert nan[:, [1, 4]].all() and not nan[:, [0, 2, 3, 5]].any()
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_allclose(got[~nan], pallas[~nan], **F64)


def test_cpu_wrapper_is_the_plain_twin_and_launches_nothing(monkeypatch):
    args = tuple(map(torch.from_numpy,
                     make_inputs(np.random.default_rng(3), 50, 5, 9)))
    before = vc_phi.LAUNCHES_FWD
    got = vc_phi.vc_lnphi_complete(*args)
    torch.testing.assert_close(got, vc_phi.vc_lnphi_plain(*args),
                               rtol=0, atol=0)
    # row blocking changes nothing
    monkeypatch.setattr(vc_phi, "PHI_BLOCK_ROWS", 7)
    torch.testing.assert_close(got, vc_phi.vc_lnphi_plain(*args),
                               rtol=0, atol=0)
    assert vc_phi.LAUNCHES_FWD == before


def _bad_calls():
    """(id, mutate) pairs: each makes an argument tuple the kernel refuses."""
    def shape(a):
        X, psi, P, Sigma, lds = a
        return X, psi, P, Sigma[:-1], lds

    def rows(a):
        X, psi, P, Sigma, lds = a
        return X, psi[:-1], P, Sigma, lds

    def dtype(a):
        X, psi, P, Sigma, lds = a
        return X, psi, P.float(), Sigma, lds

    def strided(a):
        X, psi, P, Sigma, lds = a
        return X, psi.transpose(1, 2), P, Sigma, lds

    def wide(a):
        n, m = a[0].shape[0], a[2].shape[0]
        return tuple(map(torch.from_numpy, make_inputs(
            np.random.default_rng(4), n, 9, m)))

    def integer(a):
        return tuple(t.to(torch.int64) for t in a)

    return [("mismatched-shape", shape), ("mismatched-rows", rows),
            ("mixed-dtype", dtype), ("non-contiguous", strided),
            ("d-above-8", wide), ("integer", integer)]


@pytest.mark.parametrize("mutate", [f for _, f in _bad_calls()],
                         ids=[i for i, _ in _bad_calls()])
def test_wrapper_refuses_what_the_kernel_does_not_take(mutate):
    args = tuple(map(torch.from_numpy,
                     make_inputs(np.random.default_rng(5), 11, 3, 4)))
    before = vc_phi.LAUNCHES_FWD
    with pytest.raises(ValueError):
        vc_phi.vc_lnphi_complete(*mutate(args))
    assert vc_phi.LAUNCHES_FWD == before


@pytest.mark.parametrize("which", [0, 1], ids=["X", "psi"])
def test_wrapper_refuses_inputs_that_need_a_gradient(which):
    # X and psi are data: a gradient in them is refused, not returned as zero
    args = [torch.from_numpy(a) for a in
            make_inputs(np.random.default_rng(6), 11, 3, 4)]
    args[which].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no gradient in X or psi"):
        vc_phi.vc_lnphi_complete(*args)
    with torch.no_grad():
        assert vc_phi.vc_lnphi_complete(*args).shape == (11, 4)


# --- the backward ---

# as tests/test_ops.py holds the Pallas backward to autodiff of its reference
BWD_F64 = dict(rtol=1e-7, atol=1e-9)
# float32: sums of n terms of size ~1 (measured 2e-6 at most on these cases)
BWD_F32 = dict(rtol=2e-3, atol=2e-4)

BWD_SHAPES = [(29, 3, 4), (37, 3, 5), (300, 3, 7), (23, 5, 11), (64, 5, 8),
              (5, 1, 3), (9, 8, 2)]


def bwd_case(seed, n, d, m, dtype=np.float64):
    rng = np.random.default_rng(seed)
    arrays = make_inputs(rng, n, d, m, dtype)
    g = rng.standard_normal((n, m)).astype(dtype)
    return arrays, g


def pallas_vjp(arrays, g):
    """(dP, dSigma, dlogdet) from gpz_tpu's kernel pair in interpret mode."""
    X, psi, P, Sigma, logdet = map(jnp.asarray, arrays)
    _, vjp = jax.vjp(lambda p, s, l: pallas_lnphi(X, psi, p, s, l),
                     P, Sigma, logdet)
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def autograd_plain(arrays, g):
    """(dP, dSigma symmetrized, dlogdet) by autograd through the plain
    forward. unrolled_cholesky reads only A's lower triangle, so autograd
    puts an off-diagonal pair's whole derivative into the lower entry; the
    analytic backward writes half into each triangle."""
    X, psi, P, Sigma, logdet = map(torch.from_numpy, arrays)
    leaves = [t.clone().requires_grad_(True) for t in (P, Sigma, logdet)]
    out = vc_phi.vc_lnphi_plain(X, psi, *leaves)
    dP, dS, dl = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    return [dP.numpy(), (0.5 * (dS + dS.transpose(1, 2))).numpy(), dl.numpy()]


def function_grads(arrays, g):
    """(dP, dSigma, dlogdet) through VcLnPhi (vc_lnphi_complete)."""
    X, psi, P, Sigma, logdet = map(torch.from_numpy, arrays)
    leaves = [t.clone().requires_grad_(True) for t in (P, Sigma, logdet)]
    out = vc_phi.vc_lnphi_complete(X, psi, *leaves)
    return [a.numpy() for a in
            torch.autograd.grad(out, leaves, torch.from_numpy(g))]


@pytest.mark.parametrize("n,d,m", BWD_SHAPES)
def test_bwd_plain_matches_pallas_vjp(n, d, m):
    arrays, g = bwd_case(n + m, n, d, m)
    dP, dS = vc_phi.vc_lnphi_bwd_plain(
        *map(torch.from_numpy, arrays[:4]), torch.from_numpy(g))
    want = pallas_vjp(arrays, g)
    np.testing.assert_allclose(dP.numpy(), want[0], **BWD_F64)
    np.testing.assert_allclose(dS.numpy(), want[1], **BWD_F64)
    # both triangles are written
    np.testing.assert_array_equal(dS.numpy(), dS.transpose(1, 2).numpy())


@pytest.mark.parametrize("n,d,m", BWD_SHAPES)
def test_function_backward_matches_autograd_and_pallas(n, d, m):
    arrays, g = bwd_case(100 + n, n, d, m)
    got = function_grads(arrays, g)
    for a, b, c, name in zip(got, autograd_plain(arrays, g),
                             pallas_vjp(arrays, g),
                             ("dP", "dSigma", "dlogdet")):
        np.testing.assert_allclose(a, b, err_msg=name, **BWD_F64)
        np.testing.assert_allclose(a, c, err_msg=name, **BWD_F64)


def test_backward_float32():
    arrays, g = bwd_case(7, 37, 3, 5, np.float32)
    got = function_grads(arrays, g)
    assert all(a.dtype == np.float32 for a in got)
    arrays64 = tuple(a.astype(np.float64) for a in arrays)
    want = autograd_plain(arrays64, g.astype(np.float64))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **BWD_F32)


def test_backward_row_blocking_changes_nothing_beyond_rounding(monkeypatch):
    arrays, g = bwd_case(8, 50, 3, 6)
    args = tuple(map(torch.from_numpy, arrays[:4])) + (torch.from_numpy(g),)
    whole = vc_phi.vc_lnphi_bwd_plain(*args)
    monkeypatch.setattr(vc_phi, "PHI_BLOCK_ROWS", 7)
    blocked = vc_phi.vc_lnphi_bwd_plain(*args)
    for a, b in zip(whole, blocked):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("n,d,m", [(6, 2, 3), (5, 3, 2)])
def test_gradcheck_of_the_function(n, d, m):
    """VcLnPhi's analytic backward against finite differences. Sigma is
    perturbed symmetrically (the function reads its lower triangle, the
    backward returns the symmetric cotangent), through S = (T + T')/2."""
    arrays, _ = bwd_case(9, n, d, m)
    X, psi, P, Sigma, logdet = map(torch.from_numpy, arrays)
    P, T, logdet = (t.clone().requires_grad_(True)
                    for t in (P, Sigma, logdet))

    def fn(P, T, logdet):
        S = (0.5 * (T + T.transpose(1, 2))).contiguous()
        return vc_phi.vc_lnphi_complete(X, psi, P, S, logdet)

    assert torch.autograd.gradcheck(fn, (P, T, logdet), eps=1e-6, atol=1e-6,
                                    rtol=1e-5)


def test_cpu_backward_launches_nothing():
    arrays, g = bwd_case(10, 20, 3, 4)
    before = (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD)
    function_grads(arrays, g)
    assert (vc_phi.LAUNCHES_FWD, vc_phi.LAUNCHES_BWD) == before


def test_backward_refuses_a_cotangent_of_the_wrong_shape():
    arrays, g = bwd_case(11, 12, 3, 4)
    args = tuple(map(torch.from_numpy, arrays[:4]))
    with pytest.raises(ValueError, match="g must be"):
        vc_phi.vc_lnphi_bwd(*args, torch.from_numpy(g[:, :-1].copy()))
