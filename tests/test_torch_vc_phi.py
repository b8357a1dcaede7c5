"""gpz_tpu_torch.ops.vc_phi on the CPU: vc_lnphi_complete (which runs its
plain PyTorch twin for CPU tensors) against gpz_tpu's Pallas kernel in
interpret mode and against tests/test_ops.py's dense reference. The CUDA
kernel itself is checked against the same twin on the GPU by chip_smoke.py.
"""

import numpy as np
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
    before = vc_phi.LAUNCHES
    got = vc_phi.vc_lnphi_complete(*args)
    torch.testing.assert_close(got, vc_phi.vc_lnphi_plain(*args),
                               rtol=0, atol=0)
    # row blocking changes nothing
    monkeypatch.setattr(vc_phi, "PHI_BLOCK_ROWS", 7)
    torch.testing.assert_close(got, vc_phi.vc_lnphi_plain(*args),
                               rtol=0, atol=0)
    assert vc_phi.LAUNCHES == before


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
    before = vc_phi.LAUNCHES
    with pytest.raises(ValueError):
        vc_phi.vc_lnphi_complete(*mutate(args))
    assert vc_phi.LAUNCHES == before


def test_wrapper_refuses_inputs_that_need_a_gradient():
    args = [torch.from_numpy(a) for a in
            make_inputs(np.random.default_rng(6), 11, 3, 4)]
    args[2].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        vc_phi.vc_lnphi_complete(*args)
    with torch.no_grad():
        assert vc_phi.vc_lnphi_complete(*args).shape == (11, 4)
