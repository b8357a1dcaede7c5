"""gpz_tpu_torch.ops.vc_phi on the CPU: vc_lnphi_complete and its backward
(which run their plain PyTorch twins for CPU tensors) against gpz_tpu's
Pallas kernels in interpret mode, against tests/test_ops.py's dense
reference and against autograd through the plain forward. The CUDA kernels
themselves are checked against the same twins on the GPU by chip_smoke.py.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
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

    def no_band(a):
        X, psi, P, Sigma, lds = a
        return X[:, :0], psi[:, :0, :0], P[:, :0], Sigma[:, :0, :0], lds

    def integer(a):
        return tuple(t.to(torch.int64) for t in a)

    return [("mismatched-shape", shape), ("mismatched-rows", rows),
            ("mixed-dtype", dtype), ("non-contiguous", strided),
            ("d-zero", no_band), ("integer", integer)]


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


@pytest.mark.parametrize("sets", [2, 3])
def test_sets_of_bases_have_the_gradient_of_each_set_alone(sets):
    """Bases joined from `sets` parameter sets (m = 3 sets x 4 bases): the
    function's gradient through vc_lnphi_complete(..., sets), and
    vc_lnphi_bwd(..., sets), equal each set's call alone bit for bit (on the
    CPU each set runs the plain twins as alone; on the GPU the kernel plans
    its sums per set, checked by chip_smoke.py phase 13)."""
    arrays, g = bwd_case(12 + sets, 40, 3, 4 * sets)
    X, psi, P, Sigma, logdet = map(torch.from_numpy, arrays)
    gt = torch.from_numpy(g)
    leaves = [t.clone().requires_grad_(True) for t in (P, Sigma, logdet)]
    out = vc_phi.vc_lnphi_complete(X, psi, *leaves, sets)
    joined = torch.autograd.grad(out, leaves, gt)
    direct = vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, gt, sets)
    for s in range(sets):
        cols = slice(4 * s, 4 * s + 4)
        one = [t[cols].clone().requires_grad_(True)
               for t in (P, Sigma, logdet)]
        out1 = vc_phi.vc_lnphi_complete(X, psi, *one)
        assert torch.equal(out[:, cols], out1)
        alone = torch.autograd.grad(out1, one, gt[:, cols].contiguous())
        for a, b in zip(joined, alone):
            assert torch.equal(a[cols], b)
        for a, b in zip(direct, alone):
            assert torch.equal(a[cols], b)


def test_sets_must_divide_the_bases():
    arrays, g = bwd_case(14, 12, 3, 6)
    X, psi, P, Sigma, logdet = map(torch.from_numpy, arrays)
    with pytest.raises(ValueError, match="6 bases are not 4 equal sets"):
        vc_phi.vc_lnphi_complete(X, psi, P, Sigma, logdet, 4)
    with pytest.raises(ValueError, match="6 bases are not 0 equal sets"):
        vc_phi.vc_lnphi_bwd(X, psi, P, Sigma, torch.from_numpy(g), 0)


def test_backward_refuses_a_cotangent_of_the_wrong_shape():
    arrays, g = bwd_case(11, 12, 3, 4)
    args = tuple(map(torch.from_numpy, arrays[:4]))
    with pytest.raises(ValueError, match="g must be"):
        vc_phi.vc_lnphi_bwd(*args, torch.from_numpy(g[:, :-1].copy()))


# --- the CUDA kernels' arithmetic, transcribed ---
#
# csrc/vc_phi.cu cannot run without a GPU, but its order of operations can:
# the functions below repeat it in torch, entry by entry over the (n, m)
# pairs: pivots, one reciprocal square root per column kept in L's diagonal
# slot, products where the textbook divides, one logarithm of the
# renormalized product of the reciprocal pivots; h, L^-1 and A^-1 for the
# backward. They are held to the tolerances that chip_smoke.py holds the
# kernels to on the card: KERNEL_TOL (rtol, atol on lnPHI) float64
# (1e-8, 1e-10), float32 (1e-4, 1e-5), trained point (1e-8, 1e-8);
# KERNEL_BWD_TOL (against each output's largest entry) float64 (1e-7, 1e-9),
# float32 (2e-3, 2e-4), trained point (1e-7, 0).

def kernel_rsqrt(s):
    """rsqrt_t: float32 is rsqrtf; float64 is a ~22-bit seed and one
    third-order step, without fused multiply-adds here."""
    if s.dtype == torch.float32:
        return torch.rsqrt(s)
    seed = (torch.rsqrt(s).contiguous().view(torch.int64)
            & ~((1 << 30) - 1)).view(torch.float64)
    e = 1.0 - s * (seed * seed)
    return seed + (0.5 + 0.375 * e) * (seed * e)


def kernel_split_exponent(x):
    """split_exponent: (f, e) with x = f 2^e, f in [1, 2), for positive
    normal x; anything else unchanged with e = 0."""
    bits = x.contiguous().view(torch.int64)
    field = (bits >> 52) & 0x7ff
    normal = (field >= 1) & (field <= 0x7fe)
    f = torch.where(normal, (bits & ~(0x7ff << 52)) | (0x3ff << 52), bits)
    return f.view(torch.float64), torch.where(normal, field - 1023, 0)


def kernel_factor(A):
    """cholesky_recip on the lower triangle of A (..., d, d): a dict of
    L's entries, the diagonal slots holding 1 / L_cc."""
    d = A.shape[-1]
    L = {}
    for c in range(d):
        s = A[..., c, c]
        for t in range(c):
            s = s - L[c, t] * L[c, t]
        L[c, c] = kernel_rsqrt(s)
        for r in range(c + 1, d):
            s2 = A[..., r, c]
            for t in range(c):
                s2 = s2 - L[r, t] * L[c, t]
            L[r, c] = s2 * L[c, c]
    return L


def kernel_log_prod_diag(L, d, dtype):
    prod = L[0, 0].double()
    e2 = torch.zeros_like(prod, dtype=torch.int64)
    for c in range(1, d):
        if dtype == torch.float64 and c % 2 == 0:
            prod, e = kernel_split_exponent(prod)
            e2 = e2 + e
        prod = prod * L[c, c].double()
    if dtype == torch.float32:
        prod, e = kernel_split_exponent(prod)
        e2 = e2 + e
    return torch.log(prod.to(dtype)) + e2.to(dtype) * 0.69314718055994530942


def kernel_solve_lower(L, z, d):
    for r in range(d):
        s = z[r]
        for t in range(r):
            s = s - L[r, t] * z[t]
        z[r] = s * L[r, r]
    return z


def kernel_forward(X, psi, P, Sigma, lds):
    d = X.shape[1]
    L = kernel_factor(psi[:, None] + Sigma[None])
    delta = X[:, None, :] - P[None]
    z = kernel_solve_lower(L, [delta[..., r] for r in range(d)], d)
    quad = z[0] * z[0]
    for r in range(1, d):
        quad = quad + z[r] * z[r]
    return (-0.5 * quad + 0.5 * lds[None]
            + kernel_log_prod_diag(L, d, X.dtype))


def kernel_backward(X, psi, P, Sigma, g):
    d = X.shape[1]
    L = kernel_factor(psi[:, None] + Sigma[None])
    delta = X[:, None, :] - P[None]
    h = kernel_solve_lower(L, [delta[..., r] for r in range(d)], d)
    for r in reversed(range(d)):            # solve_lower_transposed
        s = h[r]
        for t in range(r + 1, d):
            s = s - L[t, r] * h[t]
        h[r] = s * L[r, r]
    for c in range(d):                      # invert_lower, in place
        for r in range(c + 1, d):
            s = L[r, c] * L[c, c]
            for t in range(c + 1, r):
                s = s + L[r, t] * L[t, c]
            L[r, c] = -s * L[r, r]
    dP = torch.stack([(g * h[a]).sum(0) for a in range(d)], -1)
    dS = torch.zeros_like(Sigma)
    half_g = 0.5 * g
    for a in range(d):
        for b in range(a, d):
            inv_ab = L[b, a] * L[b, b]
            for t in range(b + 1, d):
                inv_ab = inv_ab + L[t, a] * L[t, b]
            dS[:, a, b] = dS[:, b, a] = (
                half_g * (h[a] * h[b] - inv_ab)).sum(0)
    return dP, dS


@pytest.fixture(scope="module")
def trained_site():
    """The arguments of predict()'s PHI-site call at the trained photo-z
    checkpoint in float64 (cond(Sigma) ~ 5e7), 256 rows, and a cotangent."""
    import chip_smoke
    import gpz_tpu_torch
    from gpz_tpu_torch import datautils
    from gpz_tpu_torch.data import synthetic_sdss
    from make_torch_port_golden import CHECKPOINT, golden_rows

    _, X, psi, _ = golden_rows(synthetic_sdss, datautils.split)
    model = gpz_tpu_torch.load_model(CHECKPOINT, device="cpu").astype(
        "float64")
    _, sites = chip_smoke.site_calls(
        lambda: gpz_tpu_torch.predict(X, model, psi=psi))
    args = next(iter(sites.values()))[1]      # the first launch: the PHI site
    g = np.random.default_rng(12).standard_normal(
        (args[0].shape[0], args[2].shape[0]))
    return tuple(a.numpy() for a in args), g


def transcription_case(case, trained_site):
    """(arrays, g, tolerance key) of a named case; make_inputs scaled by
    1e-3 in length gives A pivots of ~1e-6."""
    import chip_smoke

    if case == "trained":
        return (*trained_site, "trained")
    kind, d, dtype = case
    np_dtype = np.float64 if dtype == "float64" else np.float32
    arrays, g = bwd_case(40 + d, 24, d, 7, np.float64)
    if kind == "small-pivot":
        X, psi, P, Sigma, logdet = chip_smoke.random_inputs(
            np.random.default_rng(13), 24, d, 7, torch.float64, "cpu",
            scale=1e-3)
        arrays = tuple(a.numpy() for a in (X, psi, P, Sigma, logdet))
    return tuple(a.astype(np_dtype) for a in arrays), g.astype(np_dtype), dtype


def jax_side(arrays, g=None):
    """JAX's lnPHI or, given a cotangent, its (dP, dSigma): gpz_tpu's kernels
    in interpret mode up to d=5, and tests/test_ops.py's dense reference with
    its autodiff at d=8, where interpret mode takes several seconds a case."""
    X, psi, P, Sigma, logdet = map(jnp.asarray, arrays)
    if arrays[0].shape[1] <= 5:
        if g is None:
            return np.asarray(pallas_lnphi(X, psi, P, Sigma, logdet))
        return pallas_vjp(arrays, g)[:2]
    if g is None:
        return np.asarray(ref_lnphi(X, psi, P, Sigma, logdet))
    _, vjp = jax.vjp(lambda p, s: ref_lnphi(X, psi, p, s, logdet), P, Sigma)
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


TRANSCRIPTION_CASES = (
    [("random", d, dt) for dt in ("float64", "float32") for d in (1, 2, 5, 8)]
    + [("small-pivot", 8, "float32"), "trained"])


def case_id(case):
    return case if isinstance(case, str) else "-".join(map(str, case))


@pytest.mark.parametrize("case", TRANSCRIPTION_CASES, ids=case_id)
def test_kernel_forward_arithmetic(case, trained_site):
    import chip_smoke

    arrays, _, key = transcription_case(case, trained_site)
    rtol, atol = chip_smoke.KERNEL_TOL[key]
    args = tuple(map(torch.from_numpy, arrays))
    got = kernel_forward(*args).numpy()
    assert got.dtype == arrays[0].dtype and np.isfinite(got).all()
    np.testing.assert_allclose(got, vc_phi.vc_lnphi_plain(*args).numpy(),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(got, jax_side(arrays), rtol=rtol, atol=atol)


@pytest.mark.parametrize("case", TRANSCRIPTION_CASES, ids=case_id)
def test_kernel_backward_arithmetic(case, trained_site):
    import chip_smoke

    arrays, g, key = transcription_case(case, trained_site)
    rtol, atol = chip_smoke.KERNEL_BWD_TOL[key]
    args = tuple(map(torch.from_numpy, arrays[:4])) + (torch.from_numpy(g),)
    got = [a.numpy() for a in kernel_backward(*args)]
    np.testing.assert_array_equal(got[1], got[1].transpose(0, 2, 1))
    plain = [a.numpy() for a in vc_phi.vc_lnphi_bwd_plain(*args)]
    for name, a, b, c in zip(("dP", "dSigma"), got, plain,
                             jax_side(arrays, g)):
        for what, want in (("plain", b), ("jax", c)):
            err = np.abs(a - want).max()
            assert err <= atol + rtol * np.abs(want).max(), (name, what, err)


def extended_lnphi(X, psi, P, Sigma, lds):
    """lnPHI by the textbook Cholesky (square roots, divisions, a sum of
    logarithms) in numpy's extended precision."""
    wide = np.longdouble
    A = psi[:, None].astype(wide) + Sigma[None].astype(wide)
    delta = X[:, None, :].astype(wide) - P[None].astype(wide)
    d = X.shape[1]
    L, z = {}, [None] * d
    quad = half_logdet = wide(0)
    for c in range(d):
        s = A[..., c, c]
        for t in range(c):
            s = s - L[c, t] * L[c, t]
        L[c, c] = np.sqrt(s)
        for r in range(c + 1, d):
            s2 = A[..., r, c]
            for t in range(c):
                s2 = s2 - L[r, t] * L[c, t]
            L[r, c] = s2 / L[c, c]
    for r in range(d):
        s = delta[..., r]
        for t in range(r):
            s = s - L[r, t] * z[t]
        z[r] = s / L[r, r]
        quad = quad + z[r] * z[r]
        half_logdet = half_logdet + np.log(L[r, r])
    return -0.5 * quad + 0.5 * lds[None].astype(wide) - half_logdet


def test_reciprocal_form_is_as_accurate_as_the_plain_version(trained_site):
    """At the trained point (cond(Sigma) ~ 5e7) the kernels' arithmetic and
    the plain version differ from each other by more than the textbook
    kernel did, because their roundings no longer go together; against an
    extended-precision reference neither is further off than the other."""
    if np.finfo(np.longdouble).eps >= np.finfo(np.float64).eps:
        pytest.skip("numpy's longdouble is no wider than float64 here")
    arrays, _ = trained_site
    args = tuple(map(torch.from_numpy, arrays))
    want = extended_lnphi(*arrays)
    plain = np.abs(vc_phi.vc_lnphi_plain(*args).numpy() - want)
    recip = np.abs(kernel_forward(*args).numpy() - want)
    print(f"vs extended precision at the trained PHI site: plain max "
          f"{float(plain.max()):.3e} mean {float(plain.mean()):.3e}; "
          f"reciprocal form max {float(recip.max()):.3e} mean "
          f"{float(recip.mean()):.3e}")
    assert recip.max() <= 2 * plain.max()
    assert recip.mean() <= 2 * plain.mean()


def test_kernel_arithmetic_gives_nan_for_a_non_pd_system():
    X, psi, P, Sigma, logdet = make_inputs(np.random.default_rng(2), 23, 3, 6)
    # A = psi + Sigma is indefinite for bases 1 and 4 on every row
    Sigma[[1, 4]] = -5.0 * np.eye(3)
    logdet[[1, 4]] = 0.0
    arrays = (X, psi, P, Sigma, logdet)
    args = tuple(map(torch.from_numpy, arrays))
    got = kernel_forward(*args).numpy()
    plain = vc_phi.vc_lnphi_plain(*args).numpy()
    pallas, _ = jax_both(arrays)
    nan = np.isnan(got)
    assert nan[:, [1, 4]].all() and not nan[:, [0, 2, 3, 5]].any()
    np.testing.assert_array_equal(nan, np.isnan(plain))
    np.testing.assert_array_equal(nan, np.isnan(pallas))
    np.testing.assert_allclose(got[~nan], plain[~nan], **F64)


def test_kernel_arithmetic_gives_nan_for_a_zero_pivot():
    """A first pivot of exactly zero: the reciprocal form gives NaN in that
    basis, forward and backward, where the plain versions give NaN too."""
    rng = np.random.default_rng(3)
    X, psi, P, Sigma, logdet = make_inputs(rng, 23, 3, 6)
    psi[:, 0, 0] = 0.25
    Sigma[2, 0, 0] = -0.25
    args = tuple(map(torch.from_numpy, (X, psi, P, Sigma, logdet)))
    g = torch.ones((23, 6), dtype=torch.float64)
    got = (kernel_forward(*args), *kernel_backward(*args[:4], g))
    plain = (vc_phi.vc_lnphi_plain(*args),
             *vc_phi.vc_lnphi_bwd_plain(*args[:4], g))
    for basis_axis, a, b in zip((1, 0, 0), got, plain):
        nan = torch.isnan(a)
        assert nan.select(basis_axis, 2).all()
        assert torch.equal(nan, torch.isnan(b))
        torch.testing.assert_close(a[~nan], b[~nan], rtol=1e-7, atol=1e-9)


def test_the_product_of_reciprocal_pivots_keeps_its_range():
    """Pivots at both ends of each type's normal range: the product of the
    d reciprocal pivots leaves the type's range, its renormalized form does
    not, and a NaN pivot stays NaN."""
    for dtype, pivots in ((torch.float64, (1e-300, 1e300)),
                          (torch.float32, (1e-37, 1e37))):
        for pivot in pivots:
            d = 8
            L = {(c, c): torch.rsqrt(torch.full((3,), pivot, dtype=dtype))
                 for c in range(d)}
            got = kernel_log_prod_diag(L, d, dtype)
            want = -0.5 * d * np.log(pivot)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
            L[3, 3] = torch.full((3,), float("nan"), dtype=dtype)
            assert torch.isnan(kernel_log_prod_diag(L, d, dtype)).all()


# --- the yardstick of the GPU run ---

def test_chip_smoke_bounds_are_pinned():
    """chip_smoke.py counts the work of the functions, not of the kernels'
    current instructions: 122 and 335 operations per pair at d=5, which at
    the training shape are 0.0251 ms and 0.0690 ms by operations."""
    import chip_smoke

    assert chip_smoke.fwd_ops(5) == 122
    assert chip_smoke.bwd_ops(5) == 335
    for kind, ms in (("fwd", 0.0251), ("bwd", 0.0690)):
        b = chip_smoke.bound(kind, 70000, 100, 5, "float64")
        assert b["bound_by"] == "operations"
        assert round(b["bound_ms"], 4) == ms
        assert b["bound_ms"] == b["ops_ms"] > b["bytes_ms"]
