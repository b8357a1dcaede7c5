"""Numerics substrate (gpz_tpu.linalg): robust PSD factorizations and solves,
batched tiny (d x d) solves, masked moments, distances and imputation.

The d-unrolled functions keep gpz_tpu's operation order term for term, so in
float64 they agree with it to rounding. Non-PD inputs give NaN, as JAX's
cholesky does, never an exception.
"""

from __future__ import annotations

import torch

from gpz_tpu_torch.trace import count

# Escalating relative jitter levels tried when a Cholesky factorization fails.
_JITTERS = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky that, like JAX's, gives a failed factor NaN on and
    below the diagonal (zero above) instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = torch.full_like(L, torch.nan).tril()
    return torch.where((info != 0)[..., None, None], failed, L)


def safe_cholesky(A: torch.Tensor, batch_dims: int = 0) -> torch.Tensor:
    """Cholesky of PSD `A` (batched, [..., n, n]) with escalating jitter.

    `batch_dims` leading axes index independent sets (the parameter sets of
    a batched evaluation): each set climbs the ladder on its own, as each
    chain does under gpz_tpu's vmap, and a set whose factor is finite keeps
    its zero-jitter factor. With 0 the whole tensor is one set and takes
    one level.

    One factorization at zero jitter is the common case, and its finiteness
    check is the call's one host sync. If a set's factor is not finite,
    every level of the ladder is factored on a detached copy, each set takes
    the first level at which all its factors are finite (the last level if
    none is), and one differentiable factorization is taken at those levels,
    with no further host read. If every level fails, NaNs propagate (ref
    minFunc.m:963 isLegal/Armijo-fallback role).
    """
    L0 = _cholesky_or_nan(A)
    lead = A.shape[:batch_dims]
    ok0 = torch.isfinite(L0).reshape(*lead, -1).all(-1)
    count("reads.cholesky")
    if bool(ok0.all()):
        return L0
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    with torch.no_grad():
        As = A.detach()
        scale = As.diagonal(dim1=-2, dim2=-1).abs().mean(-1)
        scale = torch.clamp(scale, min=1.0)[..., None, None]
        jitter = torch.full(lead, _JITTERS[-1], dtype=A.dtype, device=A.device)
        for level in reversed(_JITTERS[1:]):
            ok = torch.isfinite(_cholesky_or_nan(As + level * scale * eye))
            jitter = torch.where(ok.reshape(*lead, -1).all(-1), level, jitter)
        # a set that factored at zero jitter is factored again at zero:
        # selecting L0 instead would send NaN cotangents from the failed
        # sets' L0 into the gradient
        jitter = torch.where(ok0, 0.0, jitter)
        jitter = jitter.reshape(lead + (1,) * (A.dim() - batch_dims))
    return _cholesky_or_nan(A + jitter * scale * eye)


def per_set(fn, batch_dims: int, *args):
    """fn on each parameter set's slice of `args` (tensors with
    `batch_dims` leading set axes, or None), its tensor results (one, or a
    tuple) stacked along those axes; fn(*args) itself when batch_dims is 0.
    A set then goes through the very products, sums and factorizations
    that it goes through alone, where one batched call (cuBLAS's and
    cuSOLVER's batched routines, a reduction planned for several outputs)
    may round otherwise, so its bits do not depend on how many sets share
    the call (the lanes of optim.minimize_batched must each equal minimize
    alone)."""
    if batch_dims == 0:
        return fn(*args)
    sets = next(a.shape[0] for a in args if a is not None)
    parts = [[None] * sets if a is None else a.unbind(0) for a in args]
    outs = [per_set(fn, batch_dims - 1, *one) for one in zip(*parts)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(o) for o in zip(*outs))
    return torch.stack(outs)


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|A| from its Cholesky factor (batched)."""
    return 2.0 * torch.sum(torch.log(L.diagonal(dim1=-2, dim2=-1)), dim=-1)


def chol_solve(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B given L = chol(A) (batched)."""
    Y = torch.linalg.solve_triangular(L, B, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), Y, upper=True)


def solve_psd(A: torch.Tensor, B: torch.Tensor):
    """Solve A X = B for PSD A; returns (X, logdet A)."""
    L = safe_cholesky(A)
    return chol_solve(L, B), chol_logdet(L)


def solve_w_logdet(SIGMA: torch.Tensor, rhs: torch.Tensor,
                   batch_dims: int = 0):
    """(w, logdet) for the batched PSD system SIGMA_k w_k = rhs_k.

    SIGMA (..., k, m, m); rhs (..., m, k). Returns w (..., m, k), logdet
    (..., k). `batch_dims` leading axes are independent sets for the jitter
    ladder (`safe_cholesky`). Differentiable by autograd through the
    factorization and the triangular solves: float64 products are exact on
    the CPU and on CUDA, so gpz_tpu's hand-written cotangents for this
    function have no counterpart here.
    """
    L = safe_cholesky(SIGMA, batch_dims)
    w = chol_solve(L, rhs.transpose(-1, -2)[..., None])[..., 0]  # (..., k, m)
    return w.transpose(-1, -2), chol_logdet(L)


def inv_logdet_psd(A: torch.Tensor):
    """(A^-1, log|A|) for PSD A: the role of ref GPz/inv_logdet.m."""
    L = safe_cholesky(A)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    return chol_solve(L, eye), chol_logdet(L)


def unrolled_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky for huge batches of TINY (d x d) matrices, unrolled over d.

    ~d^3/6 elementwise operations over the batch (the per-sample loop of ref
    getPHI.m:80-88). Non-PD inputs produce NaNs.
    """
    d = A.shape[-1]
    L = [[None] * d for _ in range(d)]
    for j in range(d):
        s = A[..., j, j]
        for t in range(j):
            s = s - L[j][t] * L[j][t]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, d):
            s2 = A[..., i, j]
            for t in range(j):
                s2 = s2 - L[i][t] * L[j][t]
            L[i][j] = s2 / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [
        torch.stack([L[i][j] if j <= i else zero for j in range(d)], dim=-1)
        for i in range(d)
    ]
    return torch.stack(rows, dim=-2)


def unrolled_solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Forward substitution L z = b for tiny d; b is [..., d]."""
    d = L.shape[-1]
    z = []
    for i in range(d):
        s = b[..., i]
        for t in range(i):
            s = s - L[..., i, t] * z[t]
        z.append(s / L[..., i, i])
    return torch.stack(z, dim=-1)


def unrolled_inv_psd(A: torch.Tensor, unroll_max: int = 8):
    """(A^-1, log|A|) for huge batches of tiny PSD matrices.

    Unrolled Cholesky + triangular inverse + Linv^T Linv, elementwise over
    the batch; torch.linalg for d > unroll_max.
    """
    d = A.shape[-1]
    if d > unroll_max:
        L = _cholesky_or_nan(A)
        eye = torch.eye(d, dtype=A.dtype, device=A.device).expand(A.shape)
        Linv = torch.linalg.solve_triangular(L, eye, upper=False)
        inv = torch.einsum("...ki,...kj->...ij", Linv, Linv)
        return inv, chol_logdet(L)

    L = unrolled_cholesky(A)
    Li = [[None] * d for _ in range(d)]
    for j in range(d):
        Li[j][j] = 1.0 / L[..., j, j]
        for i in range(j + 1, d):
            s = L[..., i, j] * Li[j][j]
            for t in range(j + 1, i):
                s = s + L[..., i, t] * Li[t][j]
            Li[i][j] = -s / L[..., i, i]
    zero = torch.zeros_like(A[..., 0, 0])
    rows = []
    for a in range(d):
        cols = []
        for b in range(d):
            acc = zero
            for t in range(max(a, b), d):
                acc = acc + Li[t][a] * Li[t][b]
            cols.append(acc)
        rows.append(torch.stack(cols, dim=-1))
    inv = torch.stack(rows, dim=-2)
    logdet = 2.0 * sum(torch.log(L[..., i, i]) for i in range(d))
    return inv, logdet


def quad_logdet_psd(A: torch.Tensor, delta: torch.Tensor,
                    unroll_max: int = 8):
    """(delta^T A^-1 delta, log|A|) for batched PSD A [..., d, d]."""
    d = A.shape[-1]
    if d <= unroll_max:
        L = unrolled_cholesky(A)
        z = unrolled_solve_lower(L, delta)
    else:
        L = _cholesky_or_nan(A)
        z = torch.linalg.solve_triangular(
            L, delta[..., None], upper=False
        )[..., 0]
    quad = torch.sum(z * z, dim=-1)
    logdet = 2.0 * torch.sum(
        torch.log(L.diagonal(dim1=-2, dim2=-1)), dim=-1
    )
    return quad, logdet


def masked_psd(A: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Embed the observed-block restriction of PSD `A` in full size.

    Given A [..., d, d] and boolean mask [..., d] (True = observed), returns
    B = M A M + (I - M) with M = diag(mask): logdet(B) == logdet(A[o, o]),
    and B^-1 restricted to [o, o] == A[o, o]^-1 (ref getPHI.m:76-87).
    """
    m = mask.to(A.dtype)
    d = A.shape[-1]
    outer = m[..., :, None] * m[..., None, :]
    eye = torch.eye(d, dtype=A.dtype, device=A.device)
    return A * outer + eye * (1.0 - m)[..., :, None]


def dxy(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared Euclidean distances, (n, p). Ref GPz/Dxy.m:3-7."""
    xx = torch.sum(X * X, dim=1)[:, None]
    yy = torch.sum(Y * Y, dim=1)[None, :]
    return torch.abs(xx + yy - 2.0 * (X @ Y.transpose(0, 1)))


def nanaware_moments(X: torch.Tensor):
    """NaN-aware mean and covariance, ref GPz/pca.m:5-17.

    Returns (mu (d,), cov (d, d)) where cov uses the reference's
    pairwise-count normalization: cov = (Xc^T Xc) / (n - Mc^T Mc) with Xc the
    zero-filled centered data and Mc the missingness indicator.
    """
    n = X.shape[0]
    missing = torch.isnan(X)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    Xz = torch.where(missing, zero, X)
    counts = torch.sum(~missing, dim=0)
    mu = torch.sum(Xz, dim=0) / counts
    Xc = torch.where(missing, zero, X - mu[None, :])
    Mc = missing.to(X.dtype)
    denom = n - Mc.transpose(0, 1) @ Mc
    cov = (Xc.transpose(0, 1) @ Xc) / denom
    return mu, cov


def pca_whiten(X: torch.Tensor):
    """Eig-based PCA whitening for center initialization, ref GPz/pca.m:19-46.

    Returns (mu, cov, T, Ti) where T = U S^-1 whitens and Ti = S U^T
    un-whitens; the reference eig-decomposes n * cov_pairwise and scales by
    sqrt(lambda / (n - 1)). Eigenvectors are defined up to sign, so T and Ti
    are too.
    """
    n = X.shape[0]
    mu, cov = nanaware_moments(X)
    evals, U = torch.linalg.eigh(n * cov)
    evals = torch.abs(evals)
    order = torch.argsort(-evals)
    U = U[:, order]
    evals = evals[order]
    S = torch.sqrt(evals / (n - 1))
    T = U / S[None, :]
    Ti = S[:, None] * U.transpose(0, 1)
    return mu, cov, T, Ti


def fill_linear(X: torch.Tensor, mu: torch.Tensor,
                cov: torch.Tensor) -> torch.Tensor:
    """Gaussian-conditional imputation of NaNs, ref GPz/fillLinear.m:25-28.

    x_hat = mu + cov @ y where (M cov M + (I-M)) y = M (x - mu). On observed
    dims this returns x unchanged; on missing dims it returns
    mu_u + cov_uo cov_oo^-1 (x_o - mu_o): one batched d x d solve per row.
    """
    mask = ~torch.isnan(X)
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    r = torch.where(mask, X - mu[None, :], zero)
    A = masked_psd(cov.expand((X.shape[0],) + tuple(cov.shape)), mask)
    y = torch.linalg.solve(A, r[..., None])[..., 0]
    return mu[None, :] + y @ cov
