"""Numerics substrate: robust PSD factorizations and batched tiny (d x d)
solves (the parts of gpz_tpu.linalg that prediction uses).

The d-unrolled functions keep gpz_tpu's operation order term for term, so in
float64 they agree with it to rounding. Non-PD inputs give NaN, as JAX's
cholesky does, never an exception.
"""

from __future__ import annotations

import torch

# Escalating relative jitter levels tried when a Cholesky factorization fails.
_JITTERS = (0.0, 1e-12, 1e-10, 1e-8, 1e-6, 1e-4, 1e-2)


def _cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky that, like JAX's, gives a failed factor NaN on and
    below the diagonal (zero above) instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = torch.full_like(L, torch.nan).tril()
    return torch.where((info != 0)[..., None, None], failed, L)


def safe_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of PSD `A` (batched, [..., n, n]) with escalating jitter.

    One factorization at zero jitter is the common case. If any factor is
    non-finite, the jitter ladder is walked on a detached copy until every
    factor is finite, and one differentiable factorization is taken at that
    level. If every level fails, NaNs propagate (ref minFunc.m:963
    isLegal/Armijo-fallback role).
    """
    L0 = _cholesky_or_nan(A)
    if bool(torch.isfinite(L0).all()):
        return L0
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    with torch.no_grad():
        As = A.detach()
        scale = As.diagonal(dim1=-2, dim2=-1).abs().mean(-1)
        scale = torch.clamp(scale, min=1.0)[..., None, None]
        for jitter in _JITTERS[1:]:
            L = _cholesky_or_nan(As + jitter * scale * eye)
            if bool(torch.isfinite(L).all()):
                break
    return _cholesky_or_nan(A + jitter * scale * eye)


def chol_logdet(L: torch.Tensor) -> torch.Tensor:
    """log|A| from its Cholesky factor (batched)."""
    return 2.0 * torch.sum(torch.log(L.diagonal(dim1=-2, dim2=-1)), dim=-1)


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
