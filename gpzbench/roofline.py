"""Work counted from shapes: the operations and bytes of the design-matrix
kernel pair, the FLOPs of a training evaluation, of a validation score and
of a served row, and the H100's peaks they are held against.

The counts are the algorithm's, not an implementation's, so they read the
same whatever computes them: a pair's operations are those of one d x d
Cholesky, its substitutions and log-determinant (the forward), and of the
backward's inverse and accumulations (the counts of the port's smoke test,
frozen here); a call's bytes are each input read once and each output
written once. Elementwise passes count zero FLOPs.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense: FP64 on the tensor cores, FP32 outside them
#: (both 67 TFLOP/s), HBM3 at 3.35 TB/s
PEAK_FLOPS = {"float64": 67e12, "float32": 67e12}
PEAK_BYTES_PER_S = 3.35e12
ITEMSIZE = {"float64": 8, "float32": 4}
#: components of the missing-band mixture that a served row needs at the
#: least: the program's default truncation (GPZ_MIX_TOPL), not the exact sum
SERVE_MIX_COMPONENTS = 64


def fwd_ops(d: int) -> int:
    """Operations of one (row, basis) pair of lnPHI: every add, multiply,
    divide, square root and logarithm one, a fused multiply-add two."""
    nt = d * (d + 1) // 2
    chol = sum(2 * c + 1 + (d - 1 - c) * (2 * c + 1) for c in range(d))
    solve = sum(2 * r + 1 for r in range(d))
    return nt + chol + d + solve + (2 * d - 1) + (2 * d - 1) + 4


def bwd_ops(d: int) -> int:
    """Operations of one pair of lnPHI's vector-Jacobian product: the
    forward's factorisation and substitution, the back substitution, the
    triangular inverse, the upper triangle of A^-1 and the d + d(d+1)/2
    accumulations."""
    nt = d * (d + 1) // 2
    chol = sum(2 * c + 1 + (d - 1 - c) * (2 * c + 1) for c in range(d))
    solve = sum(2 * r + 1 for r in range(d))
    invert = sum(1 + sum(3 + 2 * (r - c - 1) for r in range(c + 1, d))
                 for c in range(d))
    a_inv = sum(1 + 2 * (d - 1 - b) for a in range(d) for b in range(a, d))
    return nt + chol + d + 2 * solve + 2 * d + invert + a_inv + 6 * nt


def kernel_work(kind: str, n: int, m: int, d: int) -> tuple:
    """(operations, elements moved) of one call of the pair on n rows and m
    bases: X, psi, P, Sigma read; lnPHI written (forward, with
    log|Sigma|), or the cotangent read and dP, dSigma written
    (backward, with the partial sums of each 256-row span)."""
    elems = n * d + n * d * d + m * d + m * d * d + n * m
    if kind == "fwd":
        return n * m * fwd_ops(d), elems + m
    return (n * m * bwd_ops(d) + n * m // 256 * (d + d * d),
            elems + m * d + m * d * d)


def least_seconds(kind: str, n: int, m: int, d: int, dtype: str) -> float:
    """The least time the chip needs for one call: the larger of its
    operations over the type's peak and its bytes over the memory rate."""
    ops, elems = kernel_work(kind, n, m, d)
    return max(ops / PEAK_FLOPS[dtype],
               elems * ITEMSIZE[dtype] / PEAK_BYTES_PER_S)


def evaluation_flops(n: int, m: int, d: int, k: int) -> int:
    """FLOPs of one value-and-gradient evaluation of the negative log
    marginal likelihood on n rows: the kernel pair, the Gram PHI' B PHI
    and its two cotangent products (6 n m^2 k), the five n x m x k
    products (PHI v, PHI' (beta y), PHI w and two cotangents), and per
    output the m x m Cholesky (m^3 / 3), its backward (m^3) and four
    triangular solves (4 m^2)."""
    return (n * m * (fwd_ops(d) + bwd_ops(d)) + 6 * n * m * m * k
            + 10 * n * m * k + k * (m ** 3 // 3 + m ** 3 + 4 * m * m))


def score_flops(n: int, m: int, d: int, k: int) -> int:
    """FLOPs of one validation score on n rows: the forward pair and the
    products PHI w, PHI v."""
    return n * m * fwd_ops(d) + 4 * n * m * k


def served_row_flops(m: int, d: int, k: int, components: int,
                     observed: int) -> int:
    """The least FLOPs of one served row whose inputs are a mixture of
    `components` Gaussians (1 for a complete row): the expected
    activations (components x m pairs), the pair site (components x m^2
    pairs), the contractions for mu, E ln S and the three second moments
    (4 m k + 6 m^2 k), and for a row with unobserved bands the
    responsibilities of the m bases under its `observed` bands."""
    flops = components * (m + m * m) * fwd_ops(d) + 4 * m * k + 6 * m * m * k
    if components > 1:
        flops += m * fwd_ops(observed)
    return flops
