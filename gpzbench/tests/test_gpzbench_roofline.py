"""The frozen work counts: closed forms at d = 5 and 9, and counts that
depend on shapes alone."""

import pytest

from gpzbench import roofline


def closed_fwd(d):
    """lower triangle of A, the Cholesky sum_c (2c+1)(d-c), d logs, the
    substitution d^2, two dot products and 4 to assemble."""
    return (d * (d + 1) // 2 + (2 * d - 1) * d * (d - 1) // 6 + d * d + d
            + d * d + 2 * (2 * d - 1) + 4)


def closed_bwd(d):
    """the forward's factorisation and substitution, the back substitution,
    the triangular inverse d + sum_t (t^2 + 2t), the upper triangle of
    A^-1 sum_s s^2, and the 6 d(d+1)/2 accumulations."""
    nt = d * (d + 1) // 2
    chol = (2 * d - 1) * d * (d - 1) // 6 + d * d
    invert = d + (d - 1) * d * (2 * d - 1) // 6 + d * (d - 1)
    a_inv = d * (d + 1) * (2 * d + 1) // 6
    return nt + chol + d + 2 * d * d + 2 * d + invert + a_inv + 6 * nt


@pytest.mark.parametrize("d, fwd, bwd", [(5, 122, 335), (9, 458, 1359)])
def test_counts_closed_form(d, fwd, bwd):
    assert roofline.fwd_ops(d) == closed_fwd(d) == fwd
    assert roofline.bwd_ops(d) == closed_bwd(d) == bwd


@pytest.mark.parametrize("kind", ["fwd", "bwd"])
def test_least_time_is_shape_arithmetic(kind):
    a = roofline.least_seconds(kind, 70_000, 100, 5, "float64")
    assert a == roofline.least_seconds(kind, 70_000, 100, 5, "float64")
    ops, elems = roofline.kernel_work(kind, 70_000, 100, 5)
    assert a == max(ops / 67e12, elems * 8 / 3.35e12)
    # twice the rows: twice the operations; bytes grow with rows too
    ops2, _ = roofline.kernel_work(kind, 140_000 * 256, 100, 5)
    ops1, _ = roofline.kernel_work(kind, 70_000 * 256, 100, 5)
    assert ops2 == 2 * ops1


def test_evaluation_and_row_counts():
    n, m, d = 1_000_000, 1000, 5
    assert roofline.evaluation_flops(n, m, d, 1) == (
        n * m * (122 + 335) + 6 * n * m * m + 10 * n * m
        + m ** 3 // 3 + m ** 3 + 4 * m * m)
    assert roofline.score_flops(100_000, m, d, 1) == 100_000 * m * 122 \
        + 4 * 100_000 * m
    one = roofline.served_row_flops(100, 5, 1, 1, 5)
    assert one == (100 + 100 ** 2) * 122 + 400 + 60_000
    mix = roofline.served_row_flops(100, 5, 1, 64, 4)
    assert mix == 64 * (100 + 100 ** 2) * 122 + 400 + 60_000 \
        + 100 * roofline.fwd_ops(4)
    assert roofline.PEAK_FLOPS == {"float64": 67e12, "float32": 67e12}
    assert roofline.PEAK_BYTES_PER_S == 3.35e12
