"""Percent of the traced window's device busy time spent in the batched
d x d Cholesky factorisations and triangular solves that the masked
design matrix runs past linalg's unroll_max (torch.linalg.cholesky_ex and
solve_triangular, forward and backward): kernels whose names hold one of
FRAGMENTS; nothing where none ran."""

#: name fragments of those kernels on the H100's trace (torch 2.11,
#: CUDA 12.8): the batched Cholesky (potrf_cta_lower_batch and its
#: potrf_reset_info / potrf_set_info) and cuBLAS's batched triangular
#: solves (batch_trsm_left_kernel, batch_trsm_right_kernel,
#: trsm_batch_left_lower_kernel, trsm_batch_left_upper_kernel); the m x m
#: solves of the objective (trsm_left_kernel, getrf_wo_pivot) match none
FRAGMENTS = ("potrf_", "batch_trsm_", "trsm_batch_")


def read(r):
    busy = r.trace["busy_s"]
    solves = sum(s for name, s in r.trace["device_s"].items()
                 if any(f in name for f in FRAGMENTS))
    if busy <= 0 or solves <= 0:
        return None
    return 100.0 * solves / busy
