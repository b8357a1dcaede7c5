"""Full-covariance (GC/VC) design matrix on complete rows and its gradient: a
pair of CUDA kernels for Hopper and their plain PyTorch twins.

For every (sample i, basis j) pair, with A = Psi_i + Sigma_j,

    lnPHI_ij = -1/2 Delta' A^-1 Delta + 1/2 log|Sigma_j| - 1/2 log|A|

and, for a cotangent g (n, m), with h = A^-1 Delta,

    dP_j = sum_i g_ij h_ij        dSigma_j = sum_i g_ij (h h' - A^-1) / 2
    d logdet_Sigma_j = sum_i g_ij / 2

The kernels (csrc/vc_phi.cu) replace gpz_tpu/ops/vc_phi.py::_fwd_kernel and
::_bwd_kernel; the source note says what bounds them and why their design is
simple. They are built with nvcc at first use into gpz_tpu_torch/_build/,
keyed by a hash of the source and the flags, and loaded with ctypes.

`vc_lnphi_complete` is differentiable in P, Sigma and logdet_Sigma through
the autograd.Function `VcLnPhi`; X and psi are data, and asking for their
gradient raises. For CUDA tensors forward and backward launch the kernels;
for CPU tensors they run `vc_lnphi_plain` and `vc_lnphi_bwd_plain`. Nothing
falls back from one to the other. dSigma is the symmetric cotangent (half of
an off-diagonal pair's derivative in each triangle), as gpz_tpu's kernel
writes it, although only the lower triangle of Sigma is read.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from gpz_tpu_torch.linalg import quad_logdet_psd, unrolled_inv_psd

#: launches of the forward and of the backward kernel (callers may reset
#: them to 0); the backward's two passes count as one launch
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

#: row block of the plain path: bounds its (rows, m, d, d) working set
PHI_BLOCK_ROWS = 4096

#: largest d the kernel is compiled for (linalg's unroll_max)
D_MAX = 8

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "vc_phi.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None


def build() -> str:
    """Compile csrc/vc_phi.cu (once per source/flags hash); returns the
    shared library's path. nvcc's output, with ptxas' register and shared
    memory report, is kept beside it as <library>.log."""
    from torch.utils.cpp_extension import CUDA_HOME

    with open(SOURCE, "rb") as fh:
        src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"libgpz_vc_phi-{key}.so")
    if os.path.exists(so):
        return so
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           f"{SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS, "-o", tmp,
           SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    with open(so[:-3] + ".log", "w") as fh:
        fh.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}): {' '.join(cmd)}\n{res.stderr}"
        )
    # atomic: a concurrent build never loads a partial file
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.gpz_vc_lnphi_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.gpz_vc_lnphi_fwd.restype = ctypes.c_int
        lib.gpz_vc_lnphi_bwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        )
        lib.gpz_vc_lnphi_bwd.restype = ctypes.c_int
        lib.gpz_vc_lnphi_bwd_rows.argtypes = []
        lib.gpz_vc_lnphi_bwd_rows.restype = ctypes.c_int
        lib.gpz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gpz_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(X, psi, P, Sigma, logdet_Sigma=None, g=None):
    """Validate what the kernels take (on every device, so the CPU path
    refuses exactly what the CUDA path would); returns (n, m, d)."""
    args = {"X": X, "psi": psi, "P": P, "Sigma": Sigma}
    if logdet_Sigma is not None:
        args["logdet_Sigma"] = logdet_Sigma
    if g is not None:
        args["g"] = g
    if X.dim() != 2:
        raise ValueError(f"X must be (n, d), got {tuple(X.shape)}")
    n, d = X.shape
    m = P.shape[0] if P.dim() == 2 else -1
    want = {"X": (n, d), "psi": (n, d, d), "P": (m, d), "Sigma": (m, d, d),
            "logdet_Sigma": (m,), "g": (n, m)}
    for name, t in args.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != X.dtype or t.device != X.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; X is "
                             f"{X.dtype} on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {X.dtype}")
    if not 1 <= d <= D_MAX:
        raise ValueError(f"d must be in 1..{D_MAX}, got {d}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    return n, m, d


def _raise_on(err: int, what: str):
    if err:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + library().gpz_cuda_error_string(err).decode())


def _forward(X, psi, P, Sigma, logdet_Sigma):
    """lnPHI by the kernel (CUDA tensors) or its plain twin (CPU tensors)."""
    global LAUNCHES_FWD
    n, m, d = _check(X, psi, P, Sigma, logdet_Sigma)
    if X.device.type == "cpu":
        return vc_lnphi_plain(X, psi, P, Sigma, logdet_Sigma)
    out = torch.empty((n, m), dtype=X.dtype, device=X.device)
    if n == 0 or m == 0:
        return out
    lib = library()
    with torch.cuda.device(X.device):
        err = lib.gpz_vc_lnphi_fwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            logdet_Sigma.data_ptr(), out.data_ptr(), n, m, d,
            int(X.dtype == torch.float64),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _raise_on(err, "vc_lnphi forward")
    LAUNCHES_FWD += 1
    return out


def vc_lnphi_bwd(X, psi, P, Sigma, g):
    """(dP (m, d), dSigma (m, d, d)) for the cotangent g (n, m) of lnPHI, by
    the backward kernel (CUDA tensors) or `vc_lnphi_bwd_plain` (CPU
    tensors). Two calls on the same CUDA inputs give the same bits: the
    kernel sums per 256-row tile and then over tiles, each in a fixed order,
    with no atomics."""
    global LAUNCHES_BWD
    n, m, d = _check(X, psi, P, Sigma, g=g)
    if X.device.type == "cpu":
        return vc_lnphi_bwd_plain(X, psi, P, Sigma, g)
    dP = torch.empty_like(P)
    dSigma = torch.empty_like(Sigma)
    if m == 0:
        return dP, dSigma
    if n == 0:
        return dP.zero_(), dSigma.zero_()
    lib = library()
    tiles = -(-n // lib.gpz_vc_lnphi_bwd_rows())
    partial = torch.empty((tiles, d + d * d, m), dtype=X.dtype,
                          device=X.device)
    with torch.cuda.device(X.device):
        err = lib.gpz_vc_lnphi_bwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            g.data_ptr(), partial.data_ptr(), dP.data_ptr(),
            dSigma.data_ptr(), n, m, d, int(X.dtype == torch.float64),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _raise_on(err, "vc_lnphi backward")
    LAUNCHES_BWD += 1
    return dP, dSigma


class VcLnPhi(torch.autograd.Function):
    """lnPHI with its analytic vector-Jacobian product; both directions go
    to the kernels on CUDA tensors and to the plain twins on CPU tensors."""

    @staticmethod
    def forward(ctx, X, psi, P, Sigma, logdet_Sigma):
        ctx.save_for_backward(X, psi, P, Sigma)
        return _forward(X, psi, P, Sigma, logdet_Sigma)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        X, psi, P, Sigma = ctx.saved_tensors
        dP, dSigma = vc_lnphi_bwd(X, psi, P, Sigma, g.contiguous())
        return None, None, dP, dSigma, 0.5 * g.sum(0)


def vc_lnphi_complete(X, psi, P, Sigma, logdet_Sigma):
    """lnPHI (n, m) for complete data with full-covariance input noise.

    X (n, d); psi (n, d, d); P (m, d); Sigma (m, d, d); logdet_Sigma (m,):
    contiguous, one dtype (float32 or float64), one device, 1 <= d <= 8.
    Only the lower triangles of psi and Sigma are read. Differentiable in P,
    Sigma and logdet_Sigma; X and psi are data.
    """
    if torch.is_grad_enabled() and (X.requires_grad or psi.requires_grad):
        raise RuntimeError("vc_lnphi_complete has no gradient in X or psi: "
                           "they are data; detach them")
    return VcLnPhi.apply(X, psi, P, Sigma, logdet_Sigma)


def vc_lnphi_plain(X, psi, P, Sigma, logdet_Sigma):
    """The same function in plain PyTorch: linalg.quad_logdet_psd on the
    (rows, m, d, d) systems, PHI_BLOCK_ROWS rows at a time."""
    outs = [X.new_empty((0, P.shape[0]))]
    for r0 in range(0, X.shape[0], PHI_BLOCK_ROWS):
        Xb = X[r0:r0 + PHI_BLOCK_ROWS]
        A = psi[r0:r0 + PHI_BLOCK_ROWS, None] + Sigma[None]
        quad, logdet_A = quad_logdet_psd(A, Xb[:, None, :] - P[None])
        outs.append(-0.5 * quad + 0.5 * logdet_Sigma[None] - 0.5 * logdet_A)
    return torch.cat(outs)


def vc_lnphi_bwd_plain(X, psi, P, Sigma, g):
    """(dP, dSigma) in plain PyTorch, by the kernel's analytic formulas:
    linalg.unrolled_inv_psd gives A^-1 on the (rows, m, d, d) systems, then
    h = A^-1 Delta; PHI_BLOCK_ROWS rows at a time, blocks summed in order.
    The upper triangle of dSigma is mirrored into the lower, as the kernel
    writes it."""
    dP = torch.zeros_like(P)
    dSigma = torch.zeros_like(Sigma)
    for r0 in range(0, X.shape[0], PHI_BLOCK_ROWS):
        rows = slice(r0, r0 + PHI_BLOCK_ROWS)
        gb = g[rows]
        Ainv, _ = unrolled_inv_psd(psi[rows, None] + Sigma[None])
        h = torch.einsum("nmab,nmb->nma", Ainv, X[rows, None, :] - P[None])
        dP += torch.einsum("nm,nma->ma", gb, h)
        dSigma += 0.5 * (torch.einsum("nm,nma,nmb->mab", gb, h, h)
                         - torch.einsum("nm,nmab->mab", gb, Ainv))
    return dP, dSigma.triu() + dSigma.triu(1).transpose(1, 2)
