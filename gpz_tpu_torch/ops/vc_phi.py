"""Full-covariance (GC/VC) design matrix on complete rows: a CUDA kernel for
Hopper and its plain PyTorch twin.

For every (sample i, basis j) pair, with A = Psi_i + Sigma_j,

    lnPHI_ij = -1/2 Delta' A^-1 Delta + 1/2 log|Sigma_j| - 1/2 log|A|

The kernel (csrc/vc_phi.cu) replaces gpz_tpu/ops/vc_phi.py::_fwd_kernel; its
source note says what bounds it and why its design is simple. It is built
with nvcc at first use into gpz_tpu_torch/_build/, keyed by a hash of the
source and the flags, and loaded with ctypes.

`vc_lnphi_complete` launches the kernel for CUDA tensors and runs
`vc_lnphi_plain` for CPU tensors; nothing falls back from one to the other.
Forward only: the backward kernel and the autograd.Function come with the
training path, so inputs that require a gradient are refused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from gpz_tpu_torch.linalg import quad_logdet_psd

#: kernel launches by vc_lnphi_complete (callers may reset it to 0)
LAUNCHES = 0

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
        lib.gpz_cuda_error_string.argtypes = [ctypes.c_int]
        lib.gpz_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check(X, psi, P, Sigma, logdet_Sigma):
    """Validate what the kernel takes (on every device, so the CPU path
    refuses exactly what the CUDA path would); returns (n, m, d)."""
    args = {"X": X, "psi": psi, "P": P, "Sigma": Sigma,
            "logdet_Sigma": logdet_Sigma}
    if X.dim() != 2:
        raise ValueError(f"X must be (n, d), got {tuple(X.shape)}")
    n, d = X.shape
    m = P.shape[0] if P.dim() == 2 else -1
    want = {"X": (n, d), "psi": (n, d, d), "P": (m, d), "Sigma": (m, d, d),
            "logdet_Sigma": (m,)}
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in args.values()):
        raise RuntimeError("vc_lnphi_complete has no backward yet; call it "
                           "under torch.no_grad()")
    return n, m, d


def vc_lnphi_complete(X, psi, P, Sigma, logdet_Sigma):
    """lnPHI (n, m) for complete data with full-covariance input noise.

    X (n, d); psi (n, d, d); P (m, d); Sigma (m, d, d); logdet_Sigma (m,):
    contiguous, one dtype (float32 or float64), one device, 1 <= d <= 8.
    Only the lower triangles of psi and Sigma are read.
    """
    global LAUNCHES
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
    if err:
        raise RuntimeError("vc_lnphi kernel launch failed: "
                           + lib.gpz_cuda_error_string(err).decode())
    LAUNCHES += 1
    return out


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
