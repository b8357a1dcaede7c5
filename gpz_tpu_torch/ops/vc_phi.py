"""Full-covariance (GC/VC) design matrix on complete rows and its gradient: a
pair of CUDA kernels for Hopper and their plain PyTorch twins.

For every (sample i, basis j) pair, with A = Psi_i + Sigma_j,

    lnPHI_ij = -1/2 Delta' A^-1 Delta + 1/2 log|Sigma_j| - 1/2 log|A|

and, for a cotangent g (n, m), with h = A^-1 Delta,

    dP_j = sum_i g_ij h_ij        dSigma_j = sum_i g_ij (h h' - A^-1) / 2
    d logdet_Sigma_j = sum_i g_ij / 2

The kernels (csrc/vc_phi.cu) replace gpz_tpu/ops/vc_phi.py::_fwd_kernel and
::_bwd_kernel. They are written for the H100's FP64 pipe: a Cholesky in
reciprocal form (one rsqrt per column, no division, no square root, one
logarithm per pair), every thread of a block at work whatever m is, and a
grid of one whole wave of equal blocks; the source note says what bounds
them. A table in the source sends each d to one design: to d = 18 in the
forward and 13 in the backward templates that hold a pair's factor in
registers (past d = 8 the backward's sums in shared memory), from there to
d = 32 a group of 16 or 32 threads per pair with a row of the factor in
each lane's registers, and any wider d
to kernels with d a runtime argument whose pairs work in a strided
workspace in shared memory (or, past what it holds, in a global scratch
that `_workspace` allocates).
They are built with nvcc at first use into gpz_tpu_torch/_build/, keyed by
a hash of the source and the flags (no fast-math flag among them), in
parallel parts linked into one library, and loaded with ctypes.

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
import re
import subprocess
import time

import torch

from gpz_tpu_torch.linalg import quad_logdet_psd, unrolled_inv_psd

#: launches of the forward and of the backward kernel (callers may reset
#: them to 0); the backward's two passes count as one launch
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

#: row block of the plain path, and the size of its (rows, m, d, d) working
#: set at m=100, d=5, which bounds the block for wider calls (the pair pass
#: of prediction passes thousands of pairs as bases)
PHI_BLOCK_ROWS = 4096
PLAIN_BLOCK_ELEMS = 4096 * 100 * 25

#: most elements of the (n, m) output or cotangent of one call: the library
#: takes n and m as C ints and carries every product of them in size_t, and a
#: call past this raises instead of reaching the card (a lockstep of R sets
#: at 10**6 rows and m = 1000 would be R * 10**9)
MAX_PAIRS = 2**31 - 1

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "vc_phi.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIB = None


def _plain_rows(m: int, d: int) -> int:
    """Rows per block of the plain path: PHI_BLOCK_ROWS, fewer where that
    many (rows, m, d, d) systems would exceed PLAIN_BLOCK_ELEMS."""
    return max(1, min(PHI_BLOCK_ROWS, PLAIN_BLOCK_ELEMS // max(1, m * d * d)))


def parts(src: bytes) -> int:
    """Parts a library source is compiled as: one more than the highest k
    of its GPZ_IN_PART(k), 1 for a source without."""
    ks = [int(k) for k in re.findall(rb"GPZ_IN_PART\((\d+)\)", src)]
    return max(ks) + 1 if ks else 1


def build(src: bytes | None = None, name: str = "libgpz_vc_phi") -> str:
    """Compile csrc/vc_phi.cu (or the library source `src`) once per
    source/flags hash, as `parts(src)` objects (-DGPZ_PART=k), one nvcc
    process each, all started together, linked into one shared library;
    returns its path. nvcc's output, with ptxas' register and shared memory
    report and each part's seconds, is kept beside it as <library>.log."""
    from torch.utils.cpp_extension import CUDA_HOME

    if src is None:
        with open(SOURCE, "rb") as fh:
            src = fh.read()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"{name}-{key}.so")
    if os.path.exists(so):
        return so
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME) to build "
                           f"{SOURCE}")
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    tmp = f"{so}.{os.getpid()}"
    with open(f"{tmp}.cu", "wb") as fh:
        fh.write(src)
    count = parts(src)
    objs = [f"{tmp}.{k}.o" for k in range(count)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-c", *([f"-DGPZ_PART={k}"] if count > 1 else []),
         "-o", obj, f"{tmp}.cu"], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, obj in enumerate(objs)]
    logs = []
    for k, proc in enumerate(procs):
        out, _ = proc.communicate()
        logs.append(f"part {k}: exit {proc.returncode} after "
                    f"{time.perf_counter() - t0:.2f} s\n{out}")
    failed = [k for k, proc in enumerate(procs) if proc.returncode]
    if not failed:
        res = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.tmp", *objs],
                             capture_output=True, text=True, check=False)
        logs.append(f"link: exit {res.returncode}\n{res.stdout}{res.stderr}")
        if res.returncode:
            failed = ["link"]
    with open(so[:-3] + ".log", "w") as fh:
        fh.write("".join(logs))
    for path in (*objs, f"{tmp}.cu"):
        if os.path.exists(path):
            os.remove(path)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}) building {name}:\n"
                           + "".join(logs)[-6000:])
    # atomic: a concurrent build never loads a partial file
    os.replace(f"{tmp}.tmp", so)
    return so


def library() -> ctypes.CDLL:
    """The kernel library, built and loaded at first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        lib.gpz_vc_lnphi_fwd.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        )
        lib.gpz_vc_lnphi_fwd.restype = ctypes.c_int
        lib.gpz_vc_lnphi_bwd.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
        )
        lib.gpz_vc_lnphi_bwd.restype = ctypes.c_int
        lib.gpz_vc_lnphi_bwd_spans.argtypes = [ctypes.c_int] * 5
        lib.gpz_vc_lnphi_bwd_spans.restype = ctypes.c_int
        lib.gpz_vc_lnphi_workspace.argtypes = [ctypes.c_int] * 6
        lib.gpz_vc_lnphi_workspace.restype = ctypes.c_longlong
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
    if n * m > MAX_PAIRS:
        raise ValueError(f"{n} rows x {m} bases = {n * m} pairs, more than "
                         f"the {MAX_PAIRS} one call takes")
    if X.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be float32 or float64, got {X.dtype}")
    if d < 1:
        raise ValueError(f"d must be at least 1, got {d}")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {X.device}")
    return n, m, d


def _workspace(lib, X, n, m, sets, d, backward):
    """The strided-workspace kernels' global scratch for a call (None where
    their workspaces lie in shared memory, and for d <= 32)."""
    is_double = int(X.dtype == torch.float64)
    elems = lib.gpz_vc_lnphi_workspace(n, m, sets, d, is_double,
                                       int(backward))
    if elems < 0:
        raise RuntimeError("vc_lnphi: no launch plan for "
                           f"n={n}, m={m}, d={d} on {X.device}")
    if not elems:
        return None
    return torch.empty(elems, dtype=X.dtype, device=X.device)


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
        ws = _workspace(lib, X, n, m, 1, d, backward=False)
        err = lib.gpz_vc_lnphi_fwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            logdet_Sigma.data_ptr(), out.data_ptr(), n, m, d,
            int(X.dtype == torch.float64),
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _raise_on(err, "vc_lnphi forward")
    LAUNCHES_FWD += 1
    return out


def vc_lnphi_bwd(X, psi, P, Sigma, g, sets=1):
    """(dP (m, d), dSigma (m, d, d)) for the cotangent g (n, m) of lnPHI, by
    the backward kernel (CUDA tensors) or `vc_lnphi_bwd_plain` (CPU
    tensors). Two calls on the same CUDA inputs give the same bits: the
    kernel sums each block's span of rows (a span is as long as one wave of
    blocks needs) and then the spans, each in a fixed order, with no
    atomics. `sets` (dividing m): the bases are that many equal runs, the
    parameter sets of a batched evaluation, and the sums are planned for
    one run, so that each run's dP and dSigma have the bits of a call on its
    bases alone."""
    global LAUNCHES_BWD
    n, m, d = _check(X, psi, P, Sigma, g=g)
    if sets < 1 or m % sets:
        raise ValueError(f"{m} bases are not {sets} equal sets")
    if X.device.type == "cpu":
        return vc_lnphi_bwd_plain(X, psi, P, Sigma, g, sets)
    dP = torch.empty_like(P)
    dSigma = torch.empty_like(Sigma)
    if m == 0:
        return dP, dSigma
    if n == 0:
        return dP.zero_(), dSigma.zero_()
    lib = library()
    is_double = int(X.dtype == torch.float64)
    with torch.cuda.device(X.device):
        # scratch: one partial per span of rows of the first pass
        spans = lib.gpz_vc_lnphi_bwd_spans(n, m, sets, d, is_double)
        if spans < 1:
            raise RuntimeError("vc_lnphi backward: no launch plan for "
                               f"n={n}, m={m}, d={d} on {X.device}")
        partial = torch.empty((spans, d + d * d, m), dtype=X.dtype,
                              device=X.device)
        ws = _workspace(lib, X, n, m, sets, d, backward=True)
        err = lib.gpz_vc_lnphi_bwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            g.data_ptr(), partial.data_ptr(), dP.data_ptr(),
            dSigma.data_ptr(), n, m, sets, d, is_double,
            None if ws is None else ws.data_ptr(),
            torch.cuda.current_stream(X.device).cuda_stream,
        )
    _raise_on(err, "vc_lnphi backward")
    LAUNCHES_BWD += 1
    return dP, dSigma


class VcLnPhi(torch.autograd.Function):
    """lnPHI with its analytic vector-Jacobian product; both directions go
    to the kernels on CUDA tensors and to the plain twins on CPU tensors."""

    @staticmethod
    def forward(ctx, X, psi, P, Sigma, logdet_Sigma, sets):
        ctx.save_for_backward(X, psi, P, Sigma)
        ctx.sets = sets
        return _forward(X, psi, P, Sigma, logdet_Sigma)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        X, psi, P, Sigma = ctx.saved_tensors
        dP, dSigma = vc_lnphi_bwd(X, psi, P, Sigma, g.contiguous(), ctx.sets)
        d_lds = g.sum(0)
        if ctx.sets > 1:
            # each set's column sums as alone (a sum over rows is planned by
            # the number of columns it makes)
            d_lds = torch.cat([c.contiguous().sum(0)
                               for c in g.chunk(ctx.sets, dim=1)])
        return None, None, dP, dSigma, 0.5 * d_lds, None


def vc_lnphi_complete(X, psi, P, Sigma, logdet_Sigma, sets=1):
    """lnPHI (n, m) for complete data with full-covariance input noise.

    X (n, d); psi (n, d, d); P (m, d); Sigma (m, d, d); logdet_Sigma (m,):
    contiguous, one dtype (float32 or float64), one device, d >= 1 (the
    kernels' register templates to d = 18 forward and 13 backward, their
    thread groups to d = 32, a strided workspace past that).
    Only the lower triangles of psi and Sigma are read. Differentiable in P,
    Sigma and logdet_Sigma; X and psi are data. `sets`: the bases are that
    many equal runs, one per parameter set of a batched evaluation, and the
    gradient of each run is that of a call on its bases alone (each pair's
    lnPHI is so whatever the call).
    """
    if torch.is_grad_enabled() and (X.requires_grad or psi.requires_grad):
        raise RuntimeError("vc_lnphi_complete has no gradient in X or psi: "
                           "they are data; detach them")
    if sets < 1 or P.shape[0] % sets:
        raise ValueError(f"{P.shape[0]} bases are not {sets} equal sets")
    return VcLnPhi.apply(X, psi, P, Sigma, logdet_Sigma, sets)


def vc_lnphi_plain(X, psi, P, Sigma, logdet_Sigma):
    """The same function in plain PyTorch: linalg.quad_logdet_psd on the
    (rows, m, d, d) systems, a block of rows at a time (`_plain_rows`)."""
    outs = [X.new_empty((0, P.shape[0]))]
    rows = _plain_rows(P.shape[0], X.shape[1])
    for r0 in range(0, X.shape[0], rows):
        Xb = X[r0:r0 + rows]
        A = psi[r0:r0 + rows, None] + Sigma[None]
        quad, logdet_A = quad_logdet_psd(A, Xb[:, None, :] - P[None])
        outs.append(-0.5 * quad + 0.5 * logdet_Sigma[None] - 0.5 * logdet_A)
    return torch.cat(outs)


def vc_lnphi_bwd_plain(X, psi, P, Sigma, g, sets=1):
    """(dP, dSigma) in plain PyTorch, by the kernel's analytic formulas:
    linalg.unrolled_inv_psd gives A^-1 on the (rows, m, d, d) systems, then
    h = A^-1 Delta; a block of rows at a time, blocks summed in order.
    The upper triangle of dSigma is mirrored into the lower, as the kernel
    writes it. With `sets`, each equal run of bases is computed as a call
    of its own."""
    if sets > 1:
        runs = zip(P.chunk(sets), Sigma.chunk(sets), g.chunk(sets, dim=1))
        return tuple(torch.cat(t) for t in zip(*(
            vc_lnphi_bwd_plain(X, psi, p, s, c.contiguous())
            for p, s, c in runs)))
    dP = torch.zeros_like(P)
    dSigma = torch.zeros_like(Sigma)
    step = _plain_rows(P.shape[0], X.shape[1])
    for r0 in range(0, X.shape[0], step):
        rows = slice(r0, r0 + step)
        gb = g[rows]
        Ainv, _ = unrolled_inv_psd(psi[rows, None] + Sigma[None])
        h = torch.einsum("nmab,nmb->nma", Ainv, X[rows, None, :] - P[None])
        dP += torch.einsum("nm,nma->ma", gb, h)
        dSigma += 0.5 * (torch.einsum("nm,nma,nmb->mab", gb, h, h)
                         - torch.einsum("nm,nmab->mab", gb, Ainv))
    return dP, dSigma.triu() + dSigma.triu(1).transpose(1, 2)
