"""ctypes bindings for the native C++ runtime kernels (gpz_tpu.native.ffi).

The reference's only native code is 4 MEX C files backing minFunc
(SURVEY §2.3). Their roles here:
  * training on the GPU runs the two-loop recursion on device tensors
    (optim/lbfgs.py) — no host kernel needed on the hot path;
  * `lbfgs_direction`/`lbfgs_add` back the host-resident optimizer
    (optim/host_lbfgs.py) for driving external/NumPy objectives
    (parity: lbfgsProdC.c, lbfgsAddC.c, lbfgsC.c);
  * `modified_cholesky` is the Gill–Murray LDL^T of mcholC.c;
  * `read_csv` is the data-loader replacement for MATLAB csvread
    (demo_photoz.m:41) built for multi-GB catalogs.

The sources are this package's copies of gpz_tpu's (lbfgs_kernels.cpp,
csv_reader.cpp). The shared library is compiled with g++ ($CXX) at first use
into gpz_tpu_torch/_build/, under a name keyed by a hash of the sources, the
compiler and the flags, through a temporary file and an atomic rename, so
processes that build at once each load a whole library. If no compiler is
available, `available()` returns False and the callers run the NumPy
versions of the same algorithms.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRCS = ("lbfgs_kernels.cpp", "csv_reader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Path of the built library, compiling it if this source/compiler/flags
    hash has none yet; None when the compiler is missing or fails."""
    srcs = [os.path.join(_DIR, s) for s in _SRCS]
    cxx = os.environ.get("CXX", "g++")
    key = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as fh:
            key.update(fh.read())
    key.update(" ".join((cxx, *CXX_FLAGS)).encode())
    so = os.path.join(BUILD_DIR, f"libgpz_native-{key.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *srcs], check=True,
                       capture_output=True, cwd=_DIR)
    except (subprocess.CalledProcessError, FileNotFoundError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return None
    # atomic: a concurrent build never loads a partial file
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        lib = ctypes.CDLL(path)

        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int64)
        i64 = ctypes.c_int64
        dbl = ctypes.c_double

        lib.gpz_lbfgs_direction.argtypes = [dp, dp, i64, i64, i64, i64, dbl, dp, dp]
        lib.gpz_lbfgs_direction.restype = None
        lib.gpz_lbfgs_add.argtypes = [dp, dp, i64, i64, ip, ip, dp, dp, dp]
        lib.gpz_lbfgs_add.restype = ctypes.c_int
        lib.gpz_mchol.argtypes = [dp, i64, dp, ip]
        lib.gpz_mchol.restype = ctypes.c_int
        lib.gpz_csv_dims.argtypes = [ctypes.c_char_p, ip, ip]
        lib.gpz_csv_dims.restype = ctypes.c_int
        lib.gpz_csv_read.argtypes = [ctypes.c_char_p, dp, i64, i64, i64]
        lib.gpz_csv_read.restype = i64

        _lib = lib
        return _lib


def available() -> bool:
    """True when the native library runs; False when the NumPy fallbacks do."""
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lbfgs_direction(S, Y, count: int, pos: int, hdiag: float, g) -> np.ndarray:
    """d = -H g via the native two-loop recursion (ref lbfgsProdC.c)."""
    lib = _load()
    S = np.ascontiguousarray(S, dtype=np.float64)
    Y = np.ascontiguousarray(Y, dtype=np.float64)
    g = np.ascontiguousarray(g, dtype=np.float64)
    history, p = S.shape
    d = np.empty(p, dtype=np.float64)
    if lib is None:  # NumPy fallback, same algorithm
        q = g.copy()
        al = np.zeros(count)
        rho = np.zeros(count)
        idxs = [((pos - 1 - i) % history) for i in range(count)]
        for i, j in enumerate(idxs):
            sy = float(S[j] @ Y[j])
            rho[i] = 1.0 / sy if sy > 1e-30 else 0.0
            al[i] = rho[i] * float(S[j] @ q)
            q -= al[i] * Y[j]
        q *= hdiag
        for i in reversed(range(count)):
            j = idxs[i]
            b = rho[i] * float(Y[j] @ q)
            q += (al[i] - b) * S[j]
        return -q
    lib.gpz_lbfgs_direction(
        _dp(S), _dp(Y), history, p, count, pos, float(hdiag), _dp(g), _dp(d)
    )
    return d


def lbfgs_add(S, Y, count: int, pos: int, hdiag: float, s, y
              ) -> Tuple[int, int, float, bool]:
    """Insert a curvature pair in place (ref lbfgsAddC.c). Returns
    (count, pos, hdiag, accepted)."""
    lib = _load()
    history, p = S.shape
    s = np.ascontiguousarray(s, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    ys = float(y @ s)
    if lib is None:
        if not ys > 1e-10:
            return count, pos, hdiag, False
        S[pos] = s
        Y[pos] = y
        return min(count + 1, history), (pos + 1) % history, ys / float(y @ y), True
    c = ctypes.c_int64(count)
    ppos = ctypes.c_int64(pos)
    h = ctypes.c_double(hdiag)
    ok = lib.gpz_lbfgs_add(
        _dp(S), _dp(Y), history, p,
        ctypes.byref(c), ctypes.byref(ppos), ctypes.byref(h), _dp(s), _dp(y),
    )
    return int(c.value), int(ppos.value), float(h.value), bool(ok)


def modified_cholesky(A) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Gill–Murray modified LDL^T with pivoting (ref mcholC.c): returns
    (L unit-lower, d positive diagonal, perm) with
    (A + E)[perm][:, perm] = L diag(d) L^T for some minimal diagonal E."""
    lib = _load()
    A = np.array(A, dtype=np.float64, order="C")
    n = A.shape[0]
    d = np.empty(n, dtype=np.float64)
    perm = np.empty(n, dtype=np.int64)
    if lib is None:
        return _mchol_numpy(A)
    rc = lib.gpz_mchol(_dp(A), n, _dp(d),
                       perm.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    if rc != 0:
        raise RuntimeError("gpz_mchol failed")
    return A, d, perm


def _mchol_numpy(A):
    """NumPy fallback for the Gill–Murray factorization."""
    n = A.shape[0]
    gamma = np.abs(np.diag(A)).max() if n else 0.0
    off = A - np.diag(np.diag(A))
    xi = np.abs(off).max() if n > 1 else 0.0
    nd = max(n * n - n, 1)
    delta = 1e-12 * max(gamma + xi, 1.0)
    beta2 = max(gamma, xi / np.sqrt(nd), 1e-12)
    c = np.zeros((n, n))
    np.fill_diagonal(c, np.diag(A))
    L = np.zeros((n, n))
    d = np.zeros(n)
    perm = np.arange(n, dtype=np.int64)
    for j in range(n):
        # choose pivot with max |c_ii| among remaining
        vals = [abs(c[perm[i], perm[i]]) for i in range(j, n)]
        q = j + int(np.argmax(vals))
        perm[[j, q]] = perm[[q, j]]
        pj = perm[j]
        for s in range(j):
            L[j, s] = c[pj, perm[s]] / d[s]
        theta = 0.0
        for i in range(j + 1, n):
            pi = perm[i]
            cij = A[pi, pj] - sum(L[j, s] * c[pi, perm[s]] for s in range(j))
            c[pi, pj] = cij
            c[pj, pi] = cij
            theta = max(theta, abs(cij))
        d[j] = max(abs(c[pj, pj]), theta * theta / beta2, delta)
        for i in range(j + 1, n):
            pi = perm[i]
            c[pi, pi] -= c[pi, pj] ** 2 / d[j]
    Lout = np.tril(L, -1) + np.eye(n)
    return Lout, d, perm


def read_csv(path: str, skip_rows: int = 0) -> np.ndarray:
    """Parse a CSV of floats into an (n, cols) float64 array; empty fields
    and 'nan' become NaN. Native mmap parser with numpy fallback."""
    lib = _load()
    if lib is None:
        return np.genfromtxt(path, delimiter=",", skip_header=skip_rows)
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    rc = lib.gpz_csv_dims(path.encode(), ctypes.byref(rows), ctypes.byref(cols))
    if rc != 0:
        raise OSError(f"cannot read {path}")
    r, c = rows.value - skip_rows, cols.value
    out = np.empty((r, c), dtype=np.float64)
    got = lib.gpz_csv_read(path.encode(), _dp(out), r, c, skip_rows)
    if got < 0:
        raise OSError(f"csv parse failed for {path}")
    return out[:got]
