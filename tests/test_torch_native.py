"""gpz_tpu_torch.native against gpz_tpu.native on seeded NumPy inputs.

Both packages compile the same C++ sources with the same compiler and flags,
and keep the same NumPy fallbacks, so every result is held equal to the bit
(assert_array_equal), on the native path and on the NumPy path alike. The
NumPy path is taken by making each package's loader report no library.
"""

import os
import subprocess
import sys

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest

from gpz_tpu.native import ffi as jffi

from gpz_tpu_torch.native import ffi as tffi

from make_torch_port_golden import ROOT

PATHS = ("native", "numpy")


@pytest.fixture(params=PATHS)
def path(request, monkeypatch):
    """Both packages on the native library, or both on their fallbacks."""
    if request.param == "native":
        assert tffi.available() and jffi.available()
    else:
        monkeypatch.setattr(tffi, "_load", lambda: None)
        monkeypatch.setattr(jffi, "_load", lambda: None)
    return request.param


def both(name, *args):
    """(port's result, gpz_tpu's result) of ffi.<name> on copies of args."""
    def copies():
        return [a.copy() if isinstance(a, np.ndarray) else a for a in args]
    return getattr(tffi, name)(*copies()), getattr(jffi, name)(*copies())


def test_library_builds_into_the_build_dir_under_a_hashed_name():
    assert tffi.available()
    so = tffi._build()
    assert os.path.dirname(so) == tffi.BUILD_DIR
    assert os.path.basename(so).startswith("libgpz_native-")
    assert not os.path.exists(f"{so}.{os.getpid()}.tmp")


@pytest.mark.parametrize("count,pos", [(0, 0), (3, 3), (5, 2), (7, 0)])
def test_lbfgs_direction_equals_gpz_tpu(path, count, pos):
    """Two-loop recursion over a circular buffer of 7 slots: empty, partly
    filled, wrapped, full."""
    rng = np.random.default_rng(count * 10 + pos)
    hist, p = 7, 9
    S = rng.standard_normal((hist, p))
    Y = S * (1.0 + rng.random((hist, 1))) + 0.1 * rng.standard_normal((hist, p))
    Y[1] = -S[1]  # a pair with s'y < 0 gets rho = 0
    g = rng.standard_normal(p)
    got, want = both("lbfgs_direction", S, Y, count, pos, 0.7, g)
    np.testing.assert_array_equal(got, want)


def test_lbfgs_add_skip_rule_and_wrap_equal_gpz_tpu(path):
    """A stream of pairs into a 3-slot buffer: accepted pairs wrap around,
    pairs with y's <= 1e-10 are skipped; buffers and returned state equal
    after every insertion."""
    rng = np.random.default_rng(1)
    hist, p = 3, 5
    bufs = [np.zeros((hist, p)) for _ in range(4)]
    state = [(0, 0, 1.0)] * 2
    accepted = []
    for i in range(9):
        s = rng.standard_normal(p)
        y = -s if i in (2, 5) else s * (1.0 + rng.random())
        if i == 7:
            y = s * 1e-12  # y's positive but below the 1e-10 threshold
        outs = []
        for k, ffi in enumerate((tffi, jffi)):
            S, Y = bufs[2 * k], bufs[2 * k + 1]
            outs.append(ffi.lbfgs_add(S, Y, *state[k], s, y))
        assert outs[0] == outs[1]
        np.testing.assert_array_equal(bufs[0], bufs[2])
        np.testing.assert_array_equal(bufs[1], bufs[3])
        state = [o[:3] for o in outs]
        accepted.append(outs[0][3])
    assert accepted == [True, True, False, True, True, False, True, False,
                        True]
    assert state[0][:2] == (3, 0)  # six accepted pairs: full, wrapped twice


@pytest.mark.parametrize("kind", ["psd", "indefinite", "1x1", "zero-row"])
def test_modified_cholesky_equals_gpz_tpu(path, kind):
    rng = np.random.default_rng(3)
    n = 6
    A = rng.standard_normal((n, n))
    if kind == "psd":
        A = A @ A.T + n * np.eye(n)
    elif kind == "indefinite":
        A = (A + A.T) / 2
    elif kind == "1x1":
        A = np.array([[-2.5]])
    else:
        A = (A + A.T) / 2
        A[2, :] = A[:, 2] = 0.0  # a zero row and column
    got, want = both("modified_cholesky", A)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    L, d, perm = got
    assert np.all(d > 0)
    if kind == "psd":
        np.testing.assert_allclose(L @ np.diag(d) @ L.T, A[np.ix_(perm, perm)],
                                   rtol=1e-10, atol=1e-10)


CSV_CASES = {
    "empty-fields": ("1.5,,3\n,2,\n4,5,6\n", 0),
    "nan": ("nan,1e-3,-2.25\n7,NaN,8\n", 0),
    "no-trailing-newline": ("1.5,2.5\n3.5,4.5", 0),
    "skip-rows": ("a,b,c\nx,y,z\n1,2,3\n4.125,-5e2,6\n", 2),
    "exponents-and-crlf": ("1e300,-2.5E-7,3\r\n4,5,6\r\n", 0),
}


@pytest.mark.parametrize("case", list(CSV_CASES))
def test_read_csv_equals_gpz_tpu(path, case, tmp_path):
    text, skip = CSV_CASES[case]
    f = tmp_path / "in.csv"
    f.write_text(text)
    got, want = both("read_csv", str(f), skip)
    np.testing.assert_array_equal(got, want)


def test_read_csv_of_savetxt_equals_loadtxt(tmp_path):
    """A seeded catalog written as the CLI writes it parses to loadtxt's
    bits."""
    data = np.random.default_rng(4).standard_normal((500, 11)) * 10.0 ** (
        np.arange(11) - 5)
    f = tmp_path / "cat.csv"
    np.savetxt(f, data, delimiter=",")
    out = tffi.read_csv(str(f))
    np.testing.assert_array_equal(out, data)
    np.testing.assert_array_equal(out, np.loadtxt(f, delimiter=","))


def test_two_processes_that_build_at_once_both_load(tmp_path):
    """Two processes build the library into an empty directory at the same
    moment: each compiles to its own temporary file and renames it into
    place, so both load a whole library and one file is left."""
    code = (
        "import sys, numpy as np\n"
        "from gpz_tpu_torch.native import ffi\n"
        "ffi.BUILD_DIR = sys.argv[1]\n"
        "assert ffi.available()\n"
        "L, d, perm = ffi.modified_cholesky(np.eye(3) * 2.0)\n"
        "assert d.tolist() == [2.0, 2.0, 2.0], d\n"
        "print(ffi._build())\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    built = {out.strip() for out, _ in outs}
    assert len(built) == 1
    assert os.listdir(tmp_path) == [os.path.basename(built.pop())]
