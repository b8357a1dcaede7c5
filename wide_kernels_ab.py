"""Time the design-matrix kernel pair of this tree against another source of
it, on one GPU, in one process.

    python3 wide_kernels_ab.py --parent DIR [--out FILE]

DIR is the root of another checkout (e.g. `git archive` of the parent commit
unpacked into an ignored directory); its gpz_tpu_torch/csrc/vc_phi.cu is
built by this tree's gpz_tpu_torch.ops.vc_phi.build, as this tree's source
is. A third library, `groups`, is this tree's source with FWD_REG_MAX =
BWD_REG_MAX = 8, so that the group kernels take every d from 9: against
this tree's library it measures the crossover the dispatch table sets.

At every shape (the wide kernels at (70,000 x 100) for d = 9, 10 and 12
to 18 and (4,000 x 100) for d = 32, the nine-band run's other sites, and
the d = 5 templates at the training shape) each library's forward and
backward are timed by CUDA events in turns (parent, this tree, groups,
groups, this tree, parent), their outputs held to this tree's (bit-equal at
d = 5, within chip_smoke.KERNEL_TOL / KERNEL_BWD_TOL elsewhere), and the
times printed beside the bound (chip_smoke.bound) and the card's name and
power limit. Each library's build time is printed too. One JSON object with
every number goes to FILE (default gpz_tpu_torch/_build/wide_kernels_ab.json).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# (rows, bases, d, kinds): the shapes timed
SHAPES = (
    [(70_000, 100, d, "fb") for d in (9, 10, 12, 13, 14, 15, 16, 17, 18)]
    + [(4_000, 100, 32, "fb")]
    # nine bands: validation scores, the sub-problem, the two pair sites
    + [(10_000, 100, 9, "f"), (1_000, 100, 9, "b"), (771, 10_000, 9, "f"),
       (1_500, 10_000, 9, "f")]
    + [(70_000, 100, 5, "fb")]
)


def groups_source(src: bytes) -> bytes:
    """This tree's source with the register designs' table entries at 8."""
    for k in (b"FWD_REG_MAX", b"BWD_REG_MAX"):
        src, n = re.subn(rb"constexpr int " + k + rb" = \d+;",
                         b"constexpr int " + k + b" = 8;", src)
        if n != 1:
            raise RuntimeError(f"{k.decode()} not found once in the source")
    return src


def bind(path: str):
    lib = ctypes.CDLL(path)
    lib.gpz_vc_lnphi_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    lib.gpz_vc_lnphi_bwd.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.gpz_vc_lnphi_bwd_spans.argtypes = [ctypes.c_int] * 5
    lib.gpz_vc_lnphi_workspace.argtypes = [ctypes.c_int] * 6
    lib.gpz_vc_lnphi_workspace.restype = ctypes.c_longlong
    return lib


class Call:
    """One library's forward and backward at one shape, with its outputs
    and scratch allocated once."""

    def __init__(self, lib, args, g):
        import torch

        X, psi, P, Sigma, lds = args
        self.lib, self.args, self.g = lib, args, g
        n, d = X.shape
        m = P.shape[0]
        self.nmd = (n, m, d)
        self.out = torch.empty((n, m), dtype=X.dtype, device=X.device)
        self.dP = torch.empty_like(P)
        self.dS = torch.empty_like(Sigma)
        spans = lib.gpz_vc_lnphi_bwd_spans(n, m, 1, d, 1)
        self.partial = torch.empty((max(spans, 1), d + d * d, m),
                                   dtype=X.dtype, device=X.device)
        self.ws = []
        for backward in (0, 1):
            elems = lib.gpz_vc_lnphi_workspace(n, m, 1, d, 1, backward)
            self.ws.append(torch.empty(max(elems, 1), dtype=X.dtype,
                                       device=X.device))
        self.stream = torch.cuda.current_stream().cuda_stream

    def fwd(self):
        X, psi, P, Sigma, lds = self.args
        n, m, d = self.nmd
        err = self.lib.gpz_vc_lnphi_fwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            lds.data_ptr(), self.out.data_ptr(), n, m, d, 1,
            self.ws[0].data_ptr(), self.stream)
        if err:
            raise RuntimeError(f"forward launch failed: {err}")

    def bwd(self):
        X, psi, P, Sigma, _ = self.args
        n, m, d = self.nmd
        err = self.lib.gpz_vc_lnphi_bwd(
            X.data_ptr(), psi.data_ptr(), P.data_ptr(), Sigma.data_ptr(),
            self.g.data_ptr(), self.partial.data_ptr(), self.dP.data_ptr(),
            self.dS.data_ptr(), n, m, 1, d, 1, self.ws[1].data_ptr(),
            self.stream)
        if err:
            raise RuntimeError(f"backward launch failed: {err}")


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "gpz_tpu_torch", "_build", "wide_kernels_ab.json"))
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_kernels_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as cs
    from gpz_tpu_torch.ops import vc_phi

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    with open(vc_phi.SOURCE, "rb") as fh:
        own = fh.read()
    with open(os.path.join(opts.parent, "gpz_tpu_torch", "csrc",
                           "vc_phi.cu"), "rb") as fh:
        sources = {"parent": fh.read(), "change": own,
                   "groups": groups_source(own)}
    libs, build_s = {}, {}
    t0 = time.perf_counter()

    def build(name):
        path = vc_phi.build(sources[name], "libgpz_vc_phi"
                            if name == "change" else f"ab-{name}")
        return path, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))
    for name, (path, sec) in built.items():
        libs[name], build_s[name] = bind(path), sec
        print(f"build {name}: done {sec:.2f} s after all started")
    order = ["parent", "change", "groups", "groups", "change", "parent"]

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(12)
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    results = []
    for n, m, d, kinds in SHAPES:
        args = cs.random_inputs(rng, n, d, m, torch.float64, dev)
        g = torch.randn((n, m), dtype=torch.float64, device=dev,
                        generator=gen)
        calls = {k: Call(lib, args, g) for k, lib in libs.items()}
        few = dict(trials=5, calls=5, warmup=2)
        for kind in ({"f": "fwd", "b": "bwd"}[k] for k in kinds):
            times = {k: [] for k in libs}
            for name in order:
                fn = getattr(calls[name], kind)
                times[name].append(cs.median_ms(fn, **few))
            for c in calls.values():
                getattr(c, kind)()
            torch.cuda.synchronize()
            ref = calls["change"]
            errs = {}
            for name, c in calls.items():
                got = (c.out,) if kind == "fwd" else (c.dP, c.dS)
                want = (ref.out,) if kind == "fwd" else (ref.dP, ref.dS)
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                rtol, atol = (cs.KERNEL_TOL if kind == "fwd"
                              else cs.KERNEL_BWD_TOL)["float64"]
                worst = max(float((a - b).abs().max())
                            / (atol + rtol * float(b.abs().max()))
                            for a, b in zip(got, want))
                errs[name] = {"bit_equal": same, "err_over_tol": worst}
                cs.check(worst <= 1.0, f"{name} {kind} d={d} {n}x{m}: "
                         "disagrees with this tree's kernel")
                if d <= 8:
                    cs.check(same, f"{name} {kind} d={d}: not bit-equal to "
                             "this tree's template")
            b = cs.bound(kind, n, m, d, "float64")
            rec = {"shape": [n, m, d], "kind": kind, "ms": times,
                   "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
                   "outputs": errs}
            results.append(rec)
            print(f"{kind} d={d} {n}x{m}: bound {b['bound_ms']:.5f} ms by "
                  f"{b['bound_by']}; " + "; ".join(
                      f"{k} " + "/".join(f"{t:.4f}" for t in v)
                      + f" ms ({min(v) / b['bound_ms']:.2f}-"
                      f"{max(v) / b['bound_ms']:.2f}x)"
                      for k, v in times.items()))
        del calls, args, g
        torch.cuda.empty_cache()
    report = {"device": smi, "torch": torch.__version__,
              "build_s": build_s, "results": results}
    os.makedirs(os.path.dirname(opts.out), exist_ok=True)
    with open(opts.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"ok": True, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
