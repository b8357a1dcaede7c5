"""Counters and call records taken from the program while a traced window
runs, by wrapping the module attributes through which the program calls
its own layers (and only those): the kernel pair's two entry points, the
coverage guard's call of the moments, the objective that `model.train`
builds and the validation score it calls. Removed when the window closes.
"""

from __future__ import annotations

import importlib
import time


class Probes:
    """What the probes recorded: the kernel pair's calls as (rows, bases,
    d, dtype) and its launches (the program's counters), escalations of
    the mixture guard, the seconds of each objective evaluation
    (synchronised at its end) and the rows of each validation score."""

    def __init__(self, m: int):
        self.m = m
        self.fwd, self.bwd = [], []
        self.escalations = 0
        self.eval_s = []
        self.score_rows = []
        self.launches = {}
        self._undo = []

    def _patch(self, module: str, name: str, make):
        mod = importlib.import_module(module)
        real = getattr(mod, name)
        setattr(mod, name, make(real))
        self._undo.append((mod, name, real))

    def install(self, span):
        import torch

        def shape(X, P):
            return (X.shape[0], P.shape[0], X.shape[1],
                    str(X.dtype).replace("torch.", ""))

        def fwd(real):
            def forward(X, psi, P, Sigma, logdet_Sigma):
                self.fwd.append(shape(X, P))
                return real(X, psi, P, Sigma, logdet_Sigma)
            return forward

        def bwd(real):
            def backward(X, psi, P, Sigma, g, sets=1):
                self.bwd.append(shape(X, P))
                return real(X, psi, P, Sigma, g, sets)
            return backward

        def moments(real):
            def call(*args, **kw):
                if kw.get("mix_topl") == self.m:
                    self.escalations += 1
                return real(*args, **kw)
            return call

        def objective(real):
            def make(*args):
                fun = real(*args)

                def timed(flat):
                    t0 = time.perf_counter()
                    with span("gpzbench.evaluation"):
                        out = fun(flat)
                        if torch.cuda.is_available():
                            torch.cuda.synchronize()
                    self.eval_s.append(time.perf_counter() - t0)
                    return out
                return timed
            return make

        def holdout(real):
            def score(params, w, data, *a, **kw):
                self.score_rows.append(data.n)
                with span("gpzbench.score"):
                    return real(params, w, data, *a, **kw)
            return score

        ops = "gpz_tpu_torch.ops.vc_phi"
        self._ops = importlib.import_module(ops)
        self.launches = {"fwd": -self._ops.LAUNCHES_FWD,
                         "bwd": -self._ops.LAUNCHES_BWD}
        self._patch(ops, "_forward", fwd)
        self._patch(ops, "vc_lnphi_bwd", bwd)
        self._patch("gpz_tpu_torch.predict", "predict_moments_full", moments)
        self._patch("gpz_tpu_torch.model", "_objective", objective)
        self._patch("gpz_tpu_torch.model", "holdout_metrics", holdout)

    def remove(self):
        if self._undo:
            self.launches["fwd"] += self._ops.LAUNCHES_FWD
            self.launches["bwd"] += self._ops.LAUNCHES_BWD
        while self._undo:
            mod, name, real = self._undo.pop()
            setattr(mod, name, real)
