"""The port's tracing: spans at the layer boundaries of `model.predict` and
`model.train`, counters where the work happens, and GPZ_PROFILE's
profiler trace of `train`.

Spans are on exactly while a torch.profiler session is active in the
process: an operator's own, or GPZ_PROFILE's (`profiled`). Off, `span`
reads one flag and returns a shared null context. On, a span enters
`torch.profiler.record_function(name)`, so that it lies on the profiler's
timeline beside the device's kernels, and keeps a record in a bounded
buffer in host memory: its name, its start and end in ns on the clock the
profiler stamps its events with (`time.time_ns`), its id, its parent's id
and its root's (the outermost open span: one per `predict` or `train`
call, shared by all its spans), its attributes, and the counts taken while
it was open, its children's included. `records()` reads the buffer,
`reset()` empties it; records past MAX_RECORDS are counted, not kept.
The flag is the calling thread's: a thread that the session does not
profile records no span. Spans nest per thread: a span's parent and root
are the spans open on the thread that opened it.

Counters (`count`) are always on and host-only: a process-wide total by
name (`COUNTS`) and, while spans are on, the innermost open span's count.

    gpz.predict (rows, patterns, batches)    model.predict
      gpz.predict.group                      normalisation, mask, patterns
      gpz.predict.batch (rows)               one row batch:
        gpz.predict.upload                   its rows, pattern, psi to the card
        gpz.predict.moments                  the moment chain's enqueue
        gpz.predict.guard                    the coverage read; on escalation
          gpz.predict.moments                the exact re-run
        gpz.predict.readback                 the outputs to the host
      gpz.predict.finish                     clamps, sigma
    gpz.train (rows, m)                      model.train
      gpz.train.data                         normalisation, psi, datasets
      gpz.train.minimize                     optim.minimize; its self time is
        gpz.lbfgs.eval                       the lane's own host work
        gpz.lbfgs.score
        gpz.lbfgs.read
      gpz.train.resolve (twice)              model._resolve
        gpz.posterior                        its posterior state
        gpz.prior.em                         prior.get_prior
    gpz.phi.masked (rows, blocks, d)         phi._log_phi_full's masked
                                             pass (data with a NaN row):
                                             its forward, inside the span
                                             that builds the design matrix
                                             (gpz.lbfgs.eval, .score,
                                             gpz.posterior, gpz.prior.em)

    reads.lbfgs          optim.lbfgs._scalars: one transfer per request
    reads.cholesky       linalg.safe_cholesky's finiteness check
    reads.coverage       model.predict's coverage guard
    reads.readback       model.predict's outputs, one per tensor (five a
                         batch)
    prior.em_iterations  prior.get_prior's iterations, each ending in one
                         transfer (its stopping read)
    predict.escalations  batches the coverage guard re-runs exact
    predict.tables_built predict._model_tables: one per table group built
                         for a parameter set (its basis tables, its pair
                         tables of a block size, a band pattern's)
    predict.tables_reused
                         predict._model_tables: one per call of
                         predict_moments_full (a batch, or its exact
                         re-run) that found every table it needs
    phi.rows_total       phi._log_phi_full: the rows of each call, on
                         every branch (the kernel pair, the masked pass,
                         complete rows without psi)
    phi.rows_masked      phi._log_phi_full: the rows of each call that
                         takes the masked pass

A read is counted at its site whatever the device (on CPU tensors it is no
transfer). The resolve's posterior enqueues its device work unsynchronised;
`gpz.train.resolve` ends after the EM's last stopping read, so it holds
the device time of both.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time

import torch

#: most span records the buffer keeps; later ones are counted in DROPPED
MAX_RECORDS = 100_000

#: process-wide totals of every counter
COUNTS: dict = {}

#: is a profiler session active? (one flag read)
_enabled = torch._C._autograd._profiler_enabled
_now = time.time_ns
_ids = itertools.count(1)
_records: list = []     # closed spans, in the order they closed
DROPPED = 0


class _Open(threading.local):
    """The spans open on a thread, innermost last."""

    def __init__(self):
        self.spans = []


_open = _Open()


class _Null:
    """The span when spans are off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NULL = _Null()


class _Span:
    __slots__ = ("name", "attrs", "counts", "id", "parent", "root",
                 "start", "end", "_rf")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.counts = name, attrs, {}

    def __enter__(self):
        self.id = next(_ids)
        opened = _open.spans
        up = opened[-1] if opened else None
        self.parent = None if up is None else up.id
        self.root = self.id if up is None else up.root
        opened.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self.start = _now()
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        global DROPPED
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        self.end = _now()
        opened = _open.spans
        opened.pop()
        if opened:
            up = opened[-1].counts
            for name, k in self.counts.items():
                up[name] = up.get(name, 0) + k
        if len(_records) < MAX_RECORDS:
            _records.append(self)
        else:
            DROPPED += 1
        return False

    def set(self, **attrs):
        """Attributes known only inside the span."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one stage (module docstring): NULL while no
    profiler session is active, else a recorded span."""
    if not _enabled():
        return NULL
    return _Span(name, attrs)


def count(name: str, k: int = 1):
    """Add k to counter `name`: its process-wide total and, while spans are
    on, the count of the calling thread's innermost open span."""
    COUNTS[name] = COUNTS.get(name, 0) + k
    opened = _open.spans
    if opened:
        c = opened[-1].counts
        c[name] = c.get(name, 0) + k


def records() -> list:
    """The closed spans since the last `reset`, in the order they closed:
    dicts of name, start_ns, end_ns, id, parent, root (ids; parent None at
    a root), attrs and counts (taken while the span was open, its
    children's included)."""
    return [{"name": s.name, "start_ns": s.start, "end_ns": s.end,
             "id": s.id, "parent": s.parent, "root": s.root,
             "attrs": dict(s.attrs), "counts": dict(s.counts)}
            for s in _records]


def reset():
    """Empty the span buffer (counters keep their totals)."""
    global DROPPED
    _records.clear()
    DROPPED = 0


def profiled(device: torch.device):
    """With GPZ_PROFILE set to a directory, a torch.profiler session over the
    block (host and, on a CUDA device, the card's kernels; the port's spans
    on) whose trace is written there on exit, as gpz_tpu writes a
    jax.profiler trace of its training; with it unset, nothing."""
    out = os.environ.get("GPZ_PROFILE")
    if not out:
        return contextlib.nullcontext()
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(out))
