"""The lower-precision controls and the planted faults that show the check
can fail: switched on by run.py's --control and --fault, which the
benchmark's own runs never pass. Each breaks the program underneath the
timed path, through a module attribute that the program calls.

A traffic kind's faults are its generator's `FAULTS`; a fault's plants
are its generator's `PLANTS[name]`, or else this module's
`_PLANTS[name]`. So a new kind declares its faults in its own file, names
the shared faults here without redefining them, and brings plants of its
own beside them.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np

#: serving's lower-precision path: the moment chain and the mixture sums
#: in float32 (the program reads both at each call)
SERVE_CONTROL_ENV = {"GPZ_VARIANCE_DTYPE": "float32",
                     "GPZ_MIX_DTYPE": "float32"}
#: training's: the Gram reductions and the m x m solve in float32
TRAIN_CONTROL_SOLVE = "float32"


def _answer_altered(real):
    def fake(*args, **kw):
        out = list(real(*args, **kw))
        out[0] = out[0].clone()
        out[0] += 0.05                 # every row's mu of each batch
        return tuple(out)
    return fake


def _half_batch(real):
    def fake(params, data, cfg, n_eff=None, complete=False, **kw):
        return real(params, data[:data.n // 2], cfg, None, complete, **kw)
    return fake


def _half_batch_init(real):
    def fake(Xl, P):
        return real(Xl[:len(Xl) // 2], P)
    return fake


def _state_unchanged(real):
    from gpz_tpu_torch.optim.lbfgs import MinimizeResult

    def fake(fun, x0, *, max_iter=200, **kw):
        f = float(fun(x0)[0])
        return MinimizeResult(
            x=x0, f=f, x_best=x0, best_score=-f, iterations=max_iter,
            fun_evals=1, status=3,
            trace={"f": np.full(max_iter + 1, f),
                   "fevals": np.ones(max_iter + 1, np.int32), "extras": {}})
    return fake


#: each fault's plants: (module, attribute, wrapper of the real one); half
#: the batch is left out of the objective's sums and of init's mean
#: distances alike
_PLANTS = {
    "answer_altered": [("gpz_tpu_torch.predict", "predict_moments_full",
                        _answer_altered)],
    "half_batch": [("gpz_tpu_torch.model", "nlog_ml", _half_batch),
                   ("gpz_tpu_torch.model", "_mean_sq_dist",
                    _half_batch_init)],
    "state_unchanged": [("gpz_tpu_torch.model", "minimize",
                         _state_unchanged)],
}


def of_generator(gen) -> tuple:
    """The faults that a cell of the generator `gen`'s kind can have: its
    FAULTS."""
    if not hasattr(gen, "FAULTS"):
        raise LookupError(
            f"the generator {gen.__name__!r} has no attribute FAULTS: give it "
            "FAULTS, the names of the faults its cells can have")
    return tuple(gen.FAULTS)


def _plants(name, gen):
    own = getattr(gen, "PLANTS", {})
    if name in own:
        return own[name]
    if name in _PLANTS:
        return _PLANTS[name]
    raise LookupError(f"no plants for the fault {name!r}: neither the "
                      "generator's PLANTS nor faults._PLANTS has it")


@contextlib.contextmanager
def planted(name, gen):
    """The fault `name` (None: none) planted while the block runs: the
    generator `gen`'s own plants of that name, or else the shared ones."""
    undo = []
    for module, attr, make in _plants(name, gen) if name else []:
        mod = importlib.import_module(module)
        undo.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, make(undo[-1][2]))
    try:
        yield
    finally:
        for mod, attr, real in reversed(undo):
            setattr(mod, attr, real)
