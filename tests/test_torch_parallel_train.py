"""train_sharded on two gloo ranks on the CPU, against optim.minimize in one
process and against gpz_tpu's minimize in float64: tests/test_sharding.py's
two training cases (it converges; its trajectory is the unsharded one), and
the validation set scored through holdout_metrics over the data group.

The two ranks run once for the whole file (module fixture,
tests/torch_parallel_worker.py's "train" scenario, 120 s at most).
Tolerances: tests/test_torch_parallel.py's; TRACE against gpz_tpu's trace.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
from jax.flatten_util import ravel_pytree
import pytest

from gpz_tpu import objective as jobj
from gpz_tpu.optim import minimize as jminimize

from gpz_tpu_torch import objective as tobj
from gpz_tpu_torch.model import _objective
from gpz_tpu_torch.optim import minimize

from test_torch_parallel import SHARDED_TRACE, jax_problem, same_on_all
from test_torch_train import TRACE
import torch_parallel_worker as w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = w.Ranks("train", 2, str(tmp_path_factory.mktemp("train")))
    yield handle
    handle.close()


def test_train_sharded_matches_unsharded_trajectory(ranks):
    """Same data, same init: the sharded and one-process optimizations end
    at the same loss (float64 => tight), and the trace is gpz_tpu's."""
    method, psi, n, seed, iters = w.TRAJECTORY
    params, data, cfg = w.port_problem(method, psi, n, seed)
    flat0, unravel = params.flatten()
    res1 = minimize(_objective(unravel, data, cfg, True), flat0,
                    max_iter=iters)
    tr = same_on_all(ranks, "trajectory.f")
    np.testing.assert_allclose(tr[-1], res1.f, **SHARDED_TRACE)
    np.testing.assert_allclose(tr, res1.trace["f"], **SHARDED_TRACE)
    np.testing.assert_array_equal(same_on_all(ranks, "trajectory.fevals"),
                                  res1.trace["fevals"])

    jp, jd, jcfg = jax_problem(method, psi, n, seed)
    jflat0, junravel = ravel_pytree(jp)

    @jax.jit
    def jfun(flat):
        (f, aux), g = jax.value_and_grad(
            lambda t: jobj.nlog_ml(junravel(t), jd, jcfg, complete=True),
            has_aux=True)(flat)
        return f, g, aux

    jres = jminimize(jfun, jflat0, max_iter=iters)
    n_it = int(jres.iterations)
    assert n_it == len(tr) - 1
    np.testing.assert_allclose(tr, np.asarray(jres.trace["f"])[:n_it + 1],
                               **TRACE)


def test_train_sharded_runs_and_converges(ranks):
    tr = same_on_all(ranks, "converge.f")
    n_it = int(same_on_all(ranks, "converge.iterations"))
    assert n_it >= 1 and len(tr) == n_it + 1
    assert tr[n_it] < tr[0]
    assert np.isfinite(tr).all()


def test_train_sharded_scores_the_validation_rows(ranks):
    """valid_data: the score trace (holdout_metrics over the data group)
    and the trajectory of minimize with the same score_fn in one process."""
    method, psi, n_tr, n_va, seed, iters = w.VALIDATED
    params, data, cfg = w.port_problem(method, psi, n_tr + n_va, seed)
    flat0, unravel = params.flatten()
    valid = data[n_tr:]

    def score_fn(flat, aux):
        rmse, ll = tobj.holdout_metrics(unravel(flat), aux.w, valid, cfg,
                                        complete=True)
        return ll, {"valid_rmse": rmse, "valid_ll": ll}

    res1 = minimize(_objective(unravel, data[:n_tr], cfg, True), flat0,
                    max_iter=iters, score_fn=score_fn)
    for key, want in (("f", res1.trace["f"]), ("score", res1.trace["score"]),
                      ("valid_rmse", res1.trace["extras"]["valid_rmse"]),
                      ("x", res1.x.numpy())):
        np.testing.assert_allclose(same_on_all(ranks, f"validated.{key}"),
                                   want, **SHARDED_TRACE, err_msg=key)
