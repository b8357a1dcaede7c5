"""gpz_tpu_torch.parallel on the 2-D mesh, four gloo ranks on the CPU,
against the port in one process and against gpz_tpu in float64:
ensemble_grad_step on a (restart 2, data 2) mesh (tests/test_sharding.py's
case, which gpz_tpu runs on 2 x 4 devices), each rank's gradient on one data
group of four, fit_ensemble(mesh) against fit_ensemble(mesh=None), and
make_mesh's argument checks.

The four ranks run once for the whole file (module fixture,
tests/torch_parallel_worker.py's "grid" scenario, 120 s at most), while
this process computes the references. Tolerances:
tests/test_torch_parallel.py's; the ensemble against one process within TRACE
(tests/test_torch_train.py): ten L-BFGS iterations on sums split in two.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
import pytest
import torch

from gpz_tpu.config import ModelConfig as JConfig
from gpz_tpu.dataset import Dataset as JDataset
from gpz_tpu.params import GPzParams as JParams
from gpz_tpu.parallel import (
    ensemble_grad_step as jensemble_grad_step, make_mesh as jmake_mesh,
    shard_dataset as jshard_dataset,
)

import gpz_tpu_torch
from gpz_tpu_torch.model import _objective
from gpz_tpu_torch.params import FIELDS

from test_torch_objective import GRAD, VALUE
from test_torch_parallel import (
    SHARDED_F, SHARDED_G, jax_value_and_grad, port_value_and_grad,
    same_on_all,
)
from test_torch_train import TRACE
import torch_parallel_worker as w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = w.Ranks("grid", 4, str(tmp_path_factory.mktemp("grid")))
    yield handle
    handle.close()


def test_ensemble_grad_step_2d_mesh(ranks):
    """Restarts split over the restart group and rows over the data group:
    each restart's step is the one taken alone in one process, and
    gpz_tpu's on its 2 x 4 mesh of virtual devices."""
    method, psi, n, seed, R, lr = w.ENSEMBLE
    params, data, cfg = w.problem(method, psi, n, seed)
    stacked = w.stacked_restarts(params, R, seed)
    cfg_t = gpz_tpu_torch.ModelConfig(**cfg)
    data_t = w.to_dataset(data)
    want = []
    for ri in range(R):
        p_i = gpz_tpu_torch.GPzParams.from_numpy(
            {f: v[ri] for f, v in stacked.items()}, "cpu", torch.float64)
        flat, unravel = p_i.flatten()
        _, g, _ = _objective(unravel, data_t, cfg_t, True)(flat)
        want.append((flat - lr * g).numpy())
    mesh = jmake_mesh(n_data=4, n_restart=2)
    jd = JDataset(**{f: None if v is None else jnp.asarray(v)
                     for f, v in data.items()})
    sdata, n_eff = jshard_dataset(jd, mesh)
    jcfg = JConfig(**cfg)
    jout = jax.jit(lambda sp, d, ne: jensemble_grad_step(
        sp, d, jcfg, mesh, ne, lr=lr, complete=True))(
        JParams(**{f: jnp.asarray(v) for f, v in stacked.items()}), sdata,
        n_eff)
    jflat = np.concatenate([np.asarray(getattr(jout, f)).reshape(R, -1)
                            for f in FIELDS if f in stacked], axis=1)

    got = np.concatenate([same_on_all(ranks, f"ensemble.{f}").reshape(R, -1)
                          for f in FIELDS if f in stacked], axis=1)
    np.testing.assert_allclose(got, np.stack(want), rtol=1e-9)
    np.testing.assert_allclose(got, jflat, **GRAD)


@pytest.mark.parametrize("case", w.GRAD_CASES, ids=lambda c: c[0])
def test_each_rank_holds_the_whole_gradient_on_four_ranks(ranks, case):
    name, method, psi, n, seed, missing = case
    f1, g1, _ = port_value_and_grad(method, psi, n, seed, missing)
    fj, gj = jax_value_and_grad(method, psi, n, seed, missing)
    for key in ("g", "auto_g"):
        for r in ranks.results():
            np.testing.assert_allclose(r[f"grad4.{name}.{key}"], g1,
                                       **SHARDED_G)
        np.testing.assert_allclose(same_on_all(ranks, f"grad4.{name}.{key}"),
                                   gj, **GRAD)
    f2 = same_on_all(ranks, f"grad4.{name}.f")
    np.testing.assert_allclose(f2, f1, **SHARDED_F)
    np.testing.assert_allclose(f2, fj, **VALUE)


def test_fit_ensemble_over_the_mesh_matches_one_process(ranks):
    """Two restarts, one per restart index, each on rows split over its
    data group of two: the same scores, counts, best restart and model as
    fit_ensemble(mesh=None), and the same on every rank."""
    model, info = w.fit_problem(gpz_tpu_torch.fit_ensemble)
    assert int(same_on_all(ranks, "fit.best_restart")) == info[
        "best_restart"]
    for key in ("iterations", "fun_evals"):
        np.testing.assert_array_equal(same_on_all(ranks, f"fit.{key}"),
                                      info[key])
    np.testing.assert_allclose(same_on_all(ranks, "fit.scores"),
                               info["restart_scores"], **TRACE)
    for which in ("best", "last"):
        np.testing.assert_allclose(
            same_on_all(ranks, f"fit.{which}"),
            getattr(model, which).params.flatten()[0].numpy(), **TRACE)
    np.testing.assert_allclose(same_on_all(ranks, "fit.best_w"),
                               model.best.post.w.numpy(), **TRACE)


def test_make_mesh_argument_checks_and_layout(ranks):
    """gpz_tpu's ValueErrors, on every rank; rank = restart * n_data +
    data, gpz_tpu's row-major grid."""
    for r in ranks.results():
        assert "4 ranks not divisible by n_restart=3" in str(
            r["mesh_error.3 restarts"])
        assert "mesh (2 x 3) exceeds 4 ranks" in str(r["mesh_error.2 x 3"])
    assert [r["grid.coords"].tolist() for r in ranks.results()] == [
        [0, 0], [0, 1], [1, 0], [1, 1]]
