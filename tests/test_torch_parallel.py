"""gpz_tpu_torch.parallel.sharded on two gloo ranks on the CPU, against the
port in one process and against gpz_tpu in float64: tests/test_sharding.py's
loss for VL / VD / VC with psi and its gradient case, and what the port
adds: each rank's gradient is the whole gradient, with full psi and on rows
with NaNs too. train_sharded is in tests/test_torch_parallel_train.py, the
multi-process entry in tests/test_torch_parallel_entry.py, the 2-D mesh in
tests/test_torch_parallel_mesh.py (the Ozaki cases of test_sharding.py
stay out, with the Ozaki path).

The two ranks run once for the whole file (module fixture,
tests/torch_parallel_worker.py's "pair" scenario, 120 s at most), while
this process computes the references.

Tolerances: the sharded port against the port in one process, gpz_tpu's own
for its sharded case (tests/test_sharding.py: f rtol=1e-12, the gradient
rtol=1e-9 / atol=1e-12, the trajectory rtol=1e-8): the same formulas, the
sums over rows split in two. Against gpz_tpu, VALUE and GRAD of
tests/test_torch_objective.py and TRACE of tests/test_torch_train.py.
Across the ranks, bit-equality: every replicated value comes from the same
all-reduced bits.
"""

import functools

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest

from gpz_tpu import objective as jobj
from gpz_tpu.config import ModelConfig as JConfig
from gpz_tpu.dataset import Dataset as JDataset
from gpz_tpu.params import GPzParams as JParams

from gpz_tpu_torch import objective as tobj
from gpz_tpu_torch.model import _objective

from test_torch_objective import GRAD, VALUE
import torch_parallel_worker as w

SHARDED_F = dict(rtol=1e-12, atol=0.0)
SHARDED_G = dict(rtol=1e-9, atol=1e-12)
SHARDED_TRACE = dict(rtol=1e-8, atol=0.0)
WORLD = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = w.Ranks("pair", WORLD, str(tmp_path_factory.mktemp("pair")))
    yield handle
    handle.close()


def same_on_all(ranks, key):
    """The value of `key`, asserted bit-equal on every rank."""
    first = ranks.results()[0][key]
    for r in ranks.results()[1:]:
        np.testing.assert_array_equal(r[key], first, err_msg=key)
    return first


_JAX_VG = jax.jit(jax.value_and_grad(
    lambda p, d, cfg, complete: jobj.nlog_ml(p, d, cfg, complete=complete)[0]),
    static_argnums=(2, 3))


def jax_problem(method, psi, n, seed, missing=False):
    params, data, cfg = w.problem(method, psi, n, seed, missing)
    jp = JParams(**{f: jnp.asarray(v) for f, v in params.items()})
    jd = JDataset(**{f: None if v is None else jnp.asarray(v)
                     for f, v in data.items()})
    return jp, jd, JConfig(**cfg)


@functools.cache
def jax_value_and_grad(method, psi, n, seed, missing=False):
    """gpz_tpu's nlml and flat gradient (jax.grad of nlog_ml, compiled)."""
    f, g = _JAX_VG(*jax_problem(method, psi, n, seed, missing), not missing)
    return float(f), np.asarray(ravel_pytree(g)[0])


def port_value_and_grad(method, psi, n, seed, missing=False):
    params, data, cfg = w.port_problem(method, psi, n, seed, missing)
    flat, unravel = params.flatten()
    f, g, aux = _objective(unravel, data, cfg, bool(data.mask.all()))(flat)
    return float(f), g.numpy(), aux


@pytest.mark.parametrize("case", w.LOSS_CASES, ids=lambda c: c[0])
def test_sharded_loss_matches_single_device(ranks, case):
    name, method, psi, n, seed, missing = case
    params, data, cfg = w.port_problem(method, psi, n, seed, missing)
    f1, aux1 = tobj.nlog_ml(params, data, cfg, complete=True)
    fj, _ = jax_value_and_grad(method, psi, n, seed, missing)
    f2 = same_on_all(ranks, f"loss.{name}.f")
    assert int(same_on_all(ranks, f"loss.{name}.rows")) == -(-n // WORLD)
    np.testing.assert_allclose(f2, float(f1), **SHARDED_F)
    np.testing.assert_allclose(f2, float(fj), **VALUE)
    np.testing.assert_allclose(same_on_all(ranks, f"loss.{name}.w"),
                               aux1.w.numpy(), rtol=1e-10)
    np.testing.assert_allclose(same_on_all(ranks, f"loss.{name}.rmse"),
                               float(aux1.train_rmse), **SHARDED_F)


def test_sharded_grad_matches_single_device(ranks):
    """tests/test_sharding.py's case: autograd through sharded_nlog_ml."""
    name, method, psi, n, seed, missing = w.GRAD_CASES[0]
    _, g1, _ = port_value_and_grad(method, psi, n, seed, missing)
    _, gj = jax_value_and_grad(method, psi, n, seed, missing)
    g2 = same_on_all(ranks, f"grad.{name}.auto_g")
    np.testing.assert_allclose(g2, g1, **SHARDED_G)
    np.testing.assert_allclose(g2, gj, **GRAD)


@pytest.mark.parametrize("case", w.GRAD_CASES, ids=lambda c: c[0])
def test_each_rank_holds_the_whole_gradient(ranks, case):
    """Each rank's flat gradient from sharded_value_and_grad is the gradient
    of the whole dataset, not its share of it (an all-reduce in the
    reduction's backward alone leaves rank r with world x its part)."""
    name, method, psi, n, seed, missing = case
    f1, g1, _ = port_value_and_grad(method, psi, n, seed, missing)
    fj, gj = jax_value_and_grad(method, psi, n, seed, missing)
    for key in ("g", "auto_g"):
        for r in ranks.results():
            np.testing.assert_allclose(r[f"grad.{name}.{key}"], g1,
                                       **SHARDED_G)
        g2 = same_on_all(ranks, f"grad.{name}.{key}")
        np.testing.assert_allclose(g2, gj, **GRAD)
    f2 = same_on_all(ranks, f"grad.{name}.f")
    np.testing.assert_allclose(f2, f1, **SHARDED_F)
    np.testing.assert_allclose(f2, fj, **VALUE)
