"""gpz_tpu_torch.objective's batched evaluation with its Aux
(nlog_ml_batched(lanes=True), model._objective_batched) and
holdout_metrics of B parameter sets, in float64 on the CPU:

  * against jax.vmap of gpz_tpu's value_and_grad(nlog_ml) (value, gradient,
    w, train_rmse, train_ll) and of its holdout_metrics on other rows;
  * each set against the port's nlog_ml and holdout_metrics of that set
    alone, bit for bit: the optimizer's lanes (optim.minimize_batched)
    equal minimize alone only so.

Cases: VC with psi (n, d, d), VL without psi, VD with NaNs and psi (n, d).
Tolerances: tests/test_torch_objective.py's VALUE and GRAD.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import pytest
import torch

from gpz_tpu import objective as jobj

from gpz_tpu_torch import model as tmodel
from gpz_tpu_torch import objective as tobj

from test_torch_objective import (
    GRAD, VALUE, jax_side, make_case, make_matrix_case, torch_side,
)

B = 3


def case_rows(case, seed, n):
    """(param arrays, data arrays, cfg kwargs, complete) of a case."""
    if case == "VC-psi":
        return (*make_case("VC", True, True, 1, seed=seed, n=n), True)
    if case == "VL":
        return (*make_matrix_case("VL", False, False, True, seed=seed,
                                  n=n)[:3], True)
    return (*make_matrix_case("VD", True, True, True, seed=seed, n=n)[:3],
            False)


CASES = ("VC-psi", "VL", "VD-psi-missing")


def sides(case):
    """Both packages' training rows (40) and validation rows (17, other
    draws) of the case, the training case's parameters, and B points
    around them."""
    params, data, cfg, complete = case_rows(case, 0, 40)
    _, vdata, _, vcomplete = case_rows(case, 1, 17)
    jp, jd, jcfg = jax_side(params, data, cfg)
    _, jdv, _ = jax_side(params, vdata, cfg)
    tp, td, tcfg = torch_side(params, data, cfg)
    _, tdv, _ = torch_side(params, vdata, cfg)
    jflat, junravel = ravel_pytree(jp)
    _, unravel = tp.flatten()
    rng = np.random.default_rng(2)
    X = np.asarray(jflat)[None] + 0.05 * rng.standard_normal(
        (B, jflat.shape[0]))
    return dict(jax=(jd, jdv, jcfg, junravel), port=(td, tdv, tcfg, unravel),
                complete=(complete, vcomplete), X=X)


@pytest.fixture(scope="module", params=CASES)
def case(request):
    return sides(request.param)


def port_batched(case):
    td, tdv, tcfg, unravel = case["port"]
    complete, vcomplete = case["complete"]
    fun = tmodel._objective_batched(unravel, td, tcfg, complete)
    X = torch.tensor(case["X"])
    f, g, aux = fun(X)
    holdout = tobj.holdout_metrics(unravel(X), aux.w, tdv, tcfg,
                                   complete=vcomplete)
    return f, g, aux, holdout


def test_batched_aux_and_holdout_against_jax_vmap(case):
    jd, jdv, jcfg, junravel = case["jax"]
    complete, vcomplete = case["complete"]

    def value_and_aux(x):
        return jobj.nlog_ml(junravel(x), jd, jcfg, complete=complete)

    (jf, jaux), jg = jax.jit(jax.vmap(jax.value_and_grad(
        value_and_aux, has_aux=True)))(jnp.asarray(case["X"]))
    jr, jl = jax.jit(jax.vmap(lambda x, w: jobj.holdout_metrics(
        junravel(x), w, jdv, jcfg, complete=vcomplete)))(
        jnp.asarray(case["X"]), jaux.w)
    f, g, aux, (r, ll) = port_batched(case)
    assert f.shape == (B,) and g.shape == case["X"].shape
    assert aux.w.shape == jaux.w.shape and aux.train_ll.shape == (B,)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **VALUE)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **GRAD)
    np.testing.assert_allclose(aux.w.numpy(), np.asarray(jaux.w), **GRAD)
    for name in ("train_rmse", "train_ll"):
        np.testing.assert_allclose(getattr(aux, name).numpy(),
                                   np.asarray(getattr(jaux, name)),
                                   err_msg=name, **VALUE)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), **GRAD)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jl), **GRAD)


def test_each_set_is_nlog_ml_alone_bit_for_bit(case):
    td, tdv, tcfg, unravel = case["port"]
    complete, vcomplete = case["complete"]
    f, g, aux, (r, ll) = port_batched(case)
    alone = tmodel._objective(unravel, td, tcfg, complete)
    for b in range(B):
        x = torch.tensor(case["X"][b])
        f1, g1, aux1 = alone(x)
        r1, ll1 = tobj.holdout_metrics(unravel(x), aux1.w, tdv, tcfg,
                                       complete=vcomplete)
        for got, want in ((f[b], f1), (g[b], g1), (aux.w[b], aux1.w),
                          (aux.train_rmse[b], aux1.train_rmse),
                          (aux.train_ll[b], aux1.train_ll), (r[b], r1),
                          (ll[b], ll1)):
            assert torch.equal(got, want)
