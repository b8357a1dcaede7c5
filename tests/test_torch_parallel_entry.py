"""The multi-process entry of gpz_tpu_torch.parallel on two gloo ranks on
the CPU, against the port in one process and against gpz_tpu in float64:
tests/test_distributed.py's cases (initialize -> host_row_range ->
global_dataset -> sharded objective -> train_sharded, psi=None, unequal
local rows padded by pad_dataset, initialize's failure contract), with the
padded split's gradient on each rank. In this process: pad_dataset against
gpz_tpu's, padded rows in the objective, nlog_ml_batched with n_eff, and
make_mesh without a group.

The two ranks run once for the whole file (module fixture,
tests/torch_parallel_worker.py's "entry" scenario, 120 s at most).
Tolerances: tests/test_torch_parallel.py's.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from gpz_tpu.dataset import Dataset as JDataset, pad_dataset as jpad_dataset

from gpz_tpu_torch import objective as tobj
from gpz_tpu_torch.dataset import pad_dataset
from gpz_tpu_torch.model import _objective
from gpz_tpu_torch.parallel import distributed, make_mesh

from test_torch_objective import GRAD, VALUE
from test_torch_parallel import (
    SHARDED_F, SHARDED_G, jax_value_and_grad, port_value_and_grad,
    same_on_all,
)
import torch_parallel_worker as w


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = w.Ranks("entry", 2, str(tmp_path_factory.mktemp("entry")))
    yield handle
    handle.close()


def test_two_process_distributed_matches_single(ranks):
    params, data, cfg = w.port_problem("VD", True, w.DIST_ROWS, 5)
    f1, _ = tobj.nlog_ml(params, data, cfg, complete=True)
    for r in ranks.results():
        assert float(r["dist.n_eff"]) == w.DIST_ROWS
        np.testing.assert_allclose(float(r["dist.f"]), float(f1),
                                   **SHARDED_F)
    same_on_all(ranks, "dist.f")
    r0, r1 = (r["dist.row_range"].tolist() for r in ranks.results())
    assert r0[1] == r1[0] and r0[0] == 0 and r1[1] == w.DIST_ROWS


def test_two_process_train_step_progresses(ranks):
    tr = same_on_all(ranks, "dist.train_f")
    assert np.isfinite(tr).all()
    assert tr[-1] < tr[0]


def test_two_process_psi_none(ranks):
    params, data, cfg = w.port_problem("VD", True, w.DIST_ROWS, 5)
    data.psi = None
    f1, _ = tobj.nlog_ml(params, data, cfg, complete=True)
    np.testing.assert_allclose(same_on_all(ranks, "dist_nopsi.f"),
                               float(f1), **SHARDED_F)


def test_two_process_unequal_local_rows(ranks):
    """63 rows load as 32 / 31, the short rank pads with an omega=0 row:
    the value and each rank's gradient are those of the 63 rows, and
    n_eff counts only real rows. Unpadded, every rank raises."""
    rows = sorted(int(r["uneven.local_rows"]) for r in ranks.results())
    assert rows == [31, 32]
    f1, g1, _ = port_value_and_grad("VC", True, w.UNEVEN_ROWS, 11)
    fj, gj = jax_value_and_grad("VC", True, w.UNEVEN_ROWS, 11)
    for r in ranks.results():
        assert float(r["uneven.n_eff"]) == w.UNEVEN_ROWS
        np.testing.assert_allclose(r["uneven.g"], g1, **SHARDED_G)
        assert "pad_dataset" in str(r["uneven.unpadded_error"])
    np.testing.assert_allclose(same_on_all(ranks, "uneven.f"), f1,
                               **SHARDED_F)
    np.testing.assert_allclose(same_on_all(ranks, "uneven.f"), fj, **VALUE)
    np.testing.assert_allclose(same_on_all(ranks, "uneven.g"), gj, **GRAD)


def test_initialize_explicit_args_propagate_failures(monkeypatch):
    """Explicit arguments: a failure to form the group raises (a swallowed
    one would quietly run one process). Without them and without torch's
    environment variables nothing is initialized; once initialized,
    nothing is attempted again."""
    calls = []

    def fake_init(backend, **kw):
        calls.append((backend, kw))
        raise RuntimeError("coordinator unreachable")

    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize("10.0.0.1:1234", 2, 0, backend="gloo")
    assert calls == [("gloo", dict(init_method="tcp://10.0.0.1:1234",
                                   world_size=2, rank=0,
                                   timeout=distributed.TIMEOUT))]

    for k in distributed._ENV:
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()           # single-process: must not raise
    assert len(calls) == 1
    for k, v in zip(distributed._ENV, ("10.0.0.1", "1234", "2", "1")):
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="coordinator unreachable"):
        distributed.initialize(backend="gloo")
    assert calls[-1] == ("gloo", dict(init_method="env://",
                                      timeout=distributed.TIMEOUT))

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    distributed.initialize("10.0.0.1:1234", 2, 0)
    assert len(calls) == 2


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="distributed.initialize"):
        make_mesh()
    assert distributed.host_row_range(10) == (0, 10)


@pytest.mark.parametrize("case", [("VC", True, False), ("VD", True, True),
                                  ("VL", False, False)],
                         ids=["VC-psi", "VD-nan", "VL"])
def test_pad_dataset_matches_gpz_tpu(case):
    method, psi, missing = case
    _, data, _ = w.problem(method, psi, 13, 2, missing)
    got = pad_dataset(w.to_dataset(data), 16)
    jd = JDataset(**{f: None if v is None else jnp.asarray(v)
                     for f, v in data.items()})
    want = jpad_dataset(jd, 16)
    for f in ("X", "mask", "omega", "Y", "psi"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == torch.from_numpy(np.array(b)).dtype, f
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    assert bool(got.mask[13:].all()) and not bool(got.omega[13:].any())
    assert pad_dataset(got, 16) is got
    with pytest.raises(ValueError, match="cannot pad 16 rows down to 15"):
        pad_dataset(got, 15)


@pytest.mark.parametrize("missing", [False, True], ids=["complete", "nan"])
def test_padded_rows_change_neither_value_nor_gradient(missing):
    """omega=0 rows add exact zeros to every reduction, rows with NaNs
    included (their mask is True, so PHI stays finite)."""
    method = "VD" if missing else "VC"
    params, data, cfg = w.port_problem(method, True, 21, 12, missing)
    flat, unravel = params.flatten()
    complete = not missing
    f1, g1, a1 = _objective(unravel, data, cfg, complete)(flat)
    padded = pad_dataset(data, 24)
    fun = _objective(unravel, padded, cfg, complete)

    def fun_n(flat):
        flat = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            f, aux = tobj.nlog_ml(unravel(flat), padded, cfg, n_eff=21,
                                  complete=complete)
            g, = torch.autograd.grad(f, flat)
        return f.detach(), g, aux

    f2, g2, a2 = fun_n(flat)
    np.testing.assert_allclose(float(f2), float(f1), **SHARDED_F)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), **SHARDED_G)
    np.testing.assert_allclose(float(a2.train_rmse), float(a1.train_rmse),
                               **SHARDED_F)
    # without n_eff the padded rows count in the normalization only
    f3 = float(fun(flat)[0])
    np.testing.assert_allclose(f3 * 24, float(f1) * 21, rtol=1e-12)


def test_nlog_ml_batched_with_n_eff_on_a_padded_batch():
    params, data, cfg = w.port_problem("VC", True, 19, 13)
    flat, unravel = params.flatten()
    batch = torch.stack([flat, flat + 0.01 * torch.sin(torch.arange(
        flat.shape[0], dtype=flat.dtype))])
    want = tobj.nlog_ml_batched(batch, unravel, data, cfg, complete=True)
    got = tobj.nlog_ml_batched(batch, unravel, pad_dataset(data, 24), cfg,
                               complete=True, n_eff=19)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SHARDED_F)
    for b in range(2):
        single, _ = tobj.nlog_ml(unravel(batch[b]), data, cfg, complete=True)
        np.testing.assert_allclose(float(got[b]), float(single), rtol=1e-12)


def test_world_of_one_in_this_process(tmp_path):
    """A group of one rank, what chip_smoke.py's phase 18 (a) runs under
    NCCL: a (1, 1) mesh; the sharded value and gradient are nlog_ml's bit
    for bit (the all-reduces of one rank, the mean over one); and
    global_dataset without a device goes to the CUDA device, torch's error
    here."""
    from gpz_tpu_torch.parallel import RESTART_AXIS, sharded_nlog_ml

    distributed.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                           backend="gloo")
    try:
        distributed.initialize("10.0.0.1:1234", 2, 0)   # idempotent
        mesh = make_mesh()
        assert mesh.shape == {RESTART_AXIS: 1, "data": 1}
        assert distributed.host_row_range(10) == (0, 10)
        params, data, cfg = w.port_problem("VC", True, 21, 14)
        flat, unravel = params.flatten()
        f1, g1, _ = _objective(unravel, data, cfg, True)(flat)
        flat = flat.clone().requires_grad_(True)
        f2, _ = sharded_nlog_ml(unravel(flat), data, cfg, mesh, 21.0,
                                complete=True)
        f2.backward()
        assert float(f2.detach()) == float(f1)
        assert torch.equal(flat.grad, g1)
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            distributed.global_dataset(data, mesh)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()
