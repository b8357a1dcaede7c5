"""The samplers' collective warmup pooled over ranks (axis_name, a
torch.distributed process group): tests/test_collective_adapt.py's two
sharded cases, HMC and NUTS with 2 chains on each of 4 gloo ranks on the
CPU, chains split over the mesh's restart group. The adapted step size is a
collective: bit-equal on every rank; the pooled draws recover the
correlated Gaussian within gpz_tpu's test's bounds. torch cannot draw
JAX's random numbers, so the comparison with gpz_tpu is that statistical
one.

The four ranks run once for the whole file (module fixture,
tests/torch_parallel_worker.py's "adapt" scenario, 120 s at most).
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest

import torch_parallel_worker as w
from test_torch_parallel import same_on_all


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    handle = w.Ranks("adapt", 4, str(tmp_path_factory.mktemp("adapt")))
    yield handle
    handle.close()


@pytest.mark.parametrize("sampler", ["hmc", "nuts"])
def test_collective_sharded_over_restart_axis(ranks, sampler):
    _, mu, _ = w.corr_gauss()
    chains, _, draws, _ = w.ADAPT
    eps = same_on_all(ranks, f"{sampler}.step_size")
    assert eps.shape == () and float(eps) > 0
    samples = np.concatenate([r[f"{sampler}.samples"]
                              for r in ranks.results()])
    assert samples.shape == (4 * chains, draws, 3)
    flat = samples.reshape(-1, 3)
    assert np.all(np.isfinite(flat))
    np.testing.assert_allclose(flat.mean(0), mu, atol=0.2)
    accept = np.concatenate([r[f"{sampler}.accept"]
                             for r in ranks.results()])
    assert float(np.mean(accept)) > 0.5
    # the ranks drew different chains: only the pooled statistics meet
    assert not np.array_equal(ranks.results()[0][f"{sampler}.samples"],
                              ranks.results()[1][f"{sampler}.samples"])
