"""gpz_tpu_torch.inference's NUTS alone on the hard targets of
tests/test_nuts.py: the anisotropic scales (per chain and collective) and the
banana, seeded so that each run draws the same chains. Each tolerance is
stated against the exact moments, as in tests/test_torch_samplers.py.
"""

import numpy as np
import torch_threads  # noqa: F401  (one torch thread per process)
import pytest
import torch

from test_torch_samplers import SCALES, anisotropic, banana, run


@pytest.mark.parametrize("collective", [False, True],
                         ids=["per-chain", "collective"])
def test_nuts_anisotropic_scales(collective):
    """The mass matrix must resolve a 400x spread of scales: sds within
    40% (4 chains x 200 draws; the widest scale mixes slowest, ~30
    effective draws, se of its sd ~13%; seeds 0-5 read 0.86-1.33 of it
    per chain and 1.00-1.11 collectively)."""
    samples, info = run("nuts_sample", anisotropic(torch.tensor), 3, seed=1,
                        num_warmup=200, num_samples=200, num_chains=4,
                        max_depth=8, collective_adapt=collective)
    got = samples.reshape(-1, 3).numpy().std(0)
    np.testing.assert_allclose(got, SCALES, rtol=0.4)
    assert float(info["accept_rate"].mean()) > 0.6


def test_nuts_banana_analytic_moments():
    """Curved target: means within 0.35 of [0, 1.2], sds within 25% of
    [2.0, 1.97] (3 chains x 400 draws; the banana's tails make its draws
    strongly correlated)."""
    samples, info = run("nuts_sample", banana(torch.tensor), 2, seed=5,
                        num_warmup=300, num_samples=400, num_chains=3,
                        max_depth=8)
    a = samples.reshape(-1, 2).numpy()
    np.testing.assert_allclose(a.mean(0), [0.0, 1.2], atol=0.35)
    np.testing.assert_allclose(a.std(0), [2.0, 1.97], rtol=0.25)
    assert float(info["accept_rate"].mean()) > 0.5
