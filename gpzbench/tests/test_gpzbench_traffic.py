"""The traffic repeats from its seed, and has the sizes and the shares of
missing bands that its files state."""

import contextlib
import os

import numpy as np
import pytest
import torch

import tiny
from gpzbench import data, harness

SEED = 2**31 + 987_654_321


def test_problem_repeats_and_splits():
    cfg = dict(tiny.TINY_CFG, d=5)
    a = data.training_problem(cfg, SEED)
    b = data.training_problem(cfg, SEED)
    c = data.training_problem(cfg, SEED + 1)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
    assert not np.array_equal(a[0], c[0])
    X, Y, psi, tr, va = a
    assert X.shape == (cfg["n_train"] + cfg["n_valid"], 5)
    assert tr.sum() == cfg["n_train"] and not (tr & va).any()
    assert tr[:cfg["n_train"]].all()
    assert np.all(psi > 0) and not np.isnan(X).any()


@pytest.mark.parametrize("mix", ["serve_nan", "serve_clean"])
def test_catalogue_shares(mix):
    spec = harness.load_json(os.path.join(harness.HERE, "traffic",
                                          mix + ".json"))
    rows = 20_000
    X, psi = data.catalogue({"d": 5}, rows, spec["missing"], SEED)
    X2, _ = data.catalogue({"d": 5}, rows, spec["missing"], SEED)
    assert np.array_equal(np.isnan(X), np.isnan(X2))
    nan = np.isnan(X)
    first_only = nan[:, 0] & ~nan[:, 4]
    last_only = nan[:, 4] & ~nan[:, 0]
    both = nan[:, 0] & nan[:, 4]
    assert not nan[:, 1:4].any()
    if spec["missing"] is None:
        assert not nan.any()
        return
    shares = spec["missing"]
    assert first_only.sum() == round(shares["first"] * rows)
    assert last_only.sum() == round(shares["last"] * rows)
    assert both.sum() == round(shares["both"] * rows)
    assert shares == {"first": 0.25, "last": 0.10, "both": 0.05}


def test_request_sizes_are_one_cycle_in_a_seeded_order():
    """Every seed sends the same sizes: an even spread over the stated
    range, in an order of its own."""
    cell = harness.find_cell(tiny.bench(), "photoz_m100.serve_nan")
    lo, hi = cell.traffic["request_rows"]
    assert (lo, hi) == (1000, 5000)
    K = cell.traffic["sizes_cycle"]
    sizes = lo + (np.arange(K) * (hi - lo)) // (K - 1)
    assert sizes[0] == lo and sizes[-1] == hi
    assert abs(sizes.mean() - 3000) < 1
    orders = []
    for seed in (SEED, SEED, SEED + 7):
        rng = data.rng_for(seed, 6)
        orders.append(sizes[rng.permutation(K)])
    assert np.array_equal(orders[0], orders[1])
    assert not np.array_equal(orders[0], orders[2])
    assert sorted(orders[0]) == sorted(orders[2])


def test_serving_window_sends_the_cycle():
    """A tiny serving run: its requests take the cycle's sizes in order
    and every answer is there."""
    cell = tiny.tiny_cell("photoz_m100.serve_nan",
                          {"mu_err": 1.0, "sigma_err": 1.0})
    gen = harness.load_module(
        os.path.join(harness.HERE, "traffic", "serve.py"), "srv")
    ctx = harness.Context(cell=cell, seed=SEED, device=torch.device("cpu"),
                          trace=False)
    state = gen.setup(ctx)
    rec = gen.window(state, 0.3, lambda n: contextlib.nullcontext())
    K = len(state.sizes)
    assert rec.sizes == [int(state.sizes[i % K])
                         for i in range(len(rec.sizes))]
    assert rec.rows == sum(rec.sizes) and rec.failed == 0


def test_further_draws_of_the_training_problem():
    """Draw 0 is the seed's first draw; each further draw is new, and
    repeats from the seed."""
    cfg = dict(tiny.TINY_CFG, d=5)
    first = data.training_problem(cfg, SEED)
    assert np.array_equal(data.training_problem(cfg, SEED, 0)[0], first[0])
    again = data.training_problem(cfg, SEED, 1)
    assert not np.array_equal(again[0], first[0])
    assert np.array_equal(data.training_problem(cfg, SEED, 1)[0], again[0])
    assert data.init_seed(SEED, 0) == data.init_seed(SEED)
    assert data.init_seed(SEED, 1) != data.init_seed(SEED)


def test_basis_condition():
    gen = harness.load_module(
        os.path.join(harness.HERE, "traffic", "serve.py"), "srv")
    gamma = np.stack([np.eye(3), np.diag([1.0, 1e-3, 2.0])])
    assert np.isclose(gen.basis_condition(gamma), (2.0 / 1e-3) ** 2)


@pytest.mark.parametrize("cap, draws", [(1e30, 1), (1.0, None)])
def test_degenerate_served_model_is_drawn_again(cap, draws):
    """A served model whose basis condition passes the cell's cap is
    trained again from the seed's next draw, and set-up fails once the
    draws are spent."""
    cell = tiny.tiny_cell("photoz_m100.serve_nan")
    cell.spec["served_model"] = {"max_basis_cond": cap, "draws": 2}
    gen = harness.load_module(
        os.path.join(harness.HERE, "traffic", "serve.py"), "srv")
    ctx = harness.Context(cell=cell, seed=SEED, device=torch.device("cpu"),
                          trace=False)
    if draws is None:
        with pytest.raises(RuntimeError, match="within 2 draws"):
            gen._train_served_model(ctx)
        return
    model, problem, made, cond = gen._train_served_model(ctx)
    assert made == draws and 1.0 <= cond <= cap
    assert np.array_equal(problem[0],
                          data.training_problem(cell.cfg, SEED)[0])
