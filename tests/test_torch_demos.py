"""gpz_tpu_torch.demos against the JAX demo scripts: each demo's `main` on
the CPU at the small size of tests/make_torch_port_golden.py's DEMO_SIZES
prints the JAX script's lines, and every number `run` returns agrees with
what the JAX script printed within two units of its last printed digit
(tests/data/torch_port_golden_demos.npz; the full-size comparison is
chip_smoke.py's phase 19, on the GPU)."""

import contextlib
import importlib
import io
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (one torch thread per test process)
from make_torch_port_golden import (
    DEMO_COMMON, DEMO_NUMBERS, DEMO_SIZES, DEMOS, line_layout,
    load_golden_demos, printed_band, printed_numbers, result_lines,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden():
    return load_golden_demos()


def small_argv(demo):
    return list(DEMO_COMMON + DEMO_SIZES[demo]["small"])


@pytest.fixture(scope="module")
def small_runs():
    """{demo: (what main printed, the dict run returned)}: one run each, at
    the small size on the CPU."""
    out = {}
    for demo in DEMOS:
        mod = importlib.import_module(f"gpz_tpu_torch.demos.demo_{demo}")
        real, seen = mod.run, []

        def keep(*a, **kw):
            seen.append(real(*a, **kw))
            return seen[-1]

        mod.run = keep
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                mod.main(small_argv(demo) + ["--device", "cpu"])
        finally:
            mod.run = real
        out[demo] = (buf.getvalue(), seen[0])
    return out


@pytest.mark.parametrize("demo", DEMOS)
def test_run_agrees_with_the_jax_script(demo, golden, small_runs):
    _, r = small_runs[demo]
    printed = golden[f"{demo}.small.printed"]
    assert len(printed) == len(DEMO_NUMBERS[demo])
    for name, want in zip(DEMO_NUMBERS[demo], printed):
        band = printed_band(str(want))
        assert np.isfinite(r[name])
        assert abs(r[name] - float(want)) <= band, (name, r[name], want)
    for fit in r["fits"]:
        assert np.all(np.diff(fit["trace"]["f"]) <= 0)


@pytest.mark.parametrize("demo", DEMOS)
def test_main_prints_the_jax_scripts_lines(demo, golden, small_runs):
    """The same lines as the JAX script's, numbers aside (the training
    tables included), and the printed numbers within the band."""
    stdout, _ = small_runs[demo]
    want = str(golden[f"{demo}.small.stdout"])
    assert line_layout(stdout.splitlines()) == line_layout(want.splitlines())
    assert len(result_lines(stdout)) == len(result_lines(want))
    for got, exp in zip(printed_numbers(stdout), printed_numbers(want)):
        assert abs(float(got) - float(exp)) <= printed_band(exp), (got, exp)


@pytest.mark.parametrize("demo", DEMOS)
def test_demos_default_to_the_gpu(demo):
    """Without --device a demo goes to the CUDA device: on a machine without
    one it raises torch's error."""
    if torch.cuda.is_available():
        return
    mod = importlib.import_module(f"gpz_tpu_torch.demos.demo_{demo}")
    with pytest.raises((RuntimeError, AssertionError), match="(?i)cuda"):
        mod.main(small_argv(demo))


def test_sinc_plot_is_written_only_where_asked(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    from gpz_tpu_torch.demos import demo_sinc

    beside = os.path.join(ROOT, "demos", "sinc_posterior_samples.png")
    before = os.stat(beside).st_mtime_ns
    path = tmp_path / "curves.png"
    demo_sinc.main(["--n", "300", "--m", "5", "--max-iter", "3",
                    "--device", "cpu", "--plot", str(path)])
    assert path.stat().st_size > 0
    assert capsys.readouterr().out.splitlines()[-1] == f"  wrote {path}"
    r = demo_sinc.run(n=300, m=5, max_iter=3, device="cpu")
    assert r["plot"] is None
    assert os.stat(beside).st_mtime_ns == before
