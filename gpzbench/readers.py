"""Arithmetic that several per-layer readers share: a kernel's share of
its roofline, the device's idle share, per-thousand-row rates."""

from __future__ import annotations

from gpzbench import roofline


def per_krow(count, rows):
    return None if not rows else count * 1e3 / rows


def kernel_roofline(r, kind: str):
    """Percent: the least time of every recorded call of the pair's `kind`
    ("fwd", "bwd") over the device time of its kernels in the window;
    nothing where no such kernel ran."""
    calls = r.probes.fwd if kind == "fwd" else r.probes.bwd
    device = sum(s for name, s in r.trace["device_s"].items()
                 if f"vc_lnphi_{kind}" in name)
    if not calls or device <= 0:
        return None
    least = sum(roofline.least_seconds(kind, n, m, d, dt)
                for n, m, d, dt in calls)
    return 100.0 * least / device


def idle(r):
    """Percent of the traced window in which no operation ran on the
    device."""
    w = r.trace["window_s"]
    return None if w <= 0 else 100.0 * (1.0 - r.trace["busy_s"] / w)


def mfu(r, flops: float, dtype: str):
    """Percent of the peak of `dtype` that `flops` over the traced window
    reach."""
    w = r.trace["window_s"]
    return None if w <= 0 else 100.0 * flops / (
        w * roofline.PEAK_FLOPS[dtype])
