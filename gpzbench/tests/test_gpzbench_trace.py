"""The trace's arithmetic: busy time is the union of device intervals,
and each idle gap goes to the innermost host event that spans it."""

import numpy as np

from gpzbench import trace


def test_union_counts_overlaps_once():
    iv = np.array([[0, 10], [5, 12], [20, 30], [25, 26], [40, 41]], float)
    starts, ends = trace._union(iv)
    assert starts.tolist() == [0, 20, 40] and ends.tolist() == [12, 30, 41]
    assert float(np.sum(ends - starts)) == 23


def test_gaps_go_to_the_innermost_host_event():
    ms = 1e6
    host = [("gpzbench.request", 0, 100 * ms),      # a span over all
            ("aten::mm", 10 * ms, 20 * ms),
            ("cudaMemcpyAsync", 12 * ms, 14 * ms),
            ("aten::add", 30 * ms, 31 * ms)]
    gap_s = np.array([12.5, 40, 150]) * ms
    gap_e = np.array([13.5, 60, 160]) * ms
    got = trace._name_gaps(gap_s, gap_e, host)
    assert got == {"cudaMemcpyAsync": 1e-3, "gpzbench.request": 20e-3,
                   "(no host event)": 10e-3}


def test_many_short_ops_before_a_gap():
    """The span that holds a gap is found past more events than the look
    back reaches."""
    us = 1e3
    host = [("gpzbench.job", 0, 10_000 * us)]
    host += [("aten::mul", i * us, i * us + 0.5 * us) for i in range(200)]
    got = trace._name_gaps(np.array([500 * us]), np.array([600 * us]), host)
    assert got == {"gpzbench.job": 100e-6}
