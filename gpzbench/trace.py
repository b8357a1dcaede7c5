"""What a traced run reads from torch.profiler: the device's busy time as
the union of its operations' intervals inside the traced window (kernels,
copies and fills that overlap count once), device time by operation name,
and the idle gaps between device operations named by what the host was
doing in them (the innermost host event that spans the gap's middle).
"""

from __future__ import annotations

import contextlib

import numpy as np

#: the host annotation around the measured window
WINDOW = "gpzbench.window"
#: host events looked back over, from the last one to start before a gap's
#: middle, for the innermost one that spans it
LOOK_BACK = 64


def _events(prof):
    """(host events, device events) as (name, start ns, end ns) lists. The
    host's annotations also show on the device's timeline, spanning the
    operations they enclose: they are no device operation."""
    from torch.autograd import DeviceType

    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.name(), e.start_ns(), e.end_ns())
        if e.device_type() != DeviceType.CUDA:
            host.append(span)
        elif not (e.is_user_annotation() or span[0].startswith("gpzbench.")):
            device.append(span)
    return host, device


def _union(intervals):
    """Merged, sorted (starts, ends) of intervals (an (N, 2) array)."""
    if not len(intervals):
        return np.zeros(0), np.zeros(0)
    iv = intervals[np.argsort(intervals[:, 0])]
    starts, ends = [iv[0, 0]], [iv[0, 1]]
    for s, e in iv[1:]:
        if s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.array(starts), np.array(ends)


def _name_gaps(gap_s, gap_e, host) -> dict:
    """{host event name: idle seconds} over every gap (ns bounds): each gap
    goes to the innermost host event spanning its middle (the latest to
    start among the LOOK_BACK last to start before it), else to the latest
    to start of the long events that span it, else to "(no host
    event)"."""
    keep = gap_e > gap_s
    gap_s, gap_e = gap_s[keep], gap_e[keep]
    if not len(host):
        return {"(no host event)": float(np.sum(gap_e - gap_s)) * 1e-9}
    order = np.argsort([h[1] for h in host], kind="stable")
    hs = np.array([host[i][1] for i in order], dtype=np.float64)
    he = np.array([host[i][2] for i in order], dtype=np.float64)
    names = np.array([host[i][0] for i in order] + ["(no host event)"],
                     dtype=object)
    mid = 0.5 * (gap_s + gap_e)
    last = np.searchsorted(hs, mid, side="right") - 1
    pick = np.full(len(mid), -1)
    for k in range(LOOK_BACK):
        at = last - k
        hit = (pick < 0) & (at >= 0) & (he[np.maximum(at, 0)] >= mid)
        pick[hit] = at[hit]
    # a gap that no recent event spans: the latest to start of the long
    # events (a millisecond or more: spans, whole ops) that span it
    long_ = np.nonzero(he - hs >= 1e6)[0]
    for g in np.nonzero(pick < 0)[0]:
        inside = long_[(hs[long_] <= mid[g]) & (he[long_] >= mid[g])]
        pick[g] = inside[np.argmax(hs[inside])] if len(inside) else -1
    out = {}
    for name, secs in zip(names[pick], (gap_e - gap_s) * 1e-9):
        out[name] = out.get(name, 0.0) + secs
    return out


def summarise(prof) -> dict:
    """busy_s, window_s, device seconds by name, and the breakdown lists
    (device_ops, idle_gaps: at most 10 entries each)."""
    host, device = _events(prof)
    win = [h for h in host if h[0] == WINDOW]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    w0, w1 = win[0][1], win[0][2]
    by_name = {}
    iv = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        iv.append((s, e))
    starts, ends = _union(np.array(iv, dtype=np.float64).reshape(-1, 2))
    busy = float(np.sum(ends - starts)) * 1e-9
    gap_s = np.concatenate([[w0], ends])
    gap_e = np.concatenate([starts, [w1]])
    gaps = _name_gaps(gap_s, gap_e, [h for h in host if h[0] != WINDOW])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy,
        "window_s": (w1 - w0) * 1e-9,
        "device_s": by_name,
        "breakdown": {
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in sorted(
                gaps.items(), key=lambda kv: -kv[1])[:10]],
        },
    }


@contextlib.contextmanager
def profiled(enabled: bool):
    """torch.profiler over host and device while the block runs (nothing
    when not enabled); yields the profiler or None."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof


def span(name: str, enabled: bool):
    """A host annotation that the trace shows (nothing when not enabled)."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
