"""The traced segment of a ``--trace 1`` run and its reduction to numbers.

A few steps run under ``torch.profiler`` (host and device activity) after
the measured window.  From the profiler's raw events come the device busy
time (the union of the device operations' intervals), the device time
and count of each work class's kernels (``work.kernel_classes``), the
device operations that took most time, and the idle gaps between device
operations named by the innermost host operation that spans each gap.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import NamedTuple

import torch

from . import work


class Trace(NamedTuple):
    busy_s: float
    window_s: float
    fcycles: int                 # F-cycles the traced solves ran
    replays: int                 # graph replays among them (0 eagerly)
    class_seconds: dict          # work class -> device seconds
    class_count: dict            # work class -> kernels traced
    device_ops: list             # [[name, seconds]], the 10 longest by name
    idle_gaps: list              # [[host activity, seconds]], 10 largest


def _raw_events(prof):
    """(device events, host events) as (name, start us, end us), read from
    the profiler's raw results (building its event tree in Python takes
    seconds at 100k events)."""
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    evs = raw.events() if raw is not None else []
    if evs and hasattr(evs[0], "end_ns"):
        dev = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
               for e in evs if e.device_type() == cuda]
        host = [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
                for e in evs if e.device_type() == cpu]
        return dev, host
    dev = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.device_type == cuda]
    host = [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == cpu]
    return dev, host


def _union(spans):
    """Sorted disjoint intervals covering ``spans`` (start, end)."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _name_gaps(gaps, host) -> dict:
    """Seconds of idle gap by the innermost host event spanning each gap's
    midpoint ("host: none traced" where none does)."""
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    out = collections.Counter()
    for a, b in gaps:
        mid = 0.5 * (a + b)
        name = "host: none traced"
        # the innermost spanning event is the latest-starting one that
        # still runs at the midpoint
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        out[name] += (b - a) / 1e6
    return out


def profile_warmup() -> None:
    """Start the profiler once on a trivial op, so that its one-off
    initialisation falls outside the traced segment."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def traced(run_steps, sync) -> Trace:
    """The :class:`Trace` of ``run_steps()``, which returns the F-cycles
    and the graph replays it ran, under the profiler; ``sync()`` waits
    for the device."""
    from torch.profiler import ProfilerActivity, profile
    table = work.kernel_classes()
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fcycles, replays = run_steps()
        sync()
        window_s = time.perf_counter() - t0
    dev, host = _raw_events(prof)
    busy = _union((a, b) for _, a, b in dev)
    busy_s = sum(b - a for a, b in busy) / 1e6
    by_name = collections.Counter()
    cls_s, cls_n = collections.Counter(), collections.Counter()
    for name, a, b in dev:
        by_name[name] += (b - a) / 1e6
        cls = work.classify(name, table)
        if cls is not None:
            cls_s[cls] += (b - a) / 1e6
            cls_n[cls] += 1
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    named = _name_gaps(gaps, host)
    if busy:
        named["before the first and after the last device op"] += max(
            0.0, window_s - (busy[-1][1] - busy[0][0]) / 1e6)
    return Trace(busy_s, window_s, fcycles, replays, dict(cls_s),
                 dict(cls_n),
                 [[n[:160], s] for n, s in by_name.most_common(10)],
                 [[n[:160], s] for n, s in named.most_common(10)])
