"""A short window of batches under torch.profiler, reduced to the device's
busy time (the union of its kernel and copy intervals), device time by
kernel name, and the idle gaps by what the host was doing in them."""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Profile:
    batches: int
    window_s: float
    busy_s: float
    by_kernel: dict          # name → device seconds
    idle_by_host: dict       # host activity → idle seconds


def _union(spans):
    """(busy length, merged intervals) of (start, end) intervals."""
    merged = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def profile(run_batch, n: int, cuda: bool = True) -> Profile:
    """Runs ``run_batch(i)`` for i < n under the profiler (CPU and, with
    ``cuda``, CUDA activity) and reduces the trace."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts) as prof:
        with torch.profiler.record_function("orbench.window"):
            t0 = time.perf_counter()
            for i in range(n):
                run_batch(i)
            host_s = time.perf_counter() - t0
    events = prof.events()
    dev, cpu, window = [], [], None
    by_kernel: dict = {}
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("orbench.") or getattr(
                    e, "is_user_annotation", False):
                continue                    # a label's range, not work
            dev.append((s, t))
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + (t - s) / 1e6
        else:
            if e.name == "orbench.window":
                window = (s, t)
            cpu.append((s, t, e.name))
    busy_us, merged = _union(dev)
    if window is None:
        window = (min(s for s, _, _ in cpu), max(t for _, t, _ in cpu))
    # idle gaps inside the window, named by the innermost orbench label and
    # the innermost other host event at the gap's middle
    edges = [window[0]] + [x for iv in merged for x in iv] + [window[1]]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    starts = np.array([c[0] for c in cpu], np.float64)
    ends = np.array([c[1] for c in cpu], np.float64)
    idle: dict = {}
    for a, b in gaps[:400]:
        mid = 0.5 * (a + b)
        hit = np.flatnonzero((starts <= mid) & (ends >= mid))
        label, op = "", ""
        best_l, best_o = np.inf, np.inf
        for j in hit:
            name, dur = cpu[j][2], ends[j] - starts[j]
            if name.startswith("orbench.") and name != "orbench.window":
                if dur < best_l:
                    best_l, label = dur, name[len("orbench."):]
            elif not name.startswith("orbench.") and dur < best_o:
                best_o, op = dur, name
        key = " > ".join(x for x in (label, op) if x) or "host (no event)"
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e6
    window_s = (window[1] - window[0]) / 1e6 if window[1] > window[0] \
        else host_s
    return Profile(n, window_s, busy_us / 1e6, by_kernel, idle)
