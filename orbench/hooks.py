"""Observation of the program from outside it: module attributes wrapped
for one run (restored on close), per-batch records of what a layer was
handed and returned, and host or CUDA-event spans around the calls into a
layer."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext

import torch


class Hooks:
    """Module attributes replaced for the life of a run."""

    def __init__(self) -> None:
        self._saved = []

    def wrap(self, module, attr: str, make) -> None:
        """``module.attr`` becomes ``make(real)``."""
        real = getattr(module, attr)
        self._saved.append((module, attr, real))
        setattr(module, attr, make(real))

    def close(self) -> None:
        while self._saved:
            module, attr, real = self._saved.pop()
            setattr(module, attr, real)


class Records:
    """What each layer was handed and returned in the latest call on each
    pool slot: ``add(kind, value)`` appends to the current slot."""

    def __init__(self) -> None:
        self.slots: dict = {}
        self._cur = None

    def begin(self, slot: int) -> None:
        self._cur = self.slots[slot] = defaultdict(list)

    def add(self, kind: str, value) -> None:
        self._cur[kind].append(value)


class Spans:
    """Per-batch sums of span times in ms (only while ``on``): ``host``
    times a call on the host clock, synchronising the device at both edges
    when ``sync``; ``cuda`` times it with CUDA events. While ``on`` or
    ``labels`` each call carries a profiler label ``orbench.<name>``."""

    def __init__(self, on: bool, cuda: bool = True) -> None:
        self.on = on
        self.labels = False
        self.cuda_on = cuda
        self.batches: list = []
        self._cur: dict = defaultdict(float)
        self._events: list = []

    def host(self, name: str, fn, *args, sync: bool = True, **kw):
        if not self.on:
            with self.label(name):
                return fn(*args, **kw)
        with torch.profiler.record_function(f"orbench.{name}"):
            if sync and self.cuda_on:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            if sync and self.cuda_on:
                torch.cuda.synchronize()
            self._cur[name] += (time.perf_counter() - t0) * 1e3
        return out

    def cuda(self, name: str, fn, *args, **kw):
        if not self.on:
            with self.label(name):
                return fn(*args, **kw)
        if not self.cuda_on:
            return self.host(name, fn, *args, **kw)
        with torch.profiler.record_function(f"orbench.{name}"):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args, **kw)
            b.record()
        self._events.append((name, a, b))
        return out

    def label(self, name: str):
        return torch.profiler.record_function(f"orbench.{name}") \
            if self.on or self.labels else nullcontext()

    def end_batch(self) -> None:
        """Closes a batch (after the device is synchronised)."""
        if not self.on:
            return
        for name, a, b in self._events:
            self._cur[name] += a.elapsed_time(b)
        self.batches.append(dict(self._cur))
        self._cur = defaultdict(float)
        self._events = []

    def mean(self, name: str):
        """Mean ms a batch, or None where no batch has the span."""
        if not any(name in b for b in self.batches):
            return None
        return sum(b.get(name, 0.0) for b in self.batches) / len(self.batches)
