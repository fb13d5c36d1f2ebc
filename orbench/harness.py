"""One run of one benchmark cell.

Everything is found by name: ``BENCHMARK.json`` names the cell and its
metrics; ``cells/<cell>.json`` names the configuration
(``configs/<config>.json``), the traffic generator (``traffic/<name>.py``,
which reads the cell's parameters), the entry the window drives
(``entries/<name>.py``), the check (``checks/<name>.py``: the plain
reference and the comparison) and each compared number's limit; each
metric is read by ``metrics/<metric>.py``. A new cell, configuration,
traffic mix or metric is new files and entries there.

A run: the pool of batches made from the seed (the benchmark's own plain
transmitter), the entry built and every pool batch decoded once (set-up
ends), then the pool cycled back to back for the window, closed loop, one
client. With ``trace`` the window has spans at the layer boundaries, and a
short profiled window follows it. Then the peak memory, the modules check,
the reference on every pool batch and the comparison.
"""

from __future__ import annotations

import importlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .hooks import Hooks, Records, Spans
from .profiling import profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLED = 32
BANNED = ("jax", "jaxlib", "flax", "orion_sdr_tpu")


def load_json(root: str, *parts) -> dict:
    with open(os.path.join(root, *parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's file with its configuration file under ``config_file``
    and the cell's entries of BENCHMARK.json's metric lists."""
    cell = load_json(root, "orbench", "cells", f"{name}.json")
    cell["name"] = name
    cell["config_file"] = load_json(root, "orbench", "configs",
                                    f"{cell['config']}.json")
    bench = load_json(root, "BENCHMARK.json")
    listed = {w["name"]: w for w in bench["workloads"]}
    if name not in listed:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell["chips"] = listed[name]["chips"]

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    cell["end_to_end"] = mine(bench["end_to_end"])
    cell["per_layer"] = mine(bench["per_layer"])
    return cell


def part(kind: str, name: str):
    return importlib.import_module(f"orbench.{kind}.{name}")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(BANNED))


@dataclass
class Run:
    """What a run measured: metric readers take it."""
    cell: dict
    trace: bool
    setup_s: float = 0.0
    window_s: float = 0.0
    samples: int = 0
    latencies_ms: list = field(default_factory=list)
    spans: Spans = None
    profile: object = None
    records: Records = None
    entry: object = None
    slots_profiled: list = field(default_factory=list)


@dataclass
class Setup:
    """A cell's pool, entry and hooks, ready to call."""
    cell: dict
    pool: list
    entry: object
    check: object
    hooks: Hooks
    records: Records
    spans: Spans
    cuda: bool

    def call(self, slot: int):
        """Decodes pool batch ``slot`` (its layers recorded), the device
        synchronised."""
        self.records.begin(slot)
        out = self.entry.call(self.pool[slot].iq)
        self.records.add("out", out)
        if self.cuda:
            torch.cuda.synchronize()
        return out


def prepare(name: str, seed: int, device: str, root: str = ROOT,
            faults=()) -> Setup:
    """The pool made from ``seed`` and the entry with its hooks installed;
    each of ``faults`` (a test's) then wraps the timed path."""
    cell = load_cell(name, root)
    cfg, params = cell["config_file"], cell["params"]
    pool = part("traffic", cell["generator"]).make(cfg, params, seed, device)
    entry = part("entries", cell["entry"]).Entry(cfg, params, device)
    cuda = torch.device(device).type == "cuda"
    st = Setup(cell, pool, entry, part("checks", cell["check"]), Hooks(),
               Records(), Spans(False, cuda), cuda)
    entry.install(st.hooks, st.records, st.spans)
    for f in faults:
        f(st.hooks, entry)
    return st


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             root: str = ROOT, device: str = "cuda", t_start: float = None,
             faults=()) -> dict:
    """One run; returns the result line's object (and ``"checks"``)."""
    t0 = time.perf_counter() if t_start is None else t_start
    st = prepare(name, seed, device, root, faults)
    cell, pool, entry, check = st.cell, st.pool, st.entry, st.check
    cfg, params = cell["config_file"], cell["params"]
    records, spans, cuda, call = st.records, st.spans, st.cuda, st.call
    run = Run(cell, trace, records=records, spans=spans, entry=entry)
    try:
        w0 = time.perf_counter()
        for slot in range(len(pool)):                 # every shape, once
            call(slot)
        per_batch = (time.perf_counter() - w0) / len(pool)
        run.setup_s = time.perf_counter() - t0
        # the batches whose results are compared: a sample drawn from the
        # seed, about SAMPLED a window, and the last (keeping every
        # result would grow the heap, and the collector's work, all
        # through the window)
        keep = np.random.default_rng([seed, 1]).random(
            int(seconds / max(per_batch, 1e-4) * 4) + 1) < min(
                1.0, SAMPLED * per_batch / max(seconds, 1e-9))
        # the window: end-to-end metrics untraced; with ``trace`` the same
        # loop with spans on, then a short profiled window
        spans.on = trace
        finals, i = [], 0
        start = time.perf_counter()
        while True:
            slot = i % len(pool)
            b0 = time.perf_counter()
            with spans.label("batch"):
                out = call(slot)
            b1 = time.perf_counter()
            run.latencies_ms.append((b1 - b0) * 1e3)
            spans.end_batch()
            run.samples += pool[slot].samples
            if b1 - start >= seconds:
                finals.append((slot, out))
                break
            if i < len(keep) and keep[i]:
                finals.append((slot, out))
            i += 1
        run.window_s = time.perf_counter() - start
        spans.on = False
        if trace:
            n = max(len(pool), int(np.ceil(1.0 / max(
                np.median(run.latencies_ms) / 1e3, 1e-3))))
            n = min(n, 64)
            run.slots_profiled = [j % len(pool) for j in range(n)]

            def labelled(j):
                with spans.label("batch"):
                    call(j % len(pool))
            spans.labels = True
            run.profile = profile(labelled, n, cuda)
            spans.labels = False
        peak = torch.cuda.max_memory_allocated() if cuda else 0
    finally:
        st.hooks.close()
    found = banned_modules()
    if found:
        raise SystemExit(f"modules that may not be loaded: {found}")

    # the comparison: the reference on every pool batch, after the window
    finals = [(s, entry.final(out)) for s, out in finals]
    obs = {s: entry.observe(records.slots[s]) for s in range(len(pool))}
    entry.release()
    refs = {s: check.reference(cfg, params, pool[s], device)
            for s in range(len(pool))}
    numbers = check.compare(cfg, params, obs, refs, finals)
    limits = cell["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    attempted = sum(len(f) for _, f in finals)
    failed = sum(check.failed(pool[s].truth, f) for s, f in finals)

    metrics = {}
    for m in (cell["per_layer"] if trace else cell["end_to_end"]):
        v = part("metrics", m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted),
              "failed": int(failed), "metrics": metrics, "device": dev}
    if trace:
        p = run.profile
        dev["busy_s"], dev["window_s"] = p.busy_s, p.window_s
        result["breakdown"] = {
            "device_ops": [[k[:160], v] for k, v in sorted(
                p.by_kernel.items(), key=lambda kv: -kv[1])[:10]],
            "idle_gaps": [[k[:160], v] for k, v in sorted(
                p.idle_by_host.items(), key=lambda kv: -kv[1])[:10]]}
    result["checks"] = checks
    return result
