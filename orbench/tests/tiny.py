"""Small cells for the tests, added as data files to a copy of the
benchmark (the harness finds them by name, with no edit)."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

CELLS = {
    "cofdm_ldpc_bch.tiny": {
        "config": "cofdm_ldpc_bch", "generator": "cofdm_frames",
        "entry": "cofdm_decode_batch", "check": "cofdm_frames",
        "limits_of": "cofdm_ldpc_bch.rx_mixed_mcs",
        "params": {"frames": 8, "payload_bytes": 120, "mcs": [0, 1, 2, 3],
                   "noise_ratio": 0.02, "pool": 2}},
    "ft8_batch_rx.tiny": {
        "config": "ft8_batch_rx", "generator": "ft8_slots",
        "entry": "ft8_decode_windows", "check": "ft8_windows",
        "limits_of": "ft8_batch_rx.rx_256win",
        "params": {"windows": 4, "signals": 3, "window_samples": 180000,
                   "snr_db": -12.0, "carrier_hz": [200.0, 2900.0],
                   "pool": 2}},
}


def copy_with_tiny(dst: str, scale: int = 1) -> str:
    """A copy of BENCHMARK.json and orbench/ under ``dst`` with the tiny
    cells (``scale`` times their items) added as new files and entries."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "orbench"),
                    os.path.join(dst, "orbench"),
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for name, cell in CELLS.items():
        config, traffic = name.split(".")
        cell = dict(cell)
        with open(os.path.join(ROOT, "orbench", "cells",
                               f"{cell.pop('limits_of')}.json")) as f:
            limits = json.load(f)["limits"]
        params = dict(cell["params"])
        for k in ("frames", "windows", "signals"):
            if k in params:
                params[k] *= scale
        body = dict(cell, traffic=traffic, params=params, limits=limits,
                    chips=1, why="test cell")
        with open(os.path.join(dst, "orbench", "cells", f"{name}.json"),
                  "w") as f:
            json.dump(body, f)
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "test cell"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and any(w.startswith(config + ".")
                                        for w in m["workloads"]):
                m["workloads"].append(name)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst
