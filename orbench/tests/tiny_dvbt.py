"""A small DVB-T cell for the tests, added as a data file to a copy of the
benchmark beside the other tiny cells (the harness finds it by name, with
no edit): two full frames of the main cell's link, one pool batch."""

from __future__ import annotations

import json
import os

from tiny import ROOT, copy_with_tiny

CELL = "dvbt_2k_64qam23.tiny"
OF = "dvbt_2k_64qam23.rx_32mux"


def copy_with_tiny_dvbt(dst: str) -> str:
    """:func:`tiny.copy_with_tiny` and the tiny DVB-T cell."""
    copy_with_tiny(dst)
    with open(os.path.join(ROOT, "orbench", "cells", f"{OF}.json")) as f:
        cell = json.load(f)
    cell["params"] = dict(cell["params"], frames=2, pool=1)
    cell["why"] = "test cell"
    with open(os.path.join(dst, "orbench", "cells", f"{CELL}.json"),
              "w") as f:
        json.dump(cell, f)
    with open(os.path.join(dst, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": CELL, "config": cell["config"],
                               "traffic": "tiny", "chips": 1,
                               "why": "test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if OF in m.get("workloads", []):
            m["workloads"].append(CELL)
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return dst
