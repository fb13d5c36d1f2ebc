"""The plain reference alone on a cell's traffic with one parameter swept,
to see where the work of a layer starts to grow:

    python3 -m orbench.sweep --workload <cell> --param snr_db \
        --values 7 5 4 --seeds <n> [<n> ...]

For each value and seed, the pool is made with the parameter set to the
value and the reference decodes every pool batch; prints one JSON line
with the check's counters of the reference's work a pool batch and the
items it did not bring back as sent. The program is not run."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orbench.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--param", required=True)
    ap.add_argument("--values", type=float, nargs="+", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.device == "cuda" and not torch.cuda.is_available():
        print("orbench.sweep: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(a.workload)
    cfg = cell["config_file"]
    gen = harness.part("traffic", cell["generator"])
    check = harness.part("checks", cell["check"])
    for v in a.values:
        params = dict(cell["params"], **{a.param: v})
        for seed in a.seeds:
            pool = gen.make(cfg, params, seed, a.device)
            refs = [check.reference(cfg, params, b, a.device) for b in pool]
            print(json.dumps({
                a.param: v, "seed": seed,
                "work": [check.counters(r) for r in refs],
                "failed": [check.failed(b.truth, check.finals_of(r))
                           for b, r in zip(pool, refs)],
                "items": [len(b.truth) for b in pool]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
