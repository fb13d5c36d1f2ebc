"""Readings that a cell's limits are set from, at the cell's own size:

    python3 -m orbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed, the program decodes every pool batch once (the window's
entry and hooks) and the plain reference decodes it at the configuration's
precision and in the control's (the precision below it); prints one JSON
line a seed with each compared number for the program and for the control
put in the program's place (and, where the check counts it, the
reference's own work a pool batch), then the largest program reading and
the smallest control reading of each number. Needs a CUDA card."""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import harness


def readings(name: str, seed: int, device: str = "cuda",
             root: str = harness.ROOT, faults=()) -> dict:
    st = harness.prepare(name, seed, device, root, faults)
    cfg, params = st.cell["config_file"], st.cell["params"]
    check, pool = st.check, st.pool
    try:
        finals = [(s, st.entry.final(st.call(s))) for s in range(len(pool))]
    finally:
        st.hooks.close()
    obs = {s: st.entry.observe(st.records.slots[s]) for s in range(len(pool))}
    refs = {s: check.reference(cfg, params, pool[s], device)
            for s in range(len(pool))}
    ctrl = {s: check.reference(cfg, params, pool[s], device, control=True)
            for s in range(len(pool))}
    return {"seed": seed,
            "program": check.compare(cfg, params, obs, refs, finals),
            "control": check.compare(
                cfg, params, ctrl, refs,
                [(s, check.finals_of(ctrl[s])) for s in ctrl]),
            "failed": sum(check.failed(pool[s].truth, f) for s, f in finals),
            "ref_failed": sum(check.failed(pool[s].truth,
                                           check.finals_of(refs[s]))
                              for s in refs),
            "ref_work": [check.counters(refs[s]) for s in refs]
            if hasattr(check, "counters") else None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="orbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("orbench.control: no CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in a.seeds:
        rows.append(readings(a.workload, seed))
        print(json.dumps(rows[-1]), flush=True)
    keys = rows[0]["program"]
    print(json.dumps({
        "workload": a.workload, "seeds": len(rows),
        "program_max": {k: max(r["program"][k] for r in rows) for k in keys},
        "control_min": {k: min(r["control"][k] for r in rows) for k in keys},
        "control_max": {k: max(r["control"][k] for r in rows) for k in keys}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
