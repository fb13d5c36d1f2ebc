"""Run one benchmark cell once on the card this process finds:

    python3 -m orbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

prints the compared numbers beside their limits as the last lines of
standard error, and the result as one JSON object, the last line of
standard output. Exits non-zero, printing no result, without a CUDA card
(or with fewer than the cell asks for), when jax, jaxlib, flax or the JAX
package are loaded once the window has closed, or when the program is not
in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    t0 = time.perf_counter()
    ap = argparse.ArgumentParser(prog="orbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    # build and kernel caches at fixed paths inside the checkout
    cache = os.path.join(here, ".cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    # one host thread for torch and the CPU libraries: the load of a run
    # is one process's thread, on a host that other machines share
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    import torch
    torch.set_num_threads(1)
    from . import harness
    cell = harness.load_cell(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"orbench: {a.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import orion_sdr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"orbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(a.workload, a.seed, a.seconds,
                                  bool(a.trace), t_start=t0)
    except SystemExit as e:
        print(f"orbench: {e}", file=sys.stderr)
        return 3
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']:.6g} (limit {v['limit']:g})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
