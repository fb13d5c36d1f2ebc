"""Two-process ``torch.distributed`` smoke run of the torch port's
cross-process layer: two processes join one gloo group
(``orion_sdr_tpu_torch.parallel.init_distributed``), build the host-major
process mesh, and reduce a link metric across both (``ber_sharded``: each
process counts the errors of its own rows on its own device, the counts
are all-reduced). Imports nothing of the JAX package.

Launcher (spawns both workers, checks the reduced metric):
    python tools/torch_distributed_smoke.py [--device cpu|cuda]
        [--rendezvous DIR]
The workers meet through a file under ``DIR`` (default: a fresh temporary
directory), so two runs never share a port.
Worker (internal):
    python tools/torch_distributed_smoke.py --worker RANK NPROC INIT DEVICE
"""
import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_PER_PROC = 512                    # bits in each process's rows
FLIPS = {0: 3, 1: 5}                # errors put into each process's rows


def worker(rank: int, nproc: int, init: str, device: str) -> None:
    import numpy as np
    import torch
    from orion_sdr_tpu_torch.parallel import (
        ber_sharded, init_distributed, make_process_mesh)

    torch.set_num_threads(1)
    assert init_distributed(init, nproc, rank), \
        "init_distributed must start the group"
    mesh = make_process_mesh(shape=(nproc, 1), devices=[device])
    assert (mesh.process_index, mesh.process_count) == (rank, nproc)
    # the same global rows in every process; each process owns its
    # host-major slice of the leading axis
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 2, (nproc, N_PER_PROC)).astype(np.uint8)
    hat = ref.copy()
    for p, k in FLIPS.items():
        if p < nproc:
            hat[p, :k] ^= 1
    ber, errs, n = ber_sharded(ref, hat, mesh)
    expect = sum(k for p, k in FLIPS.items() if p < nproc)
    assert n == nproc * N_PER_PROC, (n, nproc * N_PER_PROC)
    assert errs == expect, (errs, expect)
    torch.distributed.destroy_process_group()
    print(f"proc {rank} on {device}: all-reduced ber={ber:.6f} "
          f"errs={errs}/{n} OK", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--rendezvous", default=None,
                    help="directory for the rendezvous file")
    ap.add_argument("--timeout", type=float, default=120.0)
    a = ap.parse_args(argv)
    nproc = 2
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(a.rendezvous or tmp, "rendezvous")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(i),
             str(nproc), init, a.device],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for i in range(nproc)]
        outs, rc = [], 0
        for p in procs:
            try:
                out, _ = p.communicate(timeout=a.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                rc = 1
            outs.append(out)
            rc = rc or p.returncode
    for i, out in enumerate(outs):
        print(f"--- worker {i} ---\n{out}", flush=True)
    if rc == 0 and all("OK" in o for o in outs):
        print("torch distributed smoke: PASS", flush=True)
        return 0
    print("torch distributed smoke: FAIL", flush=True)
    return 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
    else:
        sys.exit(main())
