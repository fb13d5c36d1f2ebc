"""Card-only: memory safety and run-to-run determinism of the port's
hand-written kernels (``tests/torch_kernel_safety.py``): every case of the
table through every check (guard bands around the outputs, three halo
fills around the inputs, inputs untouched, REPS repeat launches alone,
beside a busy stream, with the rows permuted and at each launch shape),
then chip_smoke [31]'s AGC sequence at 64 x 2^20 under its watch
``AGC_TRIES`` times in a row, failing on any parting with the window where
bytes changed.

Run on a card with ``python -m pytest --noconftest -m gpu -s
tests/test_torch_kernel_safety_gpu.py`` (nothing here imports JAX);
without a card every case skips.
"""

import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

import torch_kernel_safety as S
from orion_sdr_tpu_torch.ops import dd_pll, gardner, gnss_track, ldpc_bp, \
    onepole_two_rate, outer_fec, psk31_pll, psk31_viterbi, viterbi

pytestmark = pytest.mark.gpu

AGC_TRIES = 50
# chip_smoke [31]'s AGC check: rate, shape, the compared head, tolerance
AGC_FS, AGC_ROWS, AGC_LOG2_N, AGC_HEAD, AGC_TOL = 8000.0, 64, 20, 8192, 1e-5


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"\n{smi.stdout.strip()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    with ThreadPoolExecutor(9) as pool:       # one nvcc per source, together
        for f in [pool.submit(m.build) for m in (
                ldpc_bp, viterbi, outer_fec, psk31_pll, onepole_two_rate,
                dd_pll, gardner, gnss_track, psk31_viterbi)]:
            f.result()
    return torch.device("cuda")


@pytest.mark.parametrize("case", S.CASES, ids=[c.label for c in S.CASES])
def test_kernel_is_memory_safe_and_deterministic(cuda, case):
    r = S.run_case(case, cuda)
    print(f"  {case.label}: ok {r['ok']}, {r['launches']} launches, "
          f"{r['s']:.2f} s, determinism {r['determinism']}")
    assert r["ok"], r


def test_agc_sequence_never_parts(cuda):
    """[31]'s sequence at its shape, seeds and tolerance, AGC_TRIES times:
    every kept tensor byte-equal at every step, and agc_rms and cw_mod on
    the card within 1e-5 of the CPU path on rows 0-1's first 8192
    samples."""
    import orion_sdr_tpu_torch as P
    t0 = time.perf_counter()
    partings = []
    for k in range(AGC_TRIES):
        r = S.agc_sequence(P, cuda, AGC_FS, AGC_ROWS, AGC_LOG2_N, AGC_HEAD)
        w = r["watch"]
        if w.parted is not None or not max(r["err_agc"],
                                           r["err_cw"]) <= AGC_TOL:
            partings.append((k, r["err_agc"], r["err_cw"], w.report()))
            print(f"  [31] try {k}: agc {r['err_agc']:.3g}, cw "
                  f"{r['err_cw']:.3g}: {w.report()}")
        assert r["launches"] == 2
        del r
    print(f"  [31] {AGC_TRIES} tries in {time.perf_counter() - t0:.1f} s, "
          f"{len(partings)} parted")
    assert not partings, partings
