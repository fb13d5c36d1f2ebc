"""Card-only: the receive paths' spans and counters (``obs``) held to the
card's own trace. At 32 COFDM frames (the benchmark's main cell, cut to
one batch of 32) and 16 FT8 windows, each call under ``torch.profiler``
leaves one root; its BP launches are the trace's ``ldpc_bp`` kernels, its
``d2h.reads`` the trace's device-to-host copies inside the root's span;
and no ``orion.*`` range is counted as device work by the benchmark's
profile reducer (``orbench/profiling.py``), whose idle gaps the spans
name (a share printed: between calls no span is open). A batch of the
DVB-T cell deinterleaves all 32 frames on the card and reads under a
quarter of its Viterbi output.

Run on a card with ``python -m pytest --noconftest -m gpu -s
tests/test_torch_obs_gpu.py`` (nothing here imports JAX); without a card
every case skips.
"""

import subprocess

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orbench import harness, profiling
from orion_sdr_tpu_torch import obs

pytestmark = pytest.mark.gpu
CALLS = 3
SEED = 2 ** 31 + 77
# cell → (its parameters changed, the root, BP launches a call,
# device-to-host reads a call)
CELLS = {
    "cofdm_ldpc_bch.rx_mixed_mcs": (dict(frames=32, pool=1),
                                    "orion.frame.decode_batch", 5, 14),
    "ft8_batch_rx.rx_256win": (dict(windows=16, signals=14, pool=1),
                               "orion.ft8.decode_windows", 1, 2),
}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"\n{smi.stdout.strip()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    return "cuda"


@pytest.fixture(scope="module", params=sorted(CELLS))
def cell(request, cuda):
    """(name, call): one batch of the cell and the program's call on it,
    the card synchronised after; called once (the kernels built)."""
    name = request.param
    c = harness.load_cell(name)
    params = dict(c["params"], **CELLS[name][0])
    batch = harness.part("traffic", c["generator"]).make(
        c["config_file"], params, SEED, cuda)[0]
    entry = harness.part("entries", c["entry"]).Entry(c["config_file"],
                                                      params, cuda)

    def call():
        out = entry.call(batch.iq)
        torch.cuda.synchronize()
        return out
    call()
    return name, call


def test_spans_and_counters_match_the_card_trace(cell):
    name, call = cell
    _, root, bp, reads = CELLS[name]
    mark = obs.recorded()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            call()
    roots = obs.since(mark)
    assert [r.name for r in roots] == [root] * CALLS
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in events if "ldpc_bp" in e.name]
    launches = [r.launches.get("bp_decode_kernel.launches", 0)
                for r in roots]
    print(f"\n  {name}: BP launches {launches}, kernels {len(kernels)}")
    assert launches == [bp] * CALLS and len(kernels) == bp * CALLS
    t0 = prof.profiler.kineto_results.trace_start_ns()
    copies = [e for e in events if "DtoH" in e.name]
    for r in roots:
        a, b = (r.start_ns - t0) / 1e3, (r.end_ns - t0) / 1e3
        inside = [e.name for e in copies
                  if a <= e.time_range.start and e.time_range.end <= b]
        print(f"  d2h.reads {r.counters['d2h.reads']}, copies "
              f"{len(inside)}, {r.counters['d2h.bytes']} bytes")
        assert r.counters["d2h.reads"] == len(inside) == reads


def test_a_dvbt_batch_deinterleaves_on_the_card(cuda):
    """The DVB-T cell's batch of 32 frames: the Forney deinterleaver takes
    every row on the card, and the root reads under a quarter of the
    Viterbi output's bytes (a byte a bit, ``viterbi.steps``): the TPS cells
    and the RS messages and flags."""
    name = "dvbt_2k_64qam23.rx_32mux"
    c = harness.load_cell(name)
    params = dict(c["params"], pool=1)
    batch = harness.part("traffic", c["generator"]).make(
        c["config_file"], params, SEED, cuda)[0]
    entry = harness.part("entries", c["entry"]).Entry(c["config_file"],
                                                      params, cuda)
    entry.call(batch.iq)
    mark = obs.recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        entry.call(batch.iq)
    (r,) = obs.since(mark)
    print(f"\n  {name}: {r.counters}")
    assert r.counters["forney.rows_on_device"] == params["frames"]
    assert "forney.rows_host" not in r.counters
    assert r.counters["d2h.bytes"] < r.counters["viterbi.steps"] // 4


def test_no_span_is_device_work_and_the_spans_name_the_idle_time(cell):
    name, call = cell
    p = profiling.profile(lambda i: call(), CALLS, True)
    spans = [k for k in p.by_kernel if k.startswith("orion.")]
    assert spans == [] and any("ldpc_bp" in k for k in p.by_kernel)
    idle = sum(p.idle_by_host.values())
    named = sum(v for k, v in p.idle_by_host.items() if "orion." in k)
    top = sorted(p.idle_by_host.items(), key=lambda kv: -kv[1])[:4]
    print(f"\n  {name}: idle {idle:.4f} s, under program spans "
          f"{named:.4f} s; {top}")
    assert named > 0
