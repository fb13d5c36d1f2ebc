"""Torch port: the DVB-T batch receive's spans and counters (``obs``), on
the CPU. Under a profiler one ``DvbTFrameDemod.decode_batch`` leaves one
root ``orion.dvbt.decode_batch`` with the receive, TPS and TS spans and
the chain's spans, and counters at the values the batch's plan gives;
a frame whose TPS fails is counted before the batch raises; with the
profiler off nothing is recorded and no ``orion.*`` range is opened."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import obs
from orion_sdr_tpu_torch.frame.chain import block_plan
from orion_sdr_tpu_torch.frame.types import InterleaverKind
from orion_sdr_tpu_torch.waveform.dvb_t import (dvb_t_frame_outer,
                                                dvb_t_frame_outer_il)

torch.set_num_threads(1)
CPU = "cpu"
N_TS = 3
PAYLOAD = N_TS * 187
LINK = P.DvbTLinkParams("1/8", "qpsk", "1/2")
SPANS = {"orion.dvbt.receive", "orion.dvbt.tps", "orion.dvbt.ts",
         "orion.chain.deinterleave", "orion.chain.inner", "orion.chain.outer",
         "orion.chain.crc", "orion.d2h"}


@pytest.fixture(scope="module")
def batch():
    """Three frames (frame numbers 0-2, their own cell ids) at 20 dB."""
    rng = np.random.default_rng(0xDB7)
    rows = []
    for fn in range(3):
        params = P.DvbTFrameParams(LINK, fn, 40 + fn)
        iq = P.DvbTFrameMod(params, device=CPU).modulate(
            rng.integers(0, 256, PAYLOAD).astype(np.uint8)).iq
        sigma = np.sqrt(np.mean(np.abs(iq) ** 2) * 0.01 / 2)
        rows.append(iq + sigma * (rng.standard_normal(len(iq)) + 1j
                                  * rng.standard_normal(len(iq))))
    return torch.as_tensor(np.stack(rows).astype(np.complex64))


def _demod():
    return P.DvbTFrameDemod(P.DvbTFrameParams(LINK), device=CPU)


def _profiled(fn):
    mark = obs.recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        fn()
    return obs.since(mark)


def test_a_batch_leaves_one_root_with_its_spans_and_counts(batch):
    got = _profiled(lambda: _demod().decode_batch(batch, 68, PAYLOAD))
    (r,) = got
    assert r.name == "orion.dvbt.decode_batch"
    assert set(r.spans) == SPANS
    assert {"orion.dvbt.receive", "orion.dvbt.tps", "orion.dvbt.ts",
            "orion.chain.inner"} <= set(r.children)
    assert r.spans["orion.dvbt.ts"][1] == 2     # un-disperse, depacketize
    plan = block_plan(N_TS * 188, "none", dvb_t_frame_outer(),
                      P.InnerFec.convolutional("1/2", "dvb_k7"),
                      dvb_t_frame_outer_il(), InterleaverKind.none())
    assert r.counters["dvbt.frames"] == 3
    assert r.counters["dvbt.tps_fail"] == 0
    assert r.counters["dvbt.ts_packets"] == 3 * N_TS
    assert r.counters["viterbi.steps"] == 3 * plan.outer_il_bits
    assert r.counters["rs.words"] == 3 * N_TS
    assert r.counters["rs.words_failed"] == 0
    # the TPS cells, and the Viterbi output for the Forney deinterleaver
    assert r.counters["d2h.reads"] == 2
    assert r.launches == {}                     # the plain paths: no kernel
    assert 0 < r.ms("orion.dvbt.tps") < r.duration_ns / 1e6


def test_a_failed_tps_word_is_counted_before_the_batch_raises(batch):
    bad = batch.clone()
    bad[1] = torch.randn(bad.shape[1], dtype=torch.complex64,
                         generator=torch.Generator().manual_seed(3))

    def run():
        with pytest.raises(P.DvbTRxError):
            _demod().decode_batch(bad, 68, PAYLOAD)
    (r,) = _profiled(run)
    assert r.counters["dvbt.tps_fail"] == 1
    assert "orion.chain.inner" not in r.spans


def test_nothing_is_recorded_without_a_profiler(batch, monkeypatch):
    opened = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    mark = obs.recorded()
    out = _demod().decode_batch(batch, 68, PAYLOAD)
    assert len(out) == 3 and [f.tps.cell_id for f in out] == [40, 41, 42]
    assert obs.recorded() == mark and not obs.recording()
    assert [n for n in opened if n.startswith("orion.")] == []
