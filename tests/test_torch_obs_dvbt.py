"""Torch port: the DVB-T batch receive's spans and counters (``obs``), on
the CPU. Under a profiler one ``DvbTFrameDemod.decode_batch`` leaves one
root ``orion.dvbt.decode_batch`` with the receive, TPS and TS spans and
the chain's spans, and counters at the values the batch's plan gives;
a frame whose TPS fails is counted before the batch raises; with the
profiler off nothing is recorded and no ``orion.*`` range is opened.

One case needs a CUDA card (marked ``gpu``; it skips without one): at the
benchmark cell's plan, the chain decodes from a card tensor as on the host
and reads no Viterbi output. Run it on a card with ``python -m pytest
--noconftest -m gpu tests/test_torch_obs_dvbt.py`` (nothing here imports
JAX)."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import obs
from orion_sdr_tpu_torch.demodulate.dvb_t_frame import _ts_plan
from orion_sdr_tpu_torch.frame.chain import (block_plan, decode_chain_batch,
                                             deinterleave_bits)
from orion_sdr_tpu_torch.frame.types import (SCRAMBLER_BEFORE_OUTER,
                                             InterleaverKind, ScramblerKind)
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
    # the Forney deinterleaver gathers the Viterbi output where it lies:
    # the reads are the TPS cells and the deinterleaved bits for the host
    # RS decoder (the batch's few codewords stay off the card), no read of
    # the Viterbi output
    assert r.counters["forney.rows_on_device"] == 3
    assert r.counters.get("forney.rows_host", 0) == 0
    assert r.counters["d2h.reads"] == 2
    assert r.counters["d2h.bytes"] < 3 * plan.outer_il_bits
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_the_cells_plan_decodes_on_the_card_as_on_the_host(cuda):
    """The benchmark cell's plan (64-QAM r2/3: 240 TS packets a frame), 3
    frames with 2 % of their LLRs flipped and a row of noise: from a card
    tensor the chain gives the host path's bytes and flags on the same LLRs,
    deinterleaves every row on the card and reads only the RS messages and
    flags; the card's Forney gather equals the host stream bit for bit."""
    inner = P.InnerFec.convolutional("2/3", "dvb_k7")
    plan = _ts_plan(240, inner)
    il = dvb_t_frame_outer_il()
    args = ("none", dvb_t_frame_outer(), inner, il, InterleaverKind.none(),
            ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER)
    rng = np.random.default_rng(27)
    datas = [rng.integers(0, 256, plan.info_bytes).astype(np.uint8)
             for _ in range(3)]
    coded = np.stack([P.encode_chain(d, *args, 0, device="cpu").numpy()
                      for d in datas])
    llr = np.where(coded == 0, 3.0, -3.0).astype(np.float32)
    llr[rng.random(llr.shape) < 0.02] *= -1
    llr = np.concatenate([llr, rng.standard_normal(
        (1, plan.coded_bits)).astype(np.float32)])
    want, want_ok = decode_chain_batch(llr, plan, *args, [0] * 4,
                                       device="cpu")
    mark = obs.recorded()
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.root("orion.test.decode_chain_batch"):
            got, ok = decode_chain_batch(torch.as_tensor(llr, device=cuda),
                                         plan, *args, [0] * 4)
    (r,) = obs.since(mark)
    assert list(ok) == list(want_ok) == [True, True, True, False]
    for g, w, d in zip(got, want, datas + [None]):
        assert np.array_equal(g, w)
        assert d is None or np.array_equal(g, d)
    assert r.counters["forney.rows_on_device"] == 4
    assert "forney.rows_host" not in r.counters
    assert r.counters["rs.words"] == 4 * 240
    assert r.counters["d2h.reads"] == 2                  # messages, flags
    assert r.counters["d2h.bytes"] < 4 * plan.outer_coded_bits // 8
    bits = rng.integers(0, 2, (4, plan.outer_il_bits)).astype(np.uint8)
    on_card = deinterleave_bits(il, torch.as_tensor(bits, device=cuda))
    assert on_card.device.type == "cuda"
    assert np.array_equal(on_card.cpu().numpy(), deinterleave_bits(il, bits))
