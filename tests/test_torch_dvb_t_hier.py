"""Torch port: hierarchical DVB-T and blind decode against the JAX package.

The setups are those of ``tests/test_dvb_t_hier.py``. Hierarchical IQ from
both modulators must agree within 1e-5 × RMS (FFT rounding differs between
the libraries); HP and LP payloads, TPS words and every ``DvbTBlindFrame``
field must be equal; frames modulated by either package decode in the
other. JAX shapes are few and shared through module-scoped fixtures."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.demodulate.dvb_t_frame import (
    DvbTHierFrameDemod as JHierDemod, dvb_t_blind_decode as jax_blind,
    _receive_frame as jax_receive_frame)
from orion_sdr_tpu.modulate.dvb_t_frame import (DvbTFrameMod as JMod,
                                                DvbTHierFrameMod as JHierMod)
from orion_sdr_tpu.waveform import dvb_t as JD

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.demodulate import dvb_t_frame as PDF
from orion_sdr_tpu_torch.ops import viterbi as pviterbi

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

# name: (link fields, frame number, cell id, HP bytes, LP bytes, seeds)
HIER = {
    "qam16_a2": (("1/8", "qam16", 2, "1/2", "3/4"), 1, 0x42, 400, 1200,
                 (0, 1)),
    "qam64_a1": (("1/32", "qam64", 1, "2/3", "2/3"), 0, 0, 300, 900, (2, 3)),
}


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


def _awgn(iq, snr_db, seed):
    # tests/test_dvb_t_hier.py::_awgn
    rng = np.random.default_rng(seed)
    sig_p = float(np.mean(np.abs(iq) ** 2))
    sigma = np.sqrt(sig_p / 10 ** (snr_db / 10) / 2)
    return iq + ((rng.standard_normal(len(iq))
                  + 1j * rng.standard_normal(len(iq)))
                 .astype(np.complex64) * sigma)


def _hier_params(fields, frame_no=0, cell=0):
    return (JD.DvbTHierFrameParams(JD.DvbTHierLinkParams(*fields), frame_no,
                                   cell),
            P.DvbTHierFrameParams(P.DvbTHierLinkParams(*fields), frame_no,
                                  cell))


def _same_tps(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.fixture(scope="module", params=sorted(HIER))
def hier(request):
    """Both packages' frames of one hierarchical link."""
    fields, frame_no, cell, n_hp, n_lp, seeds = HIER[request.param]
    jp, pp = _hier_params(fields, frame_no, cell)
    hp, lp = _payload(n_hp, seeds[0]), _payload(n_lp, seeds[1])
    return dict(name=request.param, jp=jp, pp=pp, hp=hp, lp=lp,
                jf=JHierMod(jp).modulate(hp, lp),
                pf=P.DvbTHierFrameMod(pp, device="cpu").modulate(hp, lp))


def test_hier_params_and_tps_match():
    fields = ("1/4", "qam64", 4, "1/2", "7/8")
    jp, pp = _hier_params(fields, 3, 0xAB)
    assert dataclasses.asdict(pp) == dataclasses.asdict(jp)
    assert _same_tps(pp.tps_word(), jp.tps_word())
    assert pp.inner_hp() == P.InnerFec.convolutional("1/2", "dvb_k7")
    assert pp.inner_lp() == P.InnerFec.convolutional("7/8", "dvb_k7")
    for bad in (("1/8", "qpsk", 2, "1/2", "1/2"),
                ("1/8", "qam16", 3, "1/2", "1/2")):
        with pytest.raises(ValueError):
            P.DvbTHierLinkParams(*bad).validate()
        with pytest.raises(ValueError):
            P.DvbTHierFrameMod(P.DvbTHierFrameParams(
                P.DvbTHierLinkParams(*bad)), device="cpu").modulate(b"x", b"y")


def test_hier_iq_matches(hier):
    jf, pf = hier["jf"], hier["pf"]
    assert (pf.n_symbols, pf.samples_per_symbol) == (jf.n_symbols,
                                                     jf.samples_per_symbol)
    assert pf.n_symbols == 68 and pf.iq.dtype == np.complex64
    rms = float(np.sqrt(np.mean(np.abs(jf.iq) ** 2)))
    assert float(np.abs(pf.iq - jf.iq).max()) <= 1e-5 * rms


def test_hier_frames_cross_between_the_packages(hier):
    # tests/test_dvb_t_hier.py:119 (unknown offset) and :135 (64-QAM α=1)
    jp, pp, hp, lp = hier["jp"], hier["pp"], hier["hp"], hier["lp"]
    lead = 913 if hier["name"] == "qam16_a2" else 0

    def cap(frame):
        return np.concatenate([np.zeros(lead, np.complex64), frame.iq,
                               np.zeros(500, np.complex64)])
    n_sym = hier["pf"].n_symbols
    jrx = JHierDemod(jp).decode(cap(hier["pf"]), n_sym, len(hp), len(lp))
    prx = P.DvbTHierFrameDemod(pp, device="cpu").decode(
        cap(hier["jf"]), n_sym, len(hp), len(lp))
    for rx in (jrx, prx):
        assert np.array_equal(rx.hp_payload, hp)
        assert rx.lp_payload is not None
        assert np.array_equal(rx.lp_payload, lp)
    assert _same_tps(prx.tps, jrx.tps)
    assert prx.tps == pp.tps_word()


def test_hier_llr_demux_matches_jax():
    # the HP plane is each cell's first two LLRs, LP the other v−2
    jp, pp = _hier_params(HIER["qam16_a2"][0])
    frame = P.DvbTHierFrameMod(pp, device="cpu").modulate(_payload(200, 5),
                                                          _payload(500, 6))
    seg = _awgn(frame.iq, 15.0, 7)
    jl, _ = jax_receive_frame(seg, 68, 256, 0, 4, 2)
    pl, _ = PDF.receive_frame_body(torch.as_tensor(seg), 68, 256, 0, 4, 2)
    jl = np.asarray(jl).reshape(-1, 4)
    tol = 1e-4 * float(np.abs(jl).max())
    per_cell = pl.reshape(-1, 4)
    for ours, ref in ((per_cell[:, :2], jl[:, :2]),
                      (per_cell[:, 2:], jl[:, 2:])):
        ours = ours.reshape(-1)
        assert ours.shape == (68 * 1512 * 2,)
        assert float(np.abs(ours.numpy() - ref.reshape(-1)).max()) <= tol


def test_hier_graceful_degradation_matches_jax():
    # tests/test_dvb_t_hier.py:148: 64-QAM α=4, HP r1/2, LP r2/3; at 24 dB
    # both streams decode, at 9 dB HP decodes and LP is None
    jp, pp = _hier_params(("1/32", "qam64", 4, "1/2", "2/3"))
    hp, lp = _payload(400, 4), _payload(800, 5)
    frame = JHierMod(jp).modulate(hp, lp)
    for snr, lp_ok in ((24.0, True), (9.0, False)):
        cap = _awgn(frame.iq, snr, 42)
        jrx = JHierDemod(jp).decode(cap, frame.n_symbols, len(hp), len(lp))
        before = pviterbi.viterbi_chunks_kernel.launches
        prx = P.DvbTHierFrameDemod(pp, device="cpu").decode(
            cap, frame.n_symbols, len(hp), len(lp))
        assert pviterbi.viterbi_chunks_kernel.launches == before   # CPU
        for rx in (jrx, prx):
            assert np.array_equal(rx.hp_payload, hp)
            assert (rx.lp_payload is not None) == lp_ok
        if lp_ok:
            assert np.array_equal(prx.lp_payload, lp)
            assert np.array_equal(jrx.lp_payload, lp)
        assert _same_tps(prx.tps, jrx.tps)


def test_hier_decode_with_radix4_forced(monkeypatch):
    # FORCE_RADIX4 sends both chunked decodes (span 1216 = 4·304) through
    # radix 4; on the CPU its plain version
    _, pp = _hier_params(HIER["qam16_a2"][0], 1, 0x42)
    hp, lp = _payload(400, 0), _payload(1200, 1)
    frame = P.DvbTHierFrameMod(pp, device="cpu").modulate(hp, lp)
    monkeypatch.setattr(pviterbi, "FORCE_RADIX4", True)
    rx = P.DvbTHierFrameDemod(pp, device="cpu").decode(
        _awgn(frame.iq, 20.0, 3), frame.n_symbols, len(hp), len(lp))
    assert np.array_equal(rx.hp_payload, hp)
    assert np.array_equal(rx.lp_payload, lp)


def test_hier_rx_errors():
    _, pp = _hier_params(HIER["qam16_a2"][0])
    demod = P.DvbTHierFrameDemod(pp, device="cpu")
    with pytest.raises(P.DvbTRxError) as e:
        demod.decode(np.zeros(3000, np.complex64), 68, 100, 100)
    assert e.value.kind == P.DvbTRxError.ACQUISITION
    noise = _awgn(np.ones(200_000, np.complex64), -5.0, 1)
    with pytest.raises(P.DvbTRxError):
        demod.decode(noise, 68, 100, 100)


# ── blind decode ─────────────────────────────────────────────────────────────


def _same_blind(a, b):
    assert a.guard == b.guard and a.n_symbols == b.n_symbols
    assert _same_tps(a.tps, b.tps)
    assert np.array_equal(a.payload, b.payload)
    assert (a.lp_payload is None) == (b.lp_payload is None)
    if a.lp_payload is not None:
        assert np.array_equal(a.lp_payload, b.lp_payload)


@pytest.mark.parametrize("guard,order,rate", [("1/8", "qpsk", "2/3"),
                                              ("1/32", "qam16", "3/4")])
def test_blind_decode_no_prior_parameters(guard, order, rate):
    # tests/test_dvb_t_hier.py:207, the plain frames
    payload = _payload(500, 20)
    params = JD.DvbTFrameParams(JD.DvbTLinkParams(guard, order, rate), 1, 7)
    frame = JMod(params).modulate(payload)
    buf = np.concatenate([np.zeros(1234, np.complex64), frame.iq])
    out = P.dvb_t_blind_decode(buf, device="cpu")
    assert isinstance(out, P.DvbTBlindFrame)
    assert out.guard == guard and out.n_symbols == 68
    assert out.tps.constellation == order and out.tps.code_rate_hp == rate
    assert out.tps.cell_id == 7 and out.lp_payload is None
    assert np.array_equal(out.payload[:len(payload)], payload)
    # the padding of the last real packet is zeros; null packets are gone
    assert len(out.payload) % 187 == 0 and not out.payload[500:].any()


def test_blind_decode_hierarchical_matches_jax():
    # tests/test_dvb_t_hier.py:226: every DvbTBlindFrame field equal
    jp, pp = _hier_params(("1/16", "qam16", 2, "1/2", "3/4"))
    hp, lp = _payload(300, 21), _payload(900, 22)
    frame = P.DvbTHierFrameMod(pp, device="cpu").modulate(hp, lp)
    out = P.dvb_t_blind_decode(frame.iq, device="cpu")
    ref = jax_blind(frame.iq)
    _same_blind(out, ref)
    assert out.tps.hierarchy == 2 and out.guard == "1/16"
    assert np.array_equal(out.payload[:len(hp)], hp)
    assert np.array_equal(out.lp_payload[:len(lp)], lp)


def test_blind_decode_multi_frame_capture_awgn():
    # tests/test_dvb_t_hier.py:237: two frames at 6 dB; the descending
    # capacity retry decodes the first one
    payload = _payload(500, 23)
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 2, 3)
    frame = P.DvbTFrameMod(params, device="cpu").modulate(payload)
    sig_p = float(np.mean(np.abs(frame.iq) ** 2))
    rng = np.random.default_rng(0)
    buf = np.concatenate([np.zeros(3000, np.complex64), frame.iq, frame.iq])
    buf = buf + ((rng.standard_normal(len(buf))
                  + 1j * rng.standard_normal(len(buf))
                  ).astype(np.complex64) * np.sqrt(sig_p / 10 ** 0.6 / 2))
    out = P.dvb_t_blind_decode(buf, device="cpu")
    assert out.guard == "1/8" and out.n_symbols == 68
    assert out.tps == params.tps_word()
    assert np.array_equal(out.payload[:len(payload)], payload)


def test_blind_decode_errors():
    with pytest.raises(P.DvbTRxError) as e:
        P.dvb_t_blind_decode(np.zeros(5000, np.complex64), device="cpu")
    assert e.value.kind == P.DvbTRxError.ACQUISITION
