"""Torch port: the conformant DVB-T 2K frame link against the JAX package.
Coded bits, sync sample, TPS words and payloads must be equal; IQ within
1e-5 × RMS and LLRs within 1e-4 × max|LLR| (FFT rounding differs between
the libraries). Frames modulated by either package decode in the other, and
the JAX capstones (unknown offset at 4 dB, integer CFO) decode in the port.
JAX shapes are few and shared through module-scoped fixtures."""

import dataclasses
import importlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu.frame as JC
from orion_sdr_tpu.demodulate.dvb_t_frame import (
    DvbTFrameDemod as JDemod, _receive_frame as jax_receive_frame)
from orion_sdr_tpu.dsp.osc import rotate as jax_rotate
from orion_sdr_tpu.modulate import dvb_t_frame as JMF
from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod as JMod
from orion_sdr_tpu.ofdm import channel_estimate_pilots as jax_estimate
from orion_sdr_tpu.waveform import dvb_t as JD
from orion_sdr_tpu.waveform import dvb_t_tps as JT
from orion_sdr_tpu.waveform import dvb_t_ts as JS

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert
import orion_sdr_tpu_torch.frame as PC
from orion_sdr_tpu_torch.demodulate import dvb_t_frame as PDF
from orion_sdr_tpu_torch.modulate import dvb_t_frame as PMF
from orion_sdr_tpu_torch.ofdm import channel_estimate_pilots
from orion_sdr_tpu_torch.ops import viterbi as pviterbi
from orion_sdr_tpu_torch.waveform import dvb_t as PD
from orion_sdr_tpu_torch.waveform import dvb_t_tps as PT
from orion_sdr_tpu_torch.waveform import dvb_t_ts as PS

# The plain torch versions run thousands of tiny ops; with one test worker
# per core, a torch thread pool as wide as the machine in every worker
# oversubscribes the CPU many times over.
torch.set_num_threads(1)

# the sync packages export a function of the module's name
JG = importlib.import_module("orion_sdr_tpu.sync.dvb_t_gi_sync")
PG = importlib.import_module("orion_sdr_tpu_torch.sync.dvb_t_gi_sync")

FULL_PAYLOAD = 51 * 187         # 9 537 bytes: a full QPSK r1/2 GI 1/8 frame
LINKS = {
    "qpsk": (("1/8", "qpsk", "1/2"), 1, 0x5A, FULL_PAYLOAD, 6.0),
    "qam16": (("1/8", "qam16", "3/4"), 0, 7, 3000, 15.0),
}


def _payload(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


def _params(name):
    link, frame_no, cell, _, _ = LINKS[name]
    return (JD.DvbTFrameParams(JD.DvbTLinkParams(*link), frame_no, cell),
            P.DvbTFrameParams(P.DvbTLinkParams(*link), frame_no, cell))


def _noise(rng, n, sig_p, snr_db):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            .astype(np.complex64) * np.sqrt(sig_p / 10 ** (snr_db / 10) / 2))


def _same_tps(a, b):
    return dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.fixture(scope="module", params=sorted(LINKS))
def link(request):
    """JAX and port frames of one link, a noisy capture of the JAX frame,
    and each package's decode of it."""
    name = request.param
    jp, pp = _params(name)
    payload = _payload(LINKS[name][3], 20 + len(name))
    jf = JMod(jp).modulate(payload)
    pf = P.DvbTFrameMod(pp, device="cpu").modulate(payload)
    sig_p = float(np.mean(np.abs(jf.iq) ** 2))
    rng = np.random.default_rng(30 + len(name))
    cap = np.concatenate([np.zeros(300, np.complex64), jf.iq,
                          np.zeros(500, np.complex64)])
    cap = cap + _noise(rng, len(cap), sig_p, LINKS[name][4])
    jrx = JDemod(jp).decode(cap, jf.n_symbols, len(payload))
    prx = P.DvbTFrameDemod(pp, device="cpu").decode(cap, pf.n_symbols,
                                                    len(payload))
    return dict(name=name, jp=jp, pp=pp, payload=payload, jf=jf, pf=pf,
                cap=cap, jrx=jrx, prx=prx, sig_p=sig_p)


def test_coded_bits_equal(link):
    # the modulators' TS stream (stuffed, dispersed) through both chains
    pp = link["pp"]
    n_sym = link["pf"].n_symbols
    vbits = {"qpsk": 2, "qam16": 4}[link["name"]]
    capacity = n_sym * 1512 * vbits
    ts = PS.ts_packetize(link["payload"])
    target = len(ts) // 188
    while PMF._coded_bits_for_packets(target, pp) < capacity:
        target += 1
    ts = PS.ts_energy_disperse(PS.ts_stuff_null_packets(ts, target))
    jts = JS.ts_energy_disperse(JS.ts_stuff_null_packets(
        JS.ts_packetize(link["payload"]), target))
    assert np.array_equal(ts, jts)
    ours = PC.encode_chain(ts, "none", PD.dvb_t_frame_outer(), pp.inner(),
                           PD.dvb_t_frame_outer_il(), PC.InterleaverKind.none(),
                           PC.ScramblerKind.none(), PC.SCRAMBLER_BEFORE_OUTER,
                           0, device="cpu")
    ref = JC.encode_chain(jts, "none", JD.dvb_t_frame_outer(),
                          link["jp"].inner(), JD.dvb_t_frame_outer_il(),
                          JC.InterleaverKind.none(), JC.ScramblerKind.none(),
                          JC.SCRAMBLER_BEFORE_OUTER, 0)
    assert len(ref) >= capacity
    assert np.array_equal(ours.numpy(), ref)


def test_iq_matches(link):
    jf, pf = link["jf"], link["pf"]
    assert (pf.n_symbols, pf.samples_per_symbol) == (jf.n_symbols,
                                                     jf.samples_per_symbol)
    assert pf.n_symbols == 68 and pf.iq.dtype == np.complex64
    rms = float(np.sqrt(np.mean(np.abs(jf.iq) ** 2)))
    assert pf.iq.shape == jf.iq.shape
    assert float(np.abs(pf.iq - jf.iq).max()) <= 1e-5 * rms


def test_noisy_capture_sync_llrs_tps_and_payload(link):
    jp, cap = link["jp"], link["cap"]
    n_sym, cp = link["jf"].n_symbols, 256
    sps = 2048 + cp
    fs = PD.dvb_t_fs_for_bandwidth(1e6)
    jacq = JG.dvb_t_gi_sync(cap, 2048, cp, fs, sps)
    pacq = PG.dvb_t_gi_sync(torch.as_tensor(cap), 2048, cp, fs, sps)
    assert pacq.start_sample == jacq.start_sample == 300
    assert abs(pacq.cfo_hz - jacq.cfo_hz) < 1e-3 * fs / 2048
    seg = cap[300:300 + n_sym * sps]
    vbits = {"qpsk": 2, "qam16": 4}[link["name"]]
    jl, jcells = jax_receive_frame(seg, n_sym, cp, 0, vbits)
    pl, pcells = PDF.receive_frame_body(torch.as_tensor(seg), n_sym, cp, 0,
                                        vbits)
    jl = np.asarray(jl)
    assert pl.shape == jl.shape == (n_sym, 1512 * vbits)
    assert float(np.abs(pl.numpy() - jl).max()) <= \
        1e-4 * float(np.abs(jl).max())
    np.testing.assert_allclose(pcells.numpy(), np.asarray(jcells), rtol=0,
                               atol=1e-4 * float(np.abs(jcells).max()))
    jrx, prx = link["jrx"], link["prx"]
    assert _same_tps(prx.tps, jrx.tps)
    assert prx.tps.cell_id == LINKS[link["name"]][2]
    assert np.array_equal(jrx.payload, link["payload"])
    assert np.array_equal(prx.payload, jrx.payload)


def test_port_frame_decodes_in_jax(link):
    pf = link["pf"]
    rx = JDemod(link["jp"]).decode(pf.iq, pf.n_symbols, len(link["payload"]))
    assert np.array_equal(rx.payload, link["payload"])


def test_decode_batch_matches_jax():
    jp, pp = _params("qpsk")
    payload = _payload(2000, 3)
    jf = JMod(jp).modulate(payload)
    rng = np.random.default_rng(4)
    sig_p = float(np.mean(np.abs(jf.iq) ** 2))
    batch = np.stack([jf.iq + _noise(rng, len(jf.iq), sig_p, 8.0)
                      for _ in range(3)])
    ref = JDemod(jp).decode_batch(batch, jf.n_symbols, len(payload))
    before = pviterbi.viterbi_chunks_kernel.launches
    got = P.DvbTFrameDemod(pp, device="cpu").decode_batch(
        torch.as_tensor(batch), jf.n_symbols, len(payload))
    assert pviterbi.viterbi_chunks_kernel.launches == before  # CPU
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert np.array_equal(g.payload, r.payload)
        assert np.array_equal(g.payload, payload)
        assert _same_tps(g.tps, r.tps)


def test_unknown_offset_capstone_decodes_in_the_port():
    # tests/test_dvb_t.py::test_frame_tps_end_to_end_unknown_offset_awgn
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/32", "qpsk", "1/2"), 1,
                               0x5A)
    payload = _payload(500, 7)
    frame = P.DvbTFrameMod(params, device="cpu").modulate(payload)
    rng = np.random.default_rng(8)
    buf = np.concatenate([np.zeros(777, np.complex64), frame.iq,
                          np.zeros(2000, np.complex64)])
    sig_p = float(np.mean(np.abs(frame.iq) ** 2))
    buf += ((rng.standard_normal(len(buf)) + 1j * rng.standard_normal(len(buf)))
            .astype(np.complex64) * np.sqrt(sig_p / 10 ** 0.4 / 2))
    rx = P.DvbTFrameDemod(params, device="cpu").decode(buf, frame.n_symbols,
                                                       len(payload))
    assert np.array_equal(rx.payload, payload)
    assert rx.tps == P.TpsWord(frame_number=1, constellation="qpsk",
                               code_rate_hp="1/2", guard="1/32", cell_id=0x5A)


def test_integer_cfo_capstone_decodes_in_the_port():
    # tests/test_dvb_t.py::test_frame_integer_cfo_builder_toggles
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    payload = _payload(184, 12)
    frame = P.DvbTFrameMod(params, device="cpu").modulate(payload)
    demod = P.DvbTFrameDemod(params, device="cpu")
    fs = demod.fs
    z, _ = jax_rotate(frame.iq, 3 * fs / 2048, fs)
    z = np.asarray(z)
    with pytest.raises(P.DvbTRxError):
        demod.decode(z, frame.n_symbols, len(payload))
    rx = demod.with_integer_cfo_correction(True).decode(z, frame.n_symbols,
                                                        len(payload))
    assert np.array_equal(rx.payload, payload)


def test_multipath_and_symbol_window_decode():
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    payload = _payload(300, 11)
    frame = P.DvbTFrameMod(params, device="cpu").with_symbol_window(40) \
        .modulate(payload)
    h = np.zeros(40, np.complex64)
    h[0], h[17] = 1.0, 0.4 * np.exp(1j * 1.1)
    mp = np.convolve(frame.iq, h).astype(np.complex64)
    rx = P.DvbTFrameDemod(params, device="cpu").with_rx_window_backoff(40) \
        .decode(mp, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


def test_rx_errors():
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/32", "qpsk", "1/2"))
    demod = P.DvbTFrameDemod(params, device="cpu")
    with pytest.raises(P.DvbTRxError) as e:
        demod.decode(np.zeros(3000, np.complex64), 68, 100)
    assert e.value.kind == P.DvbTRxError.ACQUISITION
    with pytest.raises(P.DvbTRxError) as e:
        demod.decode_batch(np.zeros((2, 1000), np.complex64), 68, 100)
    assert e.value.kind == P.DvbTRxError.INCOMPLETE


# ── waveform pieces ──────────────────────────────────────────────────────────


@pytest.mark.parametrize("v,alpha", [(2, 1), (4, 1), (4, 2), (4, 4), (6, 1),
                                     (6, 2), (6, 4)])
def test_map_demap_and_llrs_match(v, alpha):
    rng = np.random.default_rng(v * 10 + alpha)
    bits = rng.integers(0, 2, 200 * v).astype(np.uint8)
    ours = PD.dvb_t_map_symbols(torch.as_tensor(bits), v, alpha)
    ref = np.asarray(JD.dvb_t_map_symbols(bits, v, alpha))
    assert ours.dtype == torch.complex64
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    syms = (ref + 0.2 * (rng.standard_normal(ref.shape)
                         + 1j * rng.standard_normal(ref.shape))
            ).astype(np.complex64)
    assert np.array_equal(
        PD.dvb_t_demap_symbols(torch.as_tensor(syms), v, alpha).numpy(),
        np.asarray(JD.dvb_t_demap_symbols(syms, v, alpha)))
    np.testing.assert_allclose(
        PD.dvb_t_soft_llrs(torch.as_tensor(syms), v, alpha).numpy(),
        np.asarray(JD.dvb_t_soft_llrs(syms, v, alpha)), rtol=0, atol=1e-6)


def test_scattered_map_extract_and_channel_estimate_match():
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((9, 1512))
            + 1j * rng.standard_normal((9, 1512))).astype(np.complex64)
    for first in (0, 3):
        ours = PD.scattered_map_frame(torch.as_tensor(data), first)
        ref = np.asarray(JD.scattered_map_frame(data, first))
        assert np.array_equal(ours.numpy(), ref)
        assert np.array_equal(
            PD.scattered_extract_frame(ours, first).numpy(),
            np.asarray(JD.scattered_extract_frame(ref, first)))
    g = PD.scattered_grid()
    freq = np.asarray(JD.scattered_map_frame(data)) * np.exp(
        1j * np.linspace(0, 3, 2048)).astype(np.complex64)
    est = channel_estimate_pilots(torch.as_tensor(freq), g.ref_bins[1],
                                  g.ref_vals[1], 2048)
    ref = np.asarray(jax_estimate(freq, g.ref_bins[1], g.ref_vals[1], 2048))
    np.testing.assert_allclose(est.numpy(), ref, rtol=0, atol=1e-5)
    # a per-symbol layout: each symbol its own phase's pilots
    bins = np.stack([g.ref_bins[s % 4] for s in range(9)])
    vals = np.stack([g.ref_vals[s % 4] for s in range(9)])
    est = channel_estimate_pilots(torch.as_tensor(freq), bins, vals, 2048)
    ref = np.asarray(jax_estimate(freq, bins, vals, 2048))
    np.testing.assert_allclose(est.numpy(), ref, rtol=0, atol=1e-5)


def test_tps_and_ts_layers_match():
    rng = np.random.default_rng(4)
    for _ in range(5):
        info = rng.integers(0, 2, 53).astype(np.uint8)
        cw = PT.tps_bch_encode(info)
        assert np.array_equal(cw, JT.tps_bch_encode(info))
        bad = cw.copy()
        bad[rng.choice(67, 2, replace=False)] ^= 1
        assert np.array_equal(PT.tps_bch_decode(bad), info)
    for word in (P.TpsWord(3, "qam16", "3/4", "1/8", 0xA5),
                 P.TpsWord(0, "qam64", "7/8", "1/4", 1)):
        bits = word.pack()
        jword = JT.TpsWord(**dataclasses.asdict(word))
        assert np.array_equal(bits, jword.pack())
        assert P.TpsWord.unpack(bits) == word
        assert np.array_equal(PT.tps_encode_frame(bits),
                              JT.tps_encode_frame(bits))
        cells = PT.tps_encode_frame(bits)
        assert np.array_equal(PT.tps_decode_frame(cells), bits)
        dec = PT.TpsDecoder()
        for row in cells:
            dec.feed_symbol(row)
        assert dec.word() == word
    payload = _payload(1000, 3)
    ts = PS.ts_packetize(payload)
    assert np.array_equal(ts, JS.ts_packetize(payload))
    assert np.array_equal(PS.ts_energy_disperse(ts),
                          JS.ts_energy_disperse(ts))
    assert np.array_equal(PS.ts_stuff_null_packets(ts, 9),
                          JS.ts_stuff_null_packets(ts, 9))
    assert np.array_equal(PS.ts_depacketize(ts)[:1000], payload)
    assert np.array_equal(PD.energy_disperse(payload, 5),
                          JD.energy_disperse(payload, 5))


def test_gi_refine_and_integer_cfo_match():
    _, pp = _params("qpsk")
    frame = P.DvbTFrameMod(pp, device="cpu").modulate(_payload(400, 5))
    cap = np.concatenate([np.zeros(1234, np.complex64), frame.iq])
    fs = PD.dvb_t_fs_for_bandwidth(1e6)
    for r in (PG.dvb_t_gi_refine(torch.as_tensor(cap), 2048, 256, fs, 1200,
                                 100),
              JG.dvb_t_gi_refine(cap, 2048, 256, fs, 1200, 100)):
        assert r.start_sample == 1234
    freq = np.fft.fft(frame.iq[256:2304]).astype(np.complex64)
    for k in (-7, 0, 3):
        a = PG.dvb_t_integer_cfo(np.roll(freq, k), 2048, 32)
        b = JG.dvb_t_integer_cfo(np.roll(freq, k), 2048, 32)
        assert a.bins == b.bins == k
        assert a.confidence == pytest.approx(b.confidence, rel=1e-6)
    assert PG.dvb_t_gi_sync(torch.zeros(10000, dtype=torch.complex64), 2048,
                            256, fs, 2304) is None


def test_convert_dvb_t_params():
    jp, pp = _params("qam16")
    assert convert.dvb_t_frame_params_from_fields(
        dataclasses.asdict(jp)) == pp
    assert convert.dvb_t_link_params_from_fields(
        dataclasses.asdict(jp.link)) == pp.link
    assert pp.config().dvb_t_scattered


def test_unported_dvb_t_configurations_raise():
    # nothing of the DVB-T chain raises any more: the COFDM presets and the
    # TX lowpass, which raised here before slice 1 was finished, match the
    # JAX package, and the band receive came with slice 5a's channelizer
    # (tests/test_torch_band.py)
    _, pp = _params("qpsk")
    for name in ("dvb_t_config", "dvb_t_scattered_config"):
        for guard, bw in (("1/8", 1e6), ("1/32", 2e6)):
            ref = getattr(JD, name)(guard, bw)
            ours = getattr(PD, name)(guard, bw)
            assert convert.ofdm_config_from_fields(
                dataclasses.asdict(ref)) == ours
    assert dataclasses.asdict(PMF.tx_lowpass_for_2k(89, 60.0)) == \
        dataclasses.asdict(JMF.tx_lowpass_for_2k(89, 60.0))
    mask = PMF.tx_lowpass_for_2k(89, 60.0)
    assert P.DvbTFrameMod(pp, device="cpu").with_tx_lowpass(
        mask).tx_lowpass == mask
