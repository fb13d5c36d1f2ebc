"""Torch port: the multi-device layer (``orion_sdr_tpu_torch.parallel``)
against the JAX package's on the CPU. The JAX functions run on the 8
virtual CPU devices of tests/conftest.py, the port's on a ``Mesh`` of 8
CPU shards, on the same numpy-seeded inputs at tests/test_parallel.py's
shapes. Each case holds the port's sharded path to the JAX sharded
function and to the port's own single-device path, with the JAX tests'
tolerances: 1e-5 for FIR, channel maps and PSK31 soft values, 1e-4 for FM
and the OFDM demap (1e-3 under CPE), 1e-3 / 1e-4 for DVB-T LLRs / TPS
cells, 2e-4 relative for the spectrum; Viterbi, Forney, payloads, TPS
words, texts and counts exactly. Then the earliest-preamble choice of the
COFDM capstone, the two-process gloo run, and the entry points."""

import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as sdr
from orion_sdr_tpu import dsp as jdsp
from orion_sdr_tpu import parallel as JP
from orion_sdr_tpu.fec import conv as jconv
from orion_sdr_tpu.fec.interleave import forney_deinterleave as jforney
from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod as JDvbTMod
from orion_sdr_tpu.modulate.psk31 import bpsk31_mod_text, qpsk31_mod_text
from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble as JPreamble

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert, graft_entry
from orion_sdr_tpu_torch import parallel as PP
from orion_sdr_tpu_torch.demodulate.dvb_t_frame import receive_frame_body
from orion_sdr_tpu_torch.dsp.fir import fir_apply
from orion_sdr_tpu_torch.dsp.osc import rotate
from orion_sdr_tpu_torch.fec import conv as pconv
from orion_sdr_tpu_torch.fec.interleave import forney_deinterleave
from orion_sdr_tpu_torch.parallel import streaming as PS

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU8 = ["cpu"] * 8


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= 8
    return JP.make_mesh(8, shape=(2, 4))


@pytest.fixture(scope="module")
def pmesh():
    return PP.make_mesh(8, shape=(2, 4), devices=CPU8)


def host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def port_cfg(jcfg):
    return convert.ofdm_config_from_fields(dataclasses.asdict(jcfg))


def cnoise(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ── mesh ─────────────────────────────────────────────────────────────────────


def test_make_mesh_takes_named_devices_and_raises_without_cuda(monkeypatch):
    m = PP.make_mesh(8, shape=(2, 4), devices=CPU8)
    assert m.shape == dict(JP.make_mesh(8, shape=(2, 4)).shape)
    assert m.devices.shape == (2, 4) and m.size == 8
    assert all(d == torch.device("cpu") for d in m.devices.flat)
    assert PP.make_mesh(devices=CPU8).devices.shape == (8, 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PP.make_mesh()


# ── sharding.py ──────────────────────────────────────────────────────────────


def test_shard_channels_matches_jax_and_one_device():
    rng = np.random.default_rng(1)
    x = cnoise(rng, (8, 1024))

    def jpipe(z):
        y, _ = jdsp.rotate(z, -1000.0, 48e3)
        return y.real ** 2 + y.imag ** 2

    def ppipe(z):
        y, _ = rotate(z, -1000.0, 48e3)
        return y.real ** 2 + y.imag ** 2

    ref = np.asarray(JP.shard_channels(jpipe, JP.make_mesh(
        8, shape=(8, 1)))(x))
    out = PP.shard_channels(ppipe, PP.make_mesh(8, shape=(8, 1),
                                                devices=CPU8))(x)
    np.testing.assert_allclose(host(out), ref, atol=1e-5)
    np.testing.assert_allclose(host(out), host(ppipe(torch.as_tensor(x))),
                               atol=1e-5)


@pytest.mark.parametrize("ntaps,n", [(63, 4096), (1031, 16384)],
                         ids=["conv1d", "fft_overlap_save"])
def test_fir_overlap_save_sharded(jmesh, pmesh, ntaps, n):
    rng = np.random.default_rng(0)
    x = cnoise(rng, (2, n))
    taps = jdsp.kaiser_lowpass_taps(ntaps, 0.2, 60.0)
    ref = np.asarray(JP.fir_overlap_save_sharded(x, taps, jmesh))
    out = host(PP.fir_overlap_save_sharded(x, taps, pmesh))
    single, _ = fir_apply(torch.as_tensor(x), taps)
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, host(single), atol=1e-5)


def test_fm_demod_sharded(jmesh, pmesh):
    from orion_sdr_tpu.modulate import fm_mod
    fs = 48e3
    t = np.arange(8192) / fs
    audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
    iq, _ = fm_mod(np.stack([audio, audio]), fs, 2500.0)
    iq = np.asarray(iq)
    taps = jdsp.kaiser_lowpass_taps(31, 0.25, 50.0)
    ref = np.asarray(JP.fm_demod_sharded(iq, taps, jmesh, fs, 2500.0))
    out = host(PP.fm_demod_sharded(iq, taps, pmesh, fs, 2500.0))
    # the port's single-device chain: FIR, then the discriminator
    y = host(fir_apply(torch.as_tensor(iq), taps)[0])
    prev = np.concatenate([np.zeros((2, 1), np.complex64), y[:, :-1]], 1)
    prod = y * np.conj(prev)
    single = np.arctan2(prod.imag, prod.real) / 2500.0
    np.testing.assert_allclose(out[:, 1:], ref[:, 1:], atol=1e-4)
    np.testing.assert_allclose(out[:, 1:], single[:, 1:], atol=1e-4)


def _demap_case(case, rng):
    """(JAX config, constellation, iq, n_sym, estimate) of
    tests/test_parallel.py's demap cases, and a pilot_interp one."""
    n_sym = 16
    plan = sdr.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
    cfg = sdr.OfdmConfig(plan, fs=1e6)
    iq = cnoise(rng, (2, n_sym * 160))
    est = (0.5 + rng.random(128)
           + 1j * 0.3 * rng.standard_normal(128)).astype(np.complex64)
    if case == "plain":
        return cfg, "qpsk", iq, n_sym, None
    if case == "estimate":
        return cfg, "qpsk", iq, n_sym, est
    if case == "precoded":
        return cfg.with_transform_precoding(), "qam16", iq, n_sym, est
    if case == "pilot_interp":
        pplan = (sdr.CarrierPlan(128, 32)
                 .with_pilot_carriers([(i, 1.0 + 0j)
                                       for i in range(-48, 49, 8)])
                 .with_contiguous_data(edge_guard=8))
        return (sdr.OfdmConfig(pplan, fs=1e6).with_equalizer_method(
            "pilot_interp"), "qpsk", iq, n_sym, est)
    # cpe: QPSK cells behind a slow phase walk, so the correction acts
    from orion_sdr_tpu.constellation import map_bits
    from orion_sdr_tpu.multicarrier import CarrierGrid, grid_map
    nd = plan.num_data_carriers()
    bits = rng.integers(0, 2, 2 * n_sym * nd * 2).astype(np.uint8)
    pts = np.asarray(map_bits(bits, "qpsk")).reshape(2, n_sym, nd)
    walk = np.cumsum(rng.normal(0, 0.05, (2, n_sym)), axis=-1)
    freq = np.asarray(grid_map(CarrierGrid(plan), (
        pts * np.exp(1j * walk)[..., None]).astype(np.complex64)))
    tsym = np.fft.ifft(freq, axis=-1).astype(np.complex64)
    iq = np.concatenate([tsym[..., -32:], tsym], axis=-1).reshape(2, -1)
    return cfg.with_phase_tracking("cpe"), "qpsk", iq, n_sym, None


@pytest.mark.parametrize("case", ["plain", "estimate", "precoded", "cpe",
                                  "pilot_interp"])
def test_ofdm_soft_demap_sharded(jmesh, pmesh, case):
    rng = np.random.default_rng(
        {"plain": 3, "estimate": 4, "precoded": 6, "cpe": 5,
         "pilot_interp": 7}[case])
    jcfg, order, iq, n_sym, est = _demap_case(case, rng)
    tol = 1e-3 if case == "cpe" else 1e-4
    ref = JP.ofdm_soft_demap_sharded(jcfg, order, iq, n_sym, jmesh,
                                     estimate=est)
    cfg = port_cfg(jcfg)
    out = host(PP.ofdm_soft_demap_sharded(cfg, order, iq, n_sym, pmesh,
                                          estimate=est))
    single = host(P.soft_demap(cfg, order, torch.as_tensor(iq), n_sym,
                               None if est is None
                               else torch.as_tensor(est)))
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    np.testing.assert_allclose(out, single, atol=tol, rtol=tol)


def test_dvb_t_receive_sharded(jmesh, pmesh):
    from orion_sdr_tpu.waveform.dvb_t import guard_cp_len_2k
    link = sdr.DvbTLinkParams(guard="1/32", constellation="qpsk",
                              code_rate="1/2")
    cp = guard_cp_len_2k(link.guard)
    rng = np.random.default_rng(5)
    frames, n_sym = [], None
    for i in range(8):
        f = JDvbTMod(sdr.DvbTFrameParams(link, frame_number=i % 4,
                                         cell_id=i)).modulate(bytes(
                                             rng.integers(0, 256, 100)
                                             .astype(np.uint8)))
        n_sym = f.n_symbols
        frames.append(np.asarray(f.iq)[: n_sym * (2048 + cp)])
    segs = np.stack(frames)
    jl, jc = JP.dvb_t_receive_sharded(segs, n_sym, cp, 0, 2, jmesh)
    pl, pc = PP.dvb_t_receive_sharded(segs, n_sym, cp, 0, 2, pmesh)
    sl, sc = receive_frame_body(torch.as_tensor(segs), n_sym, cp, 0, 2)
    np.testing.assert_allclose(host(pl), jl, atol=1e-3)
    np.testing.assert_allclose(host(pc), jc, atol=1e-4)
    np.testing.assert_allclose(host(pl), host(sl), atol=1e-3)
    np.testing.assert_allclose(host(pc), host(sc), atol=1e-4)


# ── streaming.py ─────────────────────────────────────────────────────────────


@pytest.mark.parametrize("qpsk", [False, True], ids=["bpsk31", "qpsk31"])
def test_psk31_demod_sharded(jmesh, pmesh, qpsk):
    fs = 8000.0
    mod = qpsk31_mod_text if qpsk else bpsk31_mod_text
    iq = np.asarray(mod("the quick brown fox", fs))
    ref = JP.psk31_demod_sharded(iq, jmesh, fs, qpsk=qpsk)
    out = host(PP.psk31_demod_sharded(iq, pmesh, fs, qpsk=qpsk))
    demod = P.qpsk31_demod if qpsk else P.bpsk31_demod
    single = host(demod(iq, fs, device="cpu"))
    assert out.shape == ref.shape == single.shape and len(out) > 100
    np.testing.assert_allclose(out, ref, atol=1e-5)
    np.testing.assert_allclose(out, single, atol=1e-5)


@pytest.mark.parametrize("qpsk,carrier", [(False, 0.0), (True, 1000.0)],
                         ids=["bpsk31", "qpsk31_at_1khz"])
def test_psk31_stream_decode_sharded(jmesh, pmesh, qpsk, carrier):
    fs = 8000.0
    text = "tpu native psk31 stream"
    mod = qpsk31_mod_text if qpsk else bpsk31_mod_text
    iq = np.asarray(mod(text, fs, carrier))
    ref = JP.psk31_stream_decode_sharded(iq, jmesh, fs, carrier, qpsk)
    out = PP.psk31_stream_decode_sharded(iq, pmesh, fs, carrier, qpsk)
    st = (P.Psk31Stream.new_qpsk if qpsk else P.Psk31Stream.new_bpsk)(
        fs, carrier, device="cpu")
    single = st.feed(iq) + st.flush()
    assert text in out and text in single
    assert out == ref


def test_viterbi_sharded_matches_chunked(jmesh, pmesh):
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, 30_000).astype(np.uint8)
    coded = np.asarray(jconv.conv_encode_punctured(info, "3/4", "dvb_k7"))
    llr = ((1.0 - 2.0 * coded.astype(np.float32)) * 3.0
           + rng.standard_normal(len(coded)).astype(np.float32))
    ref = JP.viterbi_decode_sharded(llr, len(info), jmesh, "3/4", "dvb_k7")
    out = host(PP.viterbi_decode_sharded(llr, len(info), pmesh, "3/4",
                                         "dvb_k7"))
    single = host(pconv.viterbi_decode_soft_chunked(
        torch.as_tensor(llr), len(info), "3/4", "dvb_k7"))
    assert np.array_equal(out, ref)
    assert np.array_equal(out, single)
    assert np.mean(out != info) < 1e-3


@pytest.mark.parametrize("n", [48_000, 3 * 2244 + 5, 1000],
                         ids=["8_shards", "3_shards_padded", "host_path"])
def test_forney_sharded_bit_exact(jmesh, pmesh, n):
    x = np.random.default_rng(4).integers(0, 256, n).astype(np.uint8)
    ref = JP.forney_deinterleave_sharded(x, jmesh)
    out = host(PP.forney_deinterleave_sharded(x, pmesh))
    single, _ = forney_deinterleave(x)
    assert np.array_equal(out, ref)
    assert np.array_equal(out, single)
    assert np.array_equal(out, np.asarray(jforney(x)[0]))


@pytest.fixture(scope="module")
def dvb_capture():
    """tests/test_parallel.py's capstone capture: a 4000-byte QPSK r1/2 GI
    1/8 payload (272 symbols) behind 1500 zeros."""
    jparams = sdr.DvbTFrameParams(sdr.DvbTLinkParams("1/8", "qpsk", "1/2"),
                                  0, 0)
    payload = np.random.default_rng(5).integers(0, 256, 4000).astype(
        np.uint8)
    frame = JDvbTMod(jparams).modulate(payload)
    iq = np.concatenate([np.zeros(1500, np.complex64), frame.iq])
    params = convert.dvb_t_frame_params_from_fields(
        dataclasses.asdict(jparams))
    return jparams, params, payload, frame.n_symbols, iq


def test_dvb_t_receive_time_sharded(jmesh, pmesh, dvb_capture):
    _, _, _, n_sym, iq = dvb_capture
    seg = iq[1500: 1500 + n_sym * 2304]
    jl, jc = JP.dvb_t_receive_time_sharded(seg, n_sym, 256, 0, 2, jmesh)
    pl, pc = PP.dvb_t_receive_time_sharded(seg, n_sym, 256, 0, 2, pmesh)
    sl, sc = receive_frame_body(torch.as_tensor(seg), n_sym, 256, 0, 2)
    assert pl.shape == jl.shape and pc.shape == jc.shape
    np.testing.assert_allclose(host(pl), jl, atol=1e-3)
    np.testing.assert_allclose(host(pc), jc, atol=1e-4)
    np.testing.assert_allclose(host(pl), host(sl), atol=1e-3)
    np.testing.assert_allclose(host(pc), host(sc), atol=1e-4)


def test_dvb_t_decode_time_sharded_capstone(jmesh, pmesh, dvb_capture):
    jparams, params, payload, n_sym, iq = dvb_capture
    ref = JP.dvb_t_decode_time_sharded(iq, n_sym, len(payload), jparams,
                                       jmesh)
    out = PP.dvb_t_decode_time_sharded(iq, n_sym, len(payload), params,
                                       pmesh)
    single = P.DvbTFrameDemod(params, device="cpu").decode(
        iq, n_sym, len(payload))
    assert np.array_equal(out.payload, payload)
    assert np.array_equal(out.payload, ref.payload)
    assert np.array_equal(out.payload, single.payload)
    assert dataclasses.asdict(out.tps) == dataclasses.asdict(ref.tps)
    assert out.tps == single.tps


def _cofdm(jcfg, seq, mcs, payload, seed):
    table = sdr.McsTable.default_ladder()
    jpre = JPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    iq = sdr.OfdmFrameMod(jcfg, table, jpre).modulate_frame(
        sdr.FramePacket(sdr.FrameMetadata(seq, mcs), payload), seed)
    return table, jpre, np.asarray(iq)


def _port_link(jcfg, table, jpre):
    return (port_cfg(jcfg),
            convert.mcs_table_from_fields(dataclasses.asdict(table)),
            convert.preamble_from_fields(dataclasses.asdict(jpre)))


def _stream_packets(cfg, table, pre, buf):
    s = P.OfdmFrameStreamDemod(cfg, table, pre, device="cpu")
    return [r.packet for r in s.feed(buf) + s.flush()
            if hasattr(r, "packet")]


def test_ofdm_frame_decode_time_sharded_matches_stream(jmesh, pmesh):
    plan = (sdr.CarrierPlan(256, 64)
            .with_pilot_carriers([(i, 1.0 + 0j) for i in range(-100, 101, 8)])
            .with_contiguous_data(edge_guard=27))
    jcfg = sdr.OfdmConfig(plan, fs=1e6).with_equalizer_method("pilot_interp")
    payload = np.random.default_rng(21).integers(0, 256, 150).astype(
        np.uint8)
    table, jpre, iq = _cofdm(jcfg, 6, 2, payload, 3)
    h = np.zeros(6, np.complex64)
    h[0], h[3] = 1.0, 0.35 * np.exp(1j * 0.9)
    buf = np.convolve(np.concatenate([np.zeros(800, np.complex64), iq]),
                      h).astype(np.complex64)
    ref = JP.ofdm_frame_decode_time_sharded(jcfg, table, jpre, buf, jmesh)
    cfg, ptable, pre = _port_link(jcfg, table, jpre)
    out = PP.ofdm_frame_decode_time_sharded(cfg, ptable, pre, buf, pmesh)
    single = _stream_packets(cfg, ptable, pre, buf)[0]
    assert np.array_equal(out.payload, payload)
    assert np.array_equal(out.payload, ref.payload)
    assert np.array_equal(out.payload, single.payload)
    assert dataclasses.astuple(out.metadata) == \
        dataclasses.astuple(ref.metadata) == \
        dataclasses.astuple(single.metadata) == (6, 2, 0)


def test_ofdm_frame_capstone_training_hold_path(jmesh, pmesh, monkeypatch):
    plan = sdr.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    jcfg = sdr.OfdmConfig(plan, fs=1e6)
    payload = np.random.default_rng(22).integers(0, 256, 120).astype(
        np.uint8)
    table, jpre, iq = _cofdm(jcfg, 1, 1, payload, 9)
    buf = np.concatenate([np.zeros(333, np.complex64), iq])
    ref = JP.ofdm_frame_decode_time_sharded(jcfg, table, jpre, buf, jmesh)
    cfg, ptable, pre = _port_link(jcfg, table, jpre)
    # the training-hold path runs through the sharded demap, header and
    # payload, with the held estimate
    calls, real = [], PS.ofdm_soft_demap_sharded

    def counting(*a, **kw):
        calls.append(kw.get("estimate") is not None)
        return real(*a, **kw)
    monkeypatch.setattr(PS, "ofdm_soft_demap_sharded", counting)
    out = PP.ofdm_frame_decode_time_sharded(cfg, ptable, pre, buf, pmesh)
    assert calls == [True, True]
    single = _stream_packets(cfg, ptable, pre, buf)[0]
    assert np.array_equal(out.payload, payload)
    assert np.array_equal(out.payload, ref.payload)
    assert np.array_equal(out.payload, single.payload)


def test_ofdm_frame_capstone_takes_the_earliest_preamble(jmesh, pmesh):
    """Two frames in one capture, the earlier one noisier: the JAX capstone
    takes the best-scoring preamble (the later frame); the port's takes the
    earliest above the threshold, as the port's stream demod does, and
    returns the first frame."""
    plan = sdr.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    jcfg = sdr.OfdmConfig(plan, fs=1e6)
    rng = np.random.default_rng(23)
    pay_a = rng.integers(0, 256, 60).astype(np.uint8)
    pay_b = rng.integers(0, 256, 60).astype(np.uint8)
    table, jpre, iq_a = _cofdm(jcfg, 1, 0, pay_a, 1)
    _, _, iq_b = _cofdm(jcfg, 2, 0, pay_b, 2)
    # about 15 dB: the earlier frame decodes, but its preamble scores
    # below the clean later one's
    rms = float(np.sqrt(np.mean(np.abs(iq_a) ** 2) / 2))
    iq_a = iq_a + 0.18 * rms * cnoise(rng, len(iq_a))
    buf = np.concatenate([np.zeros(500, np.complex64), iq_a,
                          np.zeros(400, np.complex64), iq_b,
                          np.zeros(300, np.complex64)]).astype(np.complex64)
    ref = JP.ofdm_frame_decode_time_sharded(jcfg, table, jpre, buf, jmesh)
    cfg, ptable, pre = _port_link(jcfg, table, jpre)
    out = PP.ofdm_frame_decode_time_sharded(cfg, ptable, pre, buf, pmesh)
    stream = _stream_packets(cfg, ptable, pre, buf)
    assert ref.metadata.sequence_num == 2
    assert np.array_equal(ref.payload, pay_b)
    assert out.metadata.sequence_num == 1
    assert np.array_equal(out.payload, pay_a)
    assert [p.metadata.sequence_num for p in stream] == [1, 2]
    assert np.array_equal(out.payload, stream[0].payload)


# ── distributed.py ───────────────────────────────────────────────────────────


def test_init_distributed_is_a_no_op_on_one_process():
    assert PP.init_distributed() is False
    assert PP.init_distributed("localhost:1", 1, 0) is False
    assert JP.init_distributed() is False


def test_process_mesh_single_host_shape():
    mesh = PP.make_process_mesh(devices=CPU8)
    jm = JP.make_process_mesh()
    assert mesh.devices.shape == jm.devices.shape == (1, 8)
    assert mesh.axis_names == tuple(jm.axis_names) == ("host", "chip")
    assert (mesh.process_index, mesh.process_count) == (0, 1)


def test_ber_sharded_counts():
    from jax.sharding import Mesh as JMesh
    rng = np.random.default_rng(6)
    ref = rng.integers(0, 2, (8, 1000)).astype(np.uint8)
    hat = ref.copy()
    hat[3, :17] ^= 1
    jflat = JMesh(np.array(jax.devices()[:8]), ("ch",))
    got = PP.ber_sharded(ref, hat, PP.make_mesh(8, ("ch",), (8,),
                                                devices=CPU8))
    assert got == JP.ber_sharded(ref, hat, jflat) == (17 / 8000, 17, 8000)


def test_power_spectrum_sharded():
    from jax.sharding import Mesh as JMesh
    rng = np.random.default_rng(7)
    x = cnoise(rng, (8, 4096))
    jflat = JMesh(np.array(jax.devices()[:8]), ("ch",))
    ref = JP.power_spectrum_sharded(x, jflat, nfft=512)
    got = host(PP.power_spectrum_sharded(
        x, PP.make_mesh(8, ("ch",), (8,), devices=CPU8), nfft=512))
    want = np.mean(np.abs(np.fft.fft(x.reshape(8, 8, 512), axis=-1)) ** 2,
                   axis=(0, 1))
    np.testing.assert_allclose(got, ref, rtol=2e-4)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_measure_scaling_runs_and_formats():
    taps = np.asarray(jdsp.kaiser_lowpass_taps(31, 0.2, 50.0), np.float32)

    def make_fn(mesh):
        return PP.shard_channels(lambda z: fir_apply(z, taps)[0], mesh)

    def make_input(n):
        rng = np.random.default_rng(n)
        return (rng.standard_normal((n, 1 << 15)).astype(np.float32),)

    rows = PP.measure_scaling(make_fn, make_input, device_counts=[1, 2, 4, 8],
                              reps=2, devices=CPU8)
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["samples_per_s"] > 0 for r in rows)
    table = PP.format_scaling_table(rows)
    assert table == JP.format_scaling_table(rows)
    assert "efficiency" in table and len(table.splitlines()) == 5


def test_two_process_gloo_ber(tmp_path):
    """tools/torch_distributed_smoke.py: two processes join one gloo group
    through a file under ``tmp_path`` and all-reduce ber_sharded's counts
    (3 + 5 errors of 1024 bits)."""
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_distributed_smoke.py"),
         "--rendezvous", str(tmp_path)],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "torch distributed smoke: PASS" in r.stdout
    assert r.stdout.count("errs=8/1024 OK") == 2


# ── entry points ─────────────────────────────────────────────────────────────


def _jax_graft_entry():
    spec = importlib.util.spec_from_file_location(
        "_jax_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_matches_the_jax_entry():
    jfn, jargs = _jax_graft_entry().entry()
    fn, args = graft_entry.entry(device="cpu")
    assert all(a.dtype == torch.float32 for a in args)
    for a, j in zip(args, jargs):
        assert np.array_equal(host(a), np.asarray(j))
    ref = np.asarray(jfn(*jargs))
    out = host(fn(*args))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-4 * np.abs(ref).max())


def test_dryrun_multichip_on_eight_cpu_shards():
    graft_entry.dryrun_multichip(8, CPU8)
