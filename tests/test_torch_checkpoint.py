"""Torch port: checkpoint / resume of the streaming receivers and the
blocks (``checkpoint.py``), mirroring tests/test_checkpoint.py on the CPU:
feed part of a stream, ``save_checkpoint``, load into a freshly built
receiver, feed the rest; the output must equal the uninterrupted run's
exactly (texts, payloads, messages bit-exact), and equal the JAX
package's own uninterrupted run where the two packages decode the same
capture. Also: the file layout (JSON header, ``a:`` arrays, format
version), configuration and structure mismatches, tensors and numpy
scalars restored with their dtypes, derived tables fingerprinted and not
stored, and a NamedTuple filter state that appears only after the first
call."""

import json

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.checkpoint import state_dict, load_state_dict, \
    _FMT_VERSION

torch.set_num_threads(1)
CPU = "cpu"


def via_file(tmp_path, obj, fresh):
    p = str(tmp_path / "ckpt.npz")
    P.save_checkpoint(p, obj)
    return P.load_checkpoint(p, fresh)


# ── PSK31 ────────────────────────────────────────────────────────────────────


def test_psk31_bpsk_resume_matches_continuous(tmp_path):
    msg = "checkpoint resume text"
    iq = np.asarray(J.bpsk31_mod_text(msg, 8000.0, rf_hz=800.0))
    one = P.Psk31Stream.new_bpsk(8000.0, 800.0, device=CPU)
    t_one = one.feed(iq) + one.flush()
    j = J.Psk31Stream.new_bpsk(8000.0, 800.0)
    assert t_one == j.feed(iq) + j.flush() and msg in t_one
    cut = len(iq) // 2 + 137
    first = P.Psk31Stream.new_bpsk(8000.0, 800.0, device=CPU)
    t_a = first.feed(iq[:cut])
    resumed = via_file(tmp_path, first,
                       P.Psk31Stream.new_bpsk(8000.0, 800.0, device=CPU))
    assert t_a + resumed.feed(iq[cut:]) + resumed.flush() == t_one


def test_psk31_qpsk_resume_matches_continuous(tmp_path):
    msg = "qpsk stateful resume"
    iq = np.asarray(J.qpsk31_mod_text(msg, 8000.0, rf_hz=1000.0))

    def fresh():
        return P.Psk31Stream.new_qpsk(8000.0, 1000.0, device=CPU)
    one = fresh()
    t_one = one.feed(iq) + one.flush()
    assert msg in t_one
    first = fresh()
    t = first.feed(iq[: len(iq) // 3 + 71])
    mid = via_file(tmp_path, first, fresh())
    t += mid.feed(iq[len(iq) // 3 + 71: 2 * len(iq) // 3])
    last = load_state_dict(fresh(), state_dict(mid))     # in-memory hop
    assert t + last.feed(iq[2 * len(iq) // 3:]) + last.flush() == t_one


# ── FT8 ──────────────────────────────────────────────────────────────────────


def test_ft8_stream_resume_keeps_the_buffer_and_hash_table(tmp_path):
    dec = P.Ft8StreamDecoder.new_ft8(12000.0, 950.0, 1150.0, device=CPU)
    p1 = P.pack77(P.message.NonStd("CQ", "PJ4/K1ABC"), dec.hash_table)
    iq = P.ft8_mod(P.ft8_encode(p1, device=CPU), 12000.0, base_hz=1012.5,
                   device=CPU).numpy()
    assert dec.feed(iq[: len(iq) // 2]) == []
    resumed = via_file(tmp_path, dec, P.Ft8StreamDecoder.new_ft8(
        12000.0, 950.0, 1150.0, device=CPU))
    assert torch.equal(resumed.view_buf(), dec.view_buf())
    res = resumed.feed(iq[len(iq) // 2:])
    assert res and res[0].message.call_de == "PJ4/K1ABC"
    ht2 = P.CallsignHashTable()
    p2 = P.pack77(P.message.NonStd("PJ4/K1ABC", "W9XYZ"), ht2)
    assert P.unpack77(p2, resumed.hash_table).call_to == "<PJ4/K1ABC>"


# ── COFDM frame stream ───────────────────────────────────────────────────────


def _ofdm_link(m):
    plan = m.CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = m.OfdmConfig(plan, fs=1e6)
    pre = m.OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        plan.n_fft, plan.cp_len)
    return cfg, pre, m.McsTable.default_ladder()


def test_ofdm_frame_stream_resume_mid_frame(tmp_path):
    cfg, pre, table = _ofdm_link(P)
    payload = np.random.default_rng(5).integers(0, 256, 150).astype(np.uint8)
    iq = P.OfdmFrameMod(cfg, table, pre, device=CPU).modulate_frame(
        P.FramePacket(P.FrameMetadata(3, 1), payload), 0xC0)
    jcfg, jpre, jtable = _ofdm_link(J)
    assert np.allclose(iq, J.OfdmFrameMod(jcfg, jtable, jpre).modulate_frame(
        J.FramePacket(J.FrameMetadata(3, 1), payload), 0xC0), atol=1e-5)
    buf = np.concatenate([np.zeros(777, np.complex64), iq,
                          np.zeros(100, np.complex64)])
    s = P.OfdmFrameStreamDemod(cfg, table, pre, device=CPU)
    assert s.feed(buf[: len(buf) // 2]) == []
    resumed = via_file(tmp_path, s,
                       P.OfdmFrameStreamDemod(cfg, table, pre, device=CPU))
    assert np.array_equal(resumed.view_buf(), s.view_buf())
    res = resumed.feed(buf[len(buf) // 2:]) + resumed.flush()
    frames = [r for r in res if hasattr(r, "packet")]
    assert len(frames) == 1
    assert np.array_equal(frames[0].packet.payload, payload)
    assert frames[0].diagnostics.timing_offset_samples == 777


def test_checkpoint_config_and_structure_mismatch_raise(tmp_path):
    cfg, pre, table = _ofdm_link(P)
    s = P.OfdmFrameStreamDemod(cfg, table, pre, device=CPU)
    p = str(tmp_path / "s.npz")
    P.save_checkpoint(p, s)
    plan2 = P.CarrierPlan(256, 64).with_contiguous_data(edge_guard=24)
    with pytest.raises(ValueError, match="fingerprint"):
        P.load_checkpoint(p, P.OfdmFrameStreamDemod(
            P.OfdmConfig(plan2, fs=1e6), table, pre, device=CPU))
    with pytest.raises(ValueError, match="saved state is for"):
        P.load_checkpoint(p, P.Psk31Stream.new_bpsk(8000.0, device=CPU))
    saved = state_dict(P.Psk31Stream.new_qpsk(8000.0, device=CPU))
    with pytest.raises(ValueError):
        load_state_dict(P.Psk31Stream.new_bpsk(8000.0, device=CPU), saved)


def test_file_layout_and_version(tmp_path):
    s = P.Psk31Stream.new_qpsk(8000.0, 900.0, device=CPU)
    s.feed(np.asarray(J.qpsk31_mod_text("abc", 8000.0, rf_hz=900.0))[:3000])
    p = str(tmp_path / "q.npz")
    P.save_checkpoint(p, s)
    with np.load(p) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        names = set(z.files)
    assert header["version"] == _FMT_VERSION == 1
    assert header["class"] == "Psk31Stream"
    assert "a:_buf" in names and "a:viterbi.pm" in names
    # the trellis tables are configuration: fingerprinted, not stored
    assert "a:viterbi._pred" not in names
    assert "device" not in header["meta"]
    bad = dict(header, version=99)
    arrays = {k: np.load(p)[k] for k in names if k != "__header__"}
    np.savez(p, __header__=np.frombuffer(json.dumps(bad).encode(),
                                         np.uint8), **arrays)
    with pytest.raises(ValueError, match="version"):
        P.load_checkpoint(p, P.Psk31Stream.new_qpsk(8000.0, 900.0,
                                                    device=CPU))


# ── DVB-T streams ────────────────────────────────────────────────────────────


def test_dvb_t_stream_buffer_state_survives(tmp_path):
    params = P.DvbTFrameParams(P.DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    s = P.DvbTFrameStreamDemod(params, n_symbols=68, payload_len=64,
                               device=CPU)
    rng = np.random.default_rng(7)
    s.feed((rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
            ).astype(np.complex64))
    resumed = via_file(tmp_path, s, P.DvbTFrameStreamDemod(
        params, n_symbols=68, payload_len=64, device=CPU))
    assert np.array_equal(resumed.view_buf(), s.view_buf())
    assert resumed.sps == s.sps and resumed.demod.device == s.device
    other = P.DvbTFrameStreamDemod(P.DvbTFrameParams(
        P.DvbTLinkParams("1/4", "qpsk", "1/2"), 0, 0), 68, 64, device=CPU)
    with pytest.raises(ValueError):
        via_file(tmp_path, s, other)


def test_hier_dvb_t_stream_resume_mid_frame(tmp_path):
    link = P.DvbTHierLinkParams(guard="1/32", constellation="qam16",
                                alpha=2, code_rate_hp="1/2",
                                code_rate_lp="2/3")
    params = P.DvbTHierFrameParams(link=link)
    rng = np.random.default_rng(0)
    hp = rng.integers(0, 256, 300).astype(np.uint8)
    lp = rng.integers(0, 256, 700).astype(np.uint8)
    frame = P.DvbTHierFrameMod(params, device=CPU).modulate(hp, lp)
    stream = np.concatenate([np.zeros(500, np.complex64), frame.iq])
    cut = len(stream) // 2

    def fresh(p=params):
        return P.DvbTHierFrameStreamDemod(p, frame.n_symbols, len(hp),
                                          len(lp), device=CPU)
    a = fresh()
    out = a.feed(stream[:cut])
    resumed = via_file(tmp_path, a, fresh())
    out += resumed.feed(stream[cut:]) + resumed.flush()
    frames = [r for r in out if isinstance(r, P.DvbTHierRxFrame)]
    assert len(frames) == 1
    assert np.array_equal(frames[0].hp_payload, hp)
    assert np.array_equal(frames[0].lp_payload, lp)
    b = fresh()
    b.feed(stream[:cut])
    with pytest.raises(ValueError):
        via_file(tmp_path, b, fresh(P.DvbTHierFrameParams(
            link=P.DvbTHierLinkParams(guard="1/32", constellation="qam16",
                                      alpha=4))))


# ── the band receiver: a Channelizer with state on the device ───────────────


def test_band_receiver_resume_matches_continuous(tmp_path):
    cfg, pre, table = _ofdm_link(P)
    payload = np.random.default_rng(70).integers(0, 256, 90).astype(np.uint8)
    iq = P.OfdmFrameMod(cfg, table, pre, device=CPU).modulate_frame(
        P.FramePacket(P.FrameMetadata(4, 1), payload), 8)
    fs_wide, fc = 4e6, 0.7e6
    n_wide = 4 * (len(iq) + 4000)
    k = np.arange(n_wide)
    x = np.zeros(n_wide, np.complex128)
    up = np.repeat(np.asarray(iq, np.complex128), 4) / 4.0
    x[5000:5000 + len(up)] = up
    x = (x * np.exp(2j * np.pi * fc * k / fs_wide)).astype(np.complex64)

    def fresh():
        return P.OfdmFrameBandStreamDemod(cfg, table, pre, [fc], fs_wide,
                                          device=CPU)
    one = fresh()
    ref = one.feed(x).get(0, []) + one.flush().get(0, [])
    ok = [r for r in ref if hasattr(r, "packet")]
    assert ok and np.array_equal(ok[0].packet.payload, payload)
    cut = len(x) // 2 + 777
    a = fresh()
    got = a.feed(x[:cut]).get(0, [])
    st = state_dict(a)
    assert "channelizer._f" not in st["arrays"]          # derived: not kept
    assert st["meta"]["channelizer"]["state"]["_c"]["__np__"] == "<f4"
    resumed = via_file(tmp_path, a, fresh())
    assert isinstance(resumed.channelizer._c, np.float32)
    assert torch.equal(resumed.channelizer._state, a.channelizer._state)
    got += resumed.feed(x[cut:]).get(0, []) + resumed.flush().get(0, [])
    ok2 = [r for r in got if hasattr(r, "packet")]
    assert ok2 and np.array_equal(ok2[0].packet.payload, payload)
    moved = P.OfdmFrameBandStreamDemod(cfg, table, pre, [fc + 1e3], fs_wide,
                                       device=CPU)
    with pytest.raises(ValueError, match="fingerprint"):
        via_file(tmp_path, a, moved)


# ── blocks ───────────────────────────────────────────────────────────────────


def _tone_iq(n, fs=48_000.0, seed=1):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (np.exp(2j * np.pi * 1300.0 * k / fs) * (1 + 0.3 * np.sin(
        2 * np.pi * 400.0 * k / fs)) + 0.05 * (
        rng.standard_normal(n) + 1j * rng.standard_normal(n))
    ).astype(np.complex64)


@pytest.mark.parametrize("name", ["FmQuadratureDemod", "SsbProductDemod",
                                  "AmEnvelopeDemod", "CwEnvelopeDemod"])
def test_block_with_namedtuple_state_resumes(tmp_path, name):
    """The filter state is None until the first call and a NamedTuple of
    tensors after it: a fresh target rebuilds it from the file."""
    args = {"FmQuadratureDemod": (48e3, 5000.0, 3000.0),
            "SsbProductDemod": (48e3, 1500.0, 3000.0),
            "AmEnvelopeDemod": (48e3, 3000.0),
            "CwEnvelopeDemod": (48e3, 800.0, 200.0)}[name]
    cls = getattr(P, name)
    x = _tone_iq(8192)
    one = cls(*args, device=CPU).process(x)
    a = cls(*args, device=CPU)
    first = a.process(np.ascontiguousarray(x[:3001]))
    b = via_file(tmp_path, a, cls(*args, device=CPU))
    if name != "CwEnvelopeDemod":
        assert type(b._state) is type(a._state)
    rest = b.process(np.ascontiguousarray(x[3001:]))
    ref = a.process(np.ascontiguousarray(x[3001:]))
    assert np.array_equal(rest, ref)
    np.testing.assert_allclose(np.concatenate([first, rest]), one, rtol=0,
                               atol=2e-4 * float(np.abs(one).max()))


def test_qpsk31_demod_block_resumes(tmp_path):
    fs, rf = 8000.0, 1001.5625
    iq = P.Qpsk31Mod(fs, rf, device=CPU).modulate_text("block resume")
    a = P.Qpsk31Demod(fs, rf, device=CPU)
    a.process(np.ascontiguousarray(iq[:20_011]))
    b = via_file(tmp_path, a, P.Qpsk31Demod(fs, rf, device=CPU))
    assert b._n_mixed == a._n_mixed and b._prev_sym == a._prev_sym
    for blk in (a, b):
        blk.process(np.ascontiguousarray(iq[20_011:]))
    bits = b.flush()
    assert np.array_equal(bits, a.flush())
    assert "block resume" in P.VaricodeDecoder().push_bits(bits)


def test_ofdm_demod_block_resumes_with_its_estimate(tmp_path):
    plan = P.CarrierPlan(64, 16).with_contiguous_data(edge_guard=4)
    cfg = P.OfdmConfig(plan, fs=48e3, constellation="qam16", rf_hz=1500.0)
    bits = np.random.default_rng(3).integers(
        0, 2, 6 * cfg.bits_per_ofdm_symbol()).astype(np.uint8)
    iq = P.OfdmMod(cfg, device=CPU).process(bits)
    h = np.complex64(0.8 * np.exp(0.5j))
    a = P.OfdmDemod(cfg, device=CPU)
    known = np.ones(64, np.complex64)
    a.estimate_channel(known * h, known)
    rx = (iq * h).astype(np.complex64)
    first = a.process(np.ascontiguousarray(rx[:160]))
    b = via_file(tmp_path, a, P.OfdmDemod(cfg, device=CPU))
    assert torch.equal(b._estimate, a._estimate)
    out = np.concatenate([first, b.process(np.ascontiguousarray(rx[160:]))])
    assert np.array_equal(out, bits)
