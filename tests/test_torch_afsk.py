"""Torch port, the 2-FSK engine with AX.25 and RTTY (modulate/afsk.py,
demodulate/afsk.py, codec/ax25.py, codec/rtty.py) against the JAX package
on the CPU, with the same numpy inputs.

Tolerances: exact for NRZI, the CRC-16/X.25, address fields, HDLC bit
streams (stuffing, flags, FCS), Baudot codes, RTTY line states, decoded
frames and texts. The tone engine's audio within amplitude × 8 ulps of the
burst's final phase: the port sums the float32 phase steps in float64 and
rounds once, XLA's cumsum is a float32 tree (measured 4 ulps apart at the
end of 200 000 samples; 5.5e-4 on an AX.25 beacon, 9.4e-3 on an RTTY
line). The decision waveform within 1e-5 of its peak (the boxcar's sum
order and torch's cos/sin; measured 1.8e-7)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
from orion_sdr_tpu.codec import ax25 as JX
from orion_sdr_tpu.codec import rtty as JR
from orion_sdr_tpu.demodulate import afsk as JD
from orion_sdr_tpu.modulate import afsk as JM

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.codec import ax25 as PX
from orion_sdr_tpu_torch.codec import rtty as PR
from orion_sdr_tpu_torch.demodulate import afsk as PD
from orion_sdr_tpu_torch.modulate import afsk as PM
from orion_sdr_tpu_torch.modulate.pocsag import _fsk_iq

torch.set_num_threads(1)
CPU = "cpu"
FS = 48_000.0
FRAMES = [dict(dest="APRS", src="W1AW-5", digis=("WIDE1-1",),
               payload=b"!4237.14N/07120.83W-orion test"),
          dict(dest="CQ", src="N0CALL", payload=b"hello packet")]
MSG = "CQ CQ DE W1AW W1AW K 599 #73!"


def audio_close(got, ref, fs, f_max=2300.0, amplitude=0.8):
    """Within amplitude × 8 float32 ulps of the burst's final phase."""
    ph = 2 * np.pi * f_max * len(ref) / fs
    tol = amplitude * 8 * float(np.spacing(np.float32(ph)))
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= tol


def frames_vars():
    return [vars(P.Ax25Frame(**f)) for f in FRAMES]


def test_nrzi_crc_address_exact():
    bits = np.random.default_rng(0).integers(0, 2, 256).astype(np.uint8)
    assert np.array_equal(PM.nrzi_encode(bits), JM.nrzi_encode(bits))
    assert np.array_equal(PM.nrzi_decode(bits), JM.nrzi_decode(bits))
    data = bytes(range(200))
    assert PX.ax25_crc(data) == JX.ax25_crc(data)
    assert PX.ax25_crc(b"123456789") == 0x906E
    for call in ("N0CALL", "W1AW-5", "K1ABC-15"):
        for last in (False, True):
            assert PX._encode_address(call, last) == \
                JX._encode_address(call, last)
    with pytest.raises(ValueError):
        PX._encode_address("TOOLONGCALL", False)


def test_hdlc_bits_and_frames_exact():
    pf = [P.Ax25Frame(**f) for f in FRAMES]
    jf = [J.Ax25Frame(**f) for f in FRAMES]
    assert [f.encode() for f in pf] == [f.encode() for f in jf]
    raw = [f.encode() for f in pf] + [bytes([0xFF] * 30)]
    bits = PX.hdlc_encode(raw)
    assert np.array_equal(bits, JX.hdlc_encode(raw))
    assert PX.hdlc_frames_raw(bits, check_fcs=False) == \
        JX.hdlc_frames_raw(bits, check_fcs=False)
    got = PX.hdlc_decode_with_pos(bits)
    ref = JX.hdlc_decode_with_pos(bits)
    assert [(vars(f), p) for f, p in got] == [(vars(f), p) for f, p in ref]
    assert [vars(f) for f in PX.hdlc_decode(bits)] == frames_vars()


def test_baudot_and_rtty_framing_exact():
    msg = "CQ DE W1AW 599 73! (TEST) -./"
    codes = PR.baudot_encode(msg)
    assert codes == JR.baudot_encode(msg)
    assert PR.baudot_decode(codes) == JR.baudot_decode(codes) == msg
    line = PR.rtty_frame_bits(codes)
    assert np.array_equal(line, JR.rtty_frame_bits(codes))
    garbled = line.copy()
    garbled[8 + 7 * 3: 8 + 7 * 4] ^= 1
    assert PR.rtty_unframe_bits(garbled) == JR.rtty_unframe_bits(garbled)


@pytest.mark.parametrize("sps,n", [(40.0, 6000), (242.55775577557756, 9000)])
def test_fsk2_tones_match(sps, n):
    line = np.random.default_rng(1).integers(0, 2, 40).astype(np.uint8)
    ref = np.asarray(JM.fsk2_tones(line, 8000.0, sps, 0.8, n))
    got = PM.fsk2_tones(line, 8000.0, sps, 0.8, n, device=CPU)
    audio_close(got, ref, 8000.0)


def test_fsk2_decision_matches_batched():
    """(2, n): the bench's batched layout, each row against the JAX
    package's decision."""
    x = np.random.default_rng(2).standard_normal((2, 8192)).astype(
        np.float32)
    got = PD.fsk2_decision(x, FS, 40, device=CPU).numpy()
    ref = np.asarray(JD.fsk2_decision(x, FS, 40))
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    one = PD.fsk2_decision(x[1], FS, 40, device=CPU).numpy()
    assert np.array_equal(one, got[1])


def test_ax25_beacon_roundtrip_across_packages():
    pf = [P.Ax25Frame(**f) for f in FRAMES]
    p_audio = P.ax25_beacon(pf, FS, device=CPU)
    j_audio = J.ax25_beacon([J.Ax25Frame(**f) for f in FRAMES], FS)
    audio_close(p_audio, j_audio, FS)
    assert P.ax25_decode(j_audio, FS, device=CPU) == pf
    assert [vars(f) for f in J.ax25_decode(p_audio.numpy(), FS)] == \
        frames_vars()
    assert np.array_equal(P.afsk1200_demod(j_audio, FS, device=CPU),
                          J.afsk1200_demod(j_audio, FS))
    shifted = np.concatenate([np.zeros(777, np.float32), j_audio])
    assert P.ax25_decode(shifted, FS, device=CPU) == pf
    with pytest.raises(ValueError):
        P.afsk1200_mod(np.zeros(64, np.uint8), 4000.0, device=CPU)
    assert P.afsk1200_demod(np.zeros(50, np.float32), FS,
                            device=CPU).size == 0


def test_rtty_audio_roundtrip_across_packages():
    fs = 11025.0
    p_audio = P.rtty_mod(MSG, fs, device=CPU)
    j_audio = J.rtty_mod(MSG, fs)
    audio_close(p_audio, j_audio, fs)
    assert P.rtty_decode(j_audio, fs, device=CPU) == MSG
    assert J.rtty_decode(p_audio.numpy(), fs) == MSG
    rng = np.random.default_rng(0)
    noisy = j_audio + rng.standard_normal(len(j_audio)).astype(np.float32) \
        * np.sqrt(float(np.mean(j_audio ** 2)) / 10 ** 0.8)     # 8 dB
    assert P.rtty_decode(noisy, fs, device=CPU) == \
        J.rtty_decode(noisy, fs) == MSG


def test_rtty_from_iq_fsk():
    """HF RTTY at IQ baseband: 170 Hz shift, 45.45 baud at 8 kHz, both
    polarities; the port's decoder against the JAX package's."""
    fs, baud = 8000.0, 45.45
    line = PR.rtty_frame_bits(PR.baudot_encode("RYRYRY DE K1ABC TEST"))
    sps = fs / baud
    iq = _fsk_iq(line, fs, sps, 85.0, int(round(len(line) * sps)),
                 device=CPU).numpy()
    for z in (iq, np.conj(iq)):
        got = PD.rtty_decode_fsk(z, fs, baud, device=CPU)
        assert got == JD.rtty_decode_fsk(z, fs, baud)
        assert "DE K1ABC TEST" in got


def _stream_audio():
    fr = [dict(dest="APRS", src="W1AW-5", payload=b"frame one"),
          dict(dest="CQ", src="N0CALL", payload=b"frame two here"),
          dict(dest="BEACON", src="K1ABC", payload=b"third")]
    parts = [J.ax25_beacon([J.Ax25Frame(**f)], FS) for f in fr]
    audio = np.concatenate([parts[0], np.zeros(20000, np.float32), parts[1],
                            np.zeros(5000, np.float32), parts[2]])
    return audio, [P.Ax25Frame(**f) for f in fr]


def test_stream_tnc_chunk_invariant():
    audio, want = _stream_audio()
    for chunk in (7777, len(audio)):
        tnc = P.Afsk1200Stream(FS, device=CPU)
        got = []
        for i in range(0, len(audio), chunk):
            got += tnc.feed(audio[i:i + chunk])
        got += tnc.flush()
        assert got == want, chunk
        assert len(tnc) == 0


def test_stream_begun_in_jax_finishes_in_the_port():
    """convert.afsk1200_stream_from_jax: half the audio fed to the JAX TNC,
    the rest to the port's: each frame once, as one unbroken stream."""
    audio, want = _stream_audio()
    cut = len(audio) // 2
    a = JD.Afsk1200Stream(FS)
    got = [P.Ax25Frame(**vars(f)) for f in a.feed(audio[:cut])]
    b = convert.afsk1200_stream_from_jax(vars(a), device=CPU)
    got += b.feed(audio[cut:]) + b.flush()
    assert got == want
