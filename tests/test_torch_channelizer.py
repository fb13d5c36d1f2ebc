"""Torch port, the channelizers (dsp/pfb.py, dsp/channelizer.py) and the
band receivers on top of them (demodulate/analog.py's am_band_demod,
demodulate/fm_stereo.py's fm_band_demod) against the JAX package on the
CPU, with the same numpy inputs.

Tolerances: 1e-5 of the output's largest magnitude for channel IQ, the
composed capture and band audio (torch's FFT and conv1d and XLA's round
apart; measured at most 1e-6), with carried mixer phases exact (the port
rounds them as XLA's fused and folded block does, dsp/channelizer.py); the
PFB within 2e-6 of its peak; blind-scan centroids within 0.1 Hz, the
audio then compared from the same centers. Exact for the prototype, the
taps, the station counts, RDS bits and station data, and between any two
chunkings of one port channelizer (its fixed internal block makes the
output independent of the feed sizes). Both FIR routes of the port run: 291 taps through
conv1d and 2897 through the FFT overlap-save (``_FFT_MIN_TAPS`` 1025)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from test_torch_dsp_iir import close

from orion_sdr_tpu.codec import rds as JR
from orion_sdr_tpu.demodulate import analog as JA
from orion_sdr_tpu.demodulate import fm_stereo as JF
from orion_sdr_tpu.dsp import channelizer as JC
from orion_sdr_tpu.dsp import pfb as JP
from orion_sdr_tpu.dsp.osc import rotate as jrotate
from orion_sdr_tpu.modulate import analog as JMA
from orion_sdr_tpu.modulate import fm_stereo as JMF

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.demodulate import analog as PA
from orion_sdr_tpu_torch.demodulate import fm_stereo as PF
from orion_sdr_tpu_torch.dsp import channelizer as PC
from orion_sdr_tpu_torch.dsp import fir as PFIR
from orion_sdr_tpu_torch.dsp import pfb as PP

torch.set_num_threads(1)
CPU = "cpu"
FS_WIDE, FS_OUT = 8e6, 1e6
CENTERS = [-2.1e6, 0.3e6, 1.5e6]
# (passband, taps): one design below the FFT threshold, one above it
DESIGNS = [(None, 291), (0.49e6, 2897)]


def _noise(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)


def _feed(ch, x, chunk):
    parts = [ch.push(x[i:i + chunk]) for i in range(0, len(x), chunk)]
    parts.append(ch.flush())
    return parts


def _cat_jax(parts):
    return np.concatenate([np.asarray(p) for p in parts], axis=-1)


def test_pfb_matches():
    x = _noise(1 << 14, 1)
    assert np.array_equal(PP.pfb_prototype(16), JP.pfb_prototype(16))
    np.testing.assert_array_equal(PP.pfb_channel_freqs(16, 1e6),
                                  JP.pfb_channel_freqs(16, 1e6))
    for c in (16, 64):
        ref = np.asarray(JP.pfb_channelize(x, c))
        got = PP.pfb_channelize(x, c, device=CPU)
        close(ref, got, rtol=2e-6)
    with pytest.raises(ValueError):
        PP.pfb_channelize(x[:100], 16, device=CPU)
    with pytest.raises(ValueError):
        PP.pfb_channelize(x.reshape(2, -1), 16, device=CPU)


@pytest.mark.parametrize("passband,n_taps", DESIGNS)
def test_channelizer_under_three_chunkings(passband, n_taps):
    x = _noise(70_001, 2)
    jc = JC.Channelizer(FS_WIDE, FS_OUT, CENTERS, passband_hz=passband)
    ref = _cat_jax(_feed(jc, x, 20_000))
    assert len(jc.taps) == n_taps
    assert (n_taps >= PFIR._FFT_MIN_TAPS) == (passband is not None)
    outs = []
    for chunk in (len(x), 20_000, 7_001):
        pc = PC.Channelizer(FS_WIDE, FS_OUT, CENTERS, passband_hz=passband,
                            device=CPU)
        assert np.array_equal(pc.taps, jc.taps)
        got = torch.cat(_feed(pc, x, chunk), dim=-1)
        close(ref, got)
        assert np.array_equal(pc._phase.numpy(), np.asarray(jc._phase))
        outs.append(got)
    for other in outs[1:]:
        assert torch.equal(outs[0], other)


def test_channelizer_validation():
    with pytest.raises(ValueError):
        PC.Channelizer(8e6, 3e6, [0.0], device=CPU)
    with pytest.raises(ValueError):
        PC.Channelizer(8e6, 1e6, [], device=CPU)
    with pytest.raises(ValueError):
        PC.Channelizer(8e6, 1e6, [4.5e6], device=CPU)
    ch = PC.Channelizer(8e6, 1e6, [0.0, 1e6], device=CPU)
    assert ch.flush().shape == (2, 0) and ch.push(np.zeros(100)).shape == \
        (2, 0) and len(ch) == 100 and ch.num_channels == 2


def test_band_compose_matches():
    chans = _noise(3 * 3000, 3).reshape(3, 3000)
    centers = [-2e6, 0.1e6, 3e6]
    close(JC.band_compose(chans, centers, FS_WIDE, FS_OUT),
          PC.band_compose(chans, centers, FS_WIDE, FS_OUT, device=CPU))
    close(JC.band_compose(chans[:1], [0.0], FS_OUT, FS_OUT),
          PC.band_compose(chans[:1], [0.0], FS_OUT, FS_OUT, device=CPU))
    with pytest.raises(ValueError):
        PC.band_compose(chans, centers[:2], FS_WIDE, FS_OUT, device=CPU)


def test_channelizer_from_jax_continues_the_stream():
    """A stream the JAX channelizer began continues in the port: the
    port's output after the hand-over equals the JAX channelizer's own
    continuation."""
    x = _noise(90_003, 4)
    jc = JC.Channelizer(FS_WIDE, FS_OUT, CENTERS)
    jc.push(x[:40_001])
    pc = convert.channelizer_from_jax(vars(jc), device=CPU)
    assert np.array_equal(pc.taps, jc.taps) and len(pc) == len(jc)
    ref = _cat_jax([jc.push(x[40_001:]), jc.flush()])
    got = torch.cat([pc.push(x[40_001:]), pc.flush()], dim=-1)
    close(ref, got)


def _same_centers(got, want, n):
    """A blind scan finds the same stations in both packages, their
    centroids within 0.1 Hz (two float32 ulps at 800 kHz)."""
    assert len(got) == len(want) == n
    np.testing.assert_allclose([s.center_hz for s in got],
                               [s.center_hz for s in want], rtol=0, atol=0.1)


def _am_band(n, fs):
    t = np.arange(n) / fs

    def station(f_audio, center, gain):
        audio = (0.6 * np.sin(2 * np.pi * f_audio * t)).astype(np.float32)
        iq, _ = JMA.am_mod(audio, fs)
        return gain * np.asarray(jrotate(np.asarray(iq), center, fs)[0])

    band = (station(800, -300e3, 1.0) + station(1500, 50e3, 0.6)
            + station(2200, 350e3, 0.3)).astype(np.complex64)
    return (band + 0.01 * _noise(n, 0)).astype(np.complex64)


def test_am_band_demod_blind_scan_matches():
    """tests/test_fm_broadcast.py::test_am_band_demod_blind_scan's band at
    2^17 samples: the same three stations, levels and audio."""
    fs = 1_000_000.0
    band = _am_band(1 << 17, fs)
    want = JA.am_band_demod(band, fs)
    got = PA.am_band_demod(band, fs, device=CPU)
    _same_centers(got, want, 3)
    # the audio from the same centers (a blind scan's centroids differ in
    # the last float32 digits between the two Welch PSDs)
    got = PA.am_band_demod(band, fs, [s.center_hz for s in want],
                           device=CPU)
    for g, w in zip(got, want):
        assert g.fs_audio == w.fs_audio
        assert g.carrier_level == pytest.approx(w.carrier_level, rel=1e-5)
        close(w.audio, g.audio)


def test_fm_band_demod_matches():
    """tests/test_fm_broadcast.py::test_fm_band_demod_blind_scan_three_
    stations' band, cut to two stations and 2^20 samples at 2.4 MS/s: the
    blind scan finds the same centers, stereo audio within tolerance, RDS
    bits and station data exact."""
    fs_wide = 2_400_000.0
    n = 1 << 20
    t = np.arange(n) / fs_wide

    def station(f_l, f_r, ps, center, gain=1.0):
        left = (0.8 * np.sin(2 * np.pi * f_l * t)).astype(np.float32)
        right = (0.8 * np.sin(2 * np.pi * f_r * t)).astype(np.float32)
        bits = JR.rds_encode_groups(JR.rds_groups_0a(0x1234, ps_name=ps))
        iq, _ = JMF.fm_stereo_mod(left, right, fs_wide, rds_bits=bits)
        return gain * np.asarray(jrotate(np.asarray(iq), center, fs_wide)[0])

    band = (station(1000, 2500, "ALPHA FM", -800e3)
            + station(400, 3000, "GAMMAFM ", 650e3, gain=0.5)
            ).astype(np.complex64)
    band = (band + 0.02 * _noise(n, 1)).astype(np.complex64)
    want = JF.fm_band_demod(band, fs_wide, decode_rds=True)
    _same_centers(PF.fm_band_demod(band, fs_wide, device=CPU), want, 2)
    got = PF.fm_band_demod(band, fs_wide, [s.center_hz for s in want],
                           decode_rds=True, device=CPU)
    for g, w in zip(got, want):
        for name in ("left", "right", "mono"):
            close(getattr(w.audio, name), getattr(g.audio, name))
        assert g.audio.pilot_level == pytest.approx(w.audio.pilot_level,
                                                    rel=1e-5)
        assert np.array_equal(g.audio.rds_bits, w.audio.rds_bits)
        assert g.audio.rds.groups == w.audio.rds.groups
        assert g.audio.rds.ps_name == w.audio.rds.ps_name
