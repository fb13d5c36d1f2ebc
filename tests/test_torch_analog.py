"""Torch port, the analog modulators and demodulators (modulate/analog.py,
demodulate/analog.py) and their states against the JAX package on the CPU,
with the same numpy inputs.

Tolerances: 1e-5 of the output's largest magnitude for IQ and audio (the
port's scans, matmuls and convolutions sum in another order than XLA's;
measured at most 4e-6), except ``fm_mod``'s IQ and phase carry at 5e-4
absolute: its phase is a cumulative sum, which torch accumulates on the
CPU in float64 and XLA in float32 (measured 1.5e-4 at 8192 samples). The CW
envelope is the two-rate one-pole kernel's plain version on the CPU. A
state carried out of the JAX package continues in the port (convert.py)
as in the JAX package's own second call, and two calls of the port equal
two calls of the JAX package; where a phase is carried, one call and two
differ by that phase's float32 rounding (four ulps of it). The
FM roundtrip holds the JAX test's 20 dB tone SNR."""

import jax
import numpy as np
import pytest
import torch

from helpers import tail, tone_snr_db
from test_torch_dsp_iir import close

from orion_sdr_tpu.demodulate import analog as JD
from orion_sdr_tpu.dsp import osc as JO
from orion_sdr_tpu.modulate import analog as JM

from orion_sdr_tpu_torch import convert
from orion_sdr_tpu_torch.demodulate import analog as PD
from orion_sdr_tpu_torch.modulate import analog as PM

torch.set_num_threads(1)
CPU = "cpu"
FS = 48_000.0
N = 8192
# fm_mod's phase is a cumulative sum: torch accumulates it on the CPU in
# float64, XLA in float32 (measured 1.5e-4 at 8192 samples)
FM_MOD_ATOL = 5e-4


def audio(f_hz=1000.0, amp=0.5, n=N):
    return (amp * np.sin(2 * np.pi * f_hz * np.arange(n) / FS)
            ).astype(np.float32)


def iq_noisy(seed, n=N):
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    return (np.exp(2j * np.pi * 1300.0 * k / FS) * (1 + 0.3 * np.sin(
        2 * np.pi * 400.0 * k / FS)) + 0.05 * (rng.standard_normal(n) + 1j
                                               * rng.standard_normal(n))
            ).astype(np.complex64)


def phase_tol(f_hz, fs, n):
    """Relative bound on a unit phasor moved by the float32 rounding of a
    phase up to 2π·f·n/fs: four ulps of it."""
    return 4 * float(np.spacing(np.float32(2 * np.pi * f_hz * n / fs)))


def np_tree(state):
    return jax.tree.map(np.asarray, state)


# ── modulators ───────────────────────────────────────────────────────────────

def test_cw_mod_and_state():
    key = (np.arange(4000) // 500 % 2).astype(np.float32)
    ref, rs = JM.cw_mod(key, 8000.0, 700.0, rise_ms=4.0, fall_ms=2.0)
    got, gs = PM.cw_mod(key, 8000.0, 700.0, rise_ms=4.0, fall_ms=2.0,
                        device=CPU)
    close(ref, got)
    close(rs.env, gs.env)
    close(rs.phase, gs.phase)
    a, sa = PM.cw_mod(key[:1500], 8000.0, 700.0, 4.0, 2.0, device=CPU)
    b, _ = PM.cw_mod(key[1500:], 8000.0, 700.0, 4.0, 2.0, state=sa,
                     device=CPU)
    ja, js = JM.cw_mod(key[:1500], 8000.0, 700.0, 4.0, 2.0)
    jb, _ = JM.cw_mod(key[1500:], 8000.0, 700.0, 4.0, 2.0, state=js)
    close(np.concatenate([ja, jb]), torch.cat([a, b]))
    b, _ = PM.cw_mod(key[1500:], 8000.0, 700.0, 4.0, 2.0,
                     state=convert.cw_state_from_fields(np_tree(js), CPU),
                     device=CPU)
    close(jb, b)
    # one call and two calls differ by the rounding of the carried phase
    close(ref, torch.cat([a, b]), phase_tol(700.0, 8000.0, 4000))


@pytest.mark.parametrize("clamp", [False, True])
def test_am_and_pm_mod(clamp):
    x = audio() * 3.0
    ref, rph = JM.am_mod(x, FS, rf_hz=2000.0, modulation_index=0.8,
                         clamp=clamp, phase0=0.25)
    got, gph = PM.am_mod(x, FS, rf_hz=2000.0, modulation_index=0.8,
                         clamp=clamp, phase0=0.25, device=CPU)
    close(ref, got)
    assert np.float32(rph) == np.float32(gph)
    ref, _ = JM.pm_mod(x, FS, 1.2, rf_hz=500.0)
    got, _ = PM.pm_mod(x, FS, 1.2, rf_hz=500.0, device=CPU)
    close(ref, got)


@pytest.mark.parametrize("usb", [True, False])
def test_ssb_mod_and_state(usb):
    x = audio()
    ref, rs = JM.ssb_mod(x, FS, 2700.0, 1500.0, rf_hz=1000.0, usb=usb)
    got, gs = PM.ssb_mod(x, FS, 2700.0, 1500.0, rf_hz=1000.0, usb=usb,
                         device=CPU)
    close(ref, got)
    ja, js = JM.ssb_mod(x[:3000], FS, 2700.0, 1500.0, rf_hz=1000.0, usb=usb)
    jb, _ = JM.ssb_mod(x[3000:], FS, 2700.0, 1500.0, rf_hz=1000.0, usb=usb,
                       state=js)
    b, _ = PM.ssb_mod(x[3000:], FS, 2700.0, 1500.0, rf_hz=1000.0, usb=usb,
                      state=convert.ssb_state_from_fields(np_tree(js), CPU),
                      device=CPU)
    close(jb, b)


def test_fm_mod_and_state():
    x = audio()
    ref, rs = JM.fm_mod(x, FS, 2500.0, rf_hz=3000.0)
    got, gs = PM.fm_mod(x, FS, 2500.0, rf_hz=3000.0, device=CPU)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=FM_MOD_ATOL)
    np.testing.assert_allclose(gs.phase.numpy(), rs.phase, rtol=0,
                               atol=FM_MOD_ATOL)
    ja, js = JM.fm_mod(x[:3000], FS, 2500.0, rf_hz=3000.0)
    jb, _ = JM.fm_mod(x[3000:], FS, 2500.0, rf_hz=3000.0, state=js)
    b, _ = PM.fm_mod(x[3000:], FS, 2500.0, rf_hz=3000.0,
                     state=convert.fm_state_from_fields(np_tree(js), CPU),
                     device=CPU)
    np.testing.assert_allclose(b.numpy(), jb, rtol=0, atol=FM_MOD_ATOL)


# ── demodulators ─────────────────────────────────────────────────────────────

def test_cw_demod_and_envelopes():
    z = iq_noisy(1)
    ref, ry = JD.cw_demod(z, FS, 300.0, 2.0, 0.5)
    got, gy = PD.cw_demod(z, FS, 300.0, 2.0, 0.5, device=CPU)
    close(ref, got)
    close(ry, gy)
    f = np.array([1300.0, 1500.0, -700.0], np.float32)
    ref = JD.cw_envelope_multi(z, FS, f, 100.0, 1000.0)
    got = PD.cw_envelope_multi(z, FS, f, 100.0, 1000.0, device=CPU)
    close(ref, got)


@pytest.mark.parametrize("method", ["power_sqrt", "abs_approx"])
def test_am_demod_and_state(method):
    z = iq_noisy(2)
    ref, rs = JD.am_demod(z, FS, 4000.0, method=method)
    got, gs = PD.am_demod(z, FS, 4000.0, method=method, device=CPU)
    close(ref, got)
    close(rs.dc, gs.dc)
    a, sa = PD.am_demod(z[:5000], FS, 4000.0, method=method, device=CPU)
    b, _ = PD.am_demod(z[5000:], FS, 4000.0, method=method, state=sa,
                       device=CPU)
    close(ref, torch.cat([a, b]))


def test_ssb_demod_and_state():
    z = iq_noisy(3)
    ref, rs = JD.ssb_demod(z, FS, 1500.0, 2700.0)
    got, gs = PD.ssb_demod(z, FS, 1500.0, 2700.0, device=CPU)
    close(ref, got)
    close(rs.bfo_phase, gs.bfo_phase, 0.0)
    ja, js = JD.ssb_demod(z[:3000], FS, 1500.0, 2700.0)
    jb, _ = JD.ssb_demod(z[3000:], FS, 1500.0, 2700.0, state=js)
    b, _ = PD.ssb_demod(z[3000:], FS, 1500.0, 2700.0,
                        state=convert.ssb_demod_state_from_fields(
                            np_tree(js), CPU), device=CPU)
    close(jb, b)


@pytest.mark.parametrize("translate", [None, 3000.0])
def test_fm_and_pm_demod(translate):
    iq, _ = JM.fm_mod(audio(), FS, 2500.0,
                      rf_hz=0.0 if translate is None else translate)
    ref, rs = JD.fm_demod(iq, FS, 2500.0, 5000.0, translate_hz=translate)
    got, gs = PD.fm_demod(iq, FS, 2500.0, 5000.0, translate_hz=translate,
                          device=CPU)
    close(ref, got)
    close(rs.prev, gs.prev, 0.0)
    close(rs.xlate_phase, gs.xlate_phase, 0.0)
    ref, _ = JD.pm_demod(iq, FS, 1.5, 5000.0)
    got, _ = PD.pm_demod(iq, FS, 1.5, 5000.0, device=CPU)
    close(ref, got)


def test_fm_demod_state_from_the_jax_package_continues_in_the_port():
    """Half a capture through the JAX demod, its state converted, the other
    half through the port: equal to one JAX call, and with a frequency
    translation carried too, equal to the JAX package's own second call
    (one call and two differ there by the rounding of the carried
    translation phase)."""
    iq, _ = JM.fm_mod(audio(), FS, 2500.0)
    ref, _ = JD.fm_demod(iq, FS, 2500.0, 5000.0)
    ja, js = JD.fm_demod(iq[:3001], FS, 2500.0, 5000.0)
    st = convert.quad_demod_state_from_fields(np_tree(js), CPU)
    b, _ = PD.fm_demod(iq[3001:], FS, 2500.0, 5000.0, state=st, device=CPU)
    close(ref, np.concatenate([ja, b.numpy()]))
    pa, ps = PD.fm_demod(iq[:3001], FS, 2500.0, 5000.0, device=CPU)
    pb, _ = PD.fm_demod(iq[3001:], FS, 2500.0, 5000.0, state=ps, device=CPU)
    close(ref, torch.cat([pa, pb]))
    iq, _ = JM.fm_mod(audio(), FS, 2500.0, rf_hz=3000.0)
    ja, js = JD.fm_demod(iq[:3001], FS, 2500.0, 5000.0, translate_hz=3000.0)
    jb, _ = JD.fm_demod(iq[3001:], FS, 2500.0, 5000.0, translate_hz=3000.0,
                        state=js)
    st = convert.quad_demod_state_from_fields(np_tree(js), CPU)
    b, _ = PD.fm_demod(iq[3001:], FS, 2500.0, 5000.0, translate_hz=3000.0,
                       state=st, device=CPU)
    close(jb, b)


def test_fm_tone_roundtrip_in_the_port():
    """tests/test_analog_roundtrip.py:20-26 in the port: > 20 dB."""
    iq, _ = PM.fm_mod(audio(1000.0, 0.5, 32_768), FS, 2500.0, device=CPU)
    out, _ = PD.fm_demod(iq, FS, 2500.0, 5000.0, device=CPU)
    assert tone_snr_db(FS, 1000.0, tail(out.numpy(), 0.75)) > 20.0


def test_band_demods_raise_naming_their_slice():
    """The whole-band AM and SSB receivers (slice 5a: they no longer
    raise) against the JAX package on one capture each: explicit centers,
    the same stations, audio within 1e-5 of its peak (the SSB case with
    tests/test_fm_broadcast.py's three USB channels and its LSB sense)."""
    fs = 480_000.0
    n = 1 << 17
    t = np.arange(n) / fs
    rng = np.random.default_rng(0)

    def noise(scale):
        return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
                * scale).astype(np.complex64)

    def ssb(f_audio, dial, usb=True):
        a = (0.5 * np.sin(2 * np.pi * f_audio * t)).astype(np.float32)
        iq, _ = JM.ssb_mod(a, fs, 2800.0, 1500.0, 0.0, usb=usb)
        return np.asarray(JO.rotate(np.asarray(iq), dial, fs)[0])

    def am(f_audio, center, gain):
        a = (0.6 * np.sin(2 * np.pi * f_audio * t)).astype(np.float32)
        iq, _ = JM.am_mod(a, fs)
        return gain * np.asarray(JO.rotate(np.asarray(iq), center, fs)[0])

    dials = [-150e3, 10e3, 120e3]
    band = (ssb(1200, dials[0]) + ssb(800, dials[1]) + ssb(500, dials[2])
            + noise(0.005)).astype(np.complex64)
    lsb = (ssb(900, -40e3, usb=False) + noise(0.005)).astype(np.complex64)
    am_band = (am(800, -150e3, 1.0) + am(1500, 40e3, 0.6)
               + noise(0.01)).astype(np.complex64)
    cases = [(JD.ssb_band_demod, PD.ssb_band_demod, band, dials, {}),
             (JD.ssb_band_demod, PD.ssb_band_demod, lsb, [-40e3],
              {"usb": False}),
             (JD.am_band_demod, PD.am_band_demod, am_band, [-150e3, 40e3],
              {})]
    for jfn, pfn, capture, centers, kw in cases:
        want = jfn(capture, fs, centers, **kw)
        got = pfn(capture, fs, centers, device=CPU, **kw)
        assert [s.center_hz for s in got] == [s.center_hz for s in want]
        assert len(got) == len(centers)
        for g, w in zip(got, want):
            assert g.fs_audio == w.fs_audio
            close(w.audio, g.audio)
    stations = PD.ssb_band_demod(band, fs, dials, device=CPU)
    for s, f_a in zip(stations, (1200, 800, 500)):
        seg = s.audio.numpy()[int(0.12 * s.fs_audio):]
        assert tone_snr_db(s.fs_audio, f_a, seg) > 20.0, s.center_hz
    assert PD.am_band_demod(am_band, fs, [], device=CPU) == []
