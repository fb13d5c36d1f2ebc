"""Torch port, the rest of slice 4's DSP layer against the JAX package on the
CPU: util.py (the numpy helpers equal, ``atan2_approx`` equal bit for bit:
the same float32 operations in the same order; ``spectrum_scan``'s
segments), dsp/osc.py (oscillator, per-row rotate, mix_usb), the rest of
dsp/fir.py (designs equal; filtering, decimation, the per-signal bank and
``numpy.convolve``'s 'same'/'valid' on odd and even kernels), dsp/agc.py
(both branches) and dsp/resample.py (one shot, and the streaming
Resampler's chunk invariance).

Tolerance for float outputs: 1e-5 of the output's largest magnitude (the
port's convolutions, FFTs and scans sum in another order than XLA's;
measured at most 6e-7). The two-rate AGC envelope runs through the
two-rate one-pole kernel's plain version on the CPU, which is held exact
against a plain numpy loop of the same float32 operations."""

import importlib

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dsp_iir import close, jrun

import orion_sdr_tpu.util as JU
import orion_sdr_tpu_torch.util as PU
from orion_sdr_tpu_torch.dsp import agc as PA
from orion_sdr_tpu_torch.dsp import fir as PF
from orion_sdr_tpu_torch.dsp import osc as PO
from orion_sdr_tpu_torch.ops.onepole_two_rate import (
    onepole_two_rate, onepole_two_rate_reference)

PRS = importlib.import_module("orion_sdr_tpu_torch.dsp.resample")
JA = importlib.import_module("orion_sdr_tpu.dsp.agc")
JF = importlib.import_module("orion_sdr_tpu.dsp.fir")
JO = importlib.import_module("orion_sdr_tpu.dsp.osc")
JRS = importlib.import_module("orion_sdr_tpu.dsp.resample")

torch.set_num_threads(1)
CPU = "cpu"


def sig(shape, seed, cplx=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.standard_normal(shape)).astype(np.complex64)
    return x


# ── util ─────────────────────────────────────────────────────────────────────

def test_numpy_helpers_equal():
    x = sig(3000, 1)
    z = sig(3000, 2, cplx=True)
    assert PU.rms(x) == JU.rms(x) and PU.rms(torch.as_tensor(z)) == JU.rms(z)
    assert np.array_equal(PU.hann(64), JU.hann(64))
    assert np.array_equal(PU.tone(8000.0, 700.0, 500, 0.3),
                          JU.tone(8000.0, 700.0, 500, 0.3))
    assert np.array_equal(PU.gen_complex_tone(8000.0, -300.0, 500),
                          JU.gen_complex_tone(8000.0, -300.0, 500))
    assert PU.snr_db_at(8000.0, 700.0, x) == JU.snr_db_at(8000.0, 700.0, x)
    for s in (x, z):
        a, b = PU.power_spectrum(s, 8000.0), JU.power_spectrum(s, 8000.0)
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
        assert PU.nb_spectrum_snr_db(s, 8000.0, 1000.0) == \
            JU.nb_spectrum_snr_db(s, 8000.0, 1000.0)
        assert PU.wb_spectrum_snr_db(s, 8000.0, 1000.0, 500.0) == \
            JU.wb_spectrum_snr_db(s, 8000.0, 1000.0, 500.0)
        assert PU.spectrum_bw_hz(s, 8000.0, 1000.0) == \
            JU.spectrum_bw_hz(s, 8000.0, 1000.0)
    assert np.array_equal(PU.awgn(np.random.default_rng(3), (4, 5), 0.5),
                          JU.awgn(np.random.default_rng(3), (4, 5), 0.5))
    assert np.array_equal(
        PU.awgn(np.random.default_rng(3), 7, 0.5, complex_=False),
        JU.awgn(np.random.default_rng(3), 7, 0.5, complex_=False))


def test_atan2_approx_equal_bit_for_bit():
    y, x = sig(20000, 4), sig(20000, 5)
    y[:6] = [0.0, -0.0, 1.0, -1.0, 0.0, 2.0]
    x[:6] = [0.0, 1.0, -0.0, 0.0, -3.0, 2.0]
    ref = np.asarray(JU.atan2_approx(y, x))
    got = PU.atan2_approx(torch.as_tensor(y), torch.as_tensor(x)).numpy()
    assert np.array_equal(ref, got)


def test_spectrum_scan_segments():
    fs = 1e6
    n = 1 << 16
    k = np.arange(n)
    z = (0.01 * sig(n, 6, cplx=True)
         + np.exp(2j * np.pi * 100e3 * k / fs)
         + 0.3 * np.exp(2j * np.pi * -200e3 * k / fs)).astype(np.complex64)
    ref = JU.spectrum_scan(z, fs)
    got = PU.spectrum_scan(z, fs, device=CPU)
    assert len(got) == len(ref) == 2
    for a, b in zip(got, ref):
        assert abs(a.center_hz - b.center_hz) < 1.0
        assert a.bw_hz == b.bw_hz
        assert abs(a.power_db - b.power_db) < 1e-3


# ── osc ──────────────────────────────────────────────────────────────────────

def test_oscillator_and_mix_usb():
    """A scalar phase: product and sum rounded apart (the JAX ramp run
    eagerly); a carried per-row phase: one rounding (the JAX package's
    jitted callers fuse it into a multiply-add)."""
    ref, rph = JO.oscillator(1000.0, 8000.0, 300, 0.3)
    got, gph = PO.oscillator(1000.0, 8000.0, 300, 0.3, device=CPU)
    close(ref, got, 0.0)
    assert np.float32(rph) == np.float32(gph)
    z = sig((2, 1000), 7, cplx=True)
    ph0 = np.array([0.1, 0.2], np.float32)
    ref, rph = jrun(JO.mix_usb, z, 700.0, 8000.0, ph0)
    got, gph = PO.mix_usb(torch.as_tensor(z), 700.0, 8000.0,
                          torch.as_tensor(ph0))
    close(ref, got)
    close(rph, gph, 0.0)
    ref, _ = JO.mix_usb_host(z, np.float32(700.0), 8000.0)
    got, _ = PO.mix_usb_host(torch.as_tensor(z), np.float32(700.0), 8000.0)
    close(ref, got)


def test_rotate_per_row_frequencies():
    z = sig(1000, 8, cplx=True)
    f = np.array([100.0, -250.5, 1234.25], np.float32)
    ref, rph = jrun(lambda z, f: JO.rotate(z[None, :], -f[:, None], 8000.0),
                    z, f)
    got, gph = PO.rotate(torch.as_tensor(z)[None, :],
                         -torch.as_tensor(f)[:, None], 8000.0)
    close(ref, got)
    close(rph, gph, 0.0)


# ── fir ──────────────────────────────────────────────────────────────────────

def test_fir_designs_equal():
    for args in ((8000.0, 1000.0, 300.0), (48000.0, 3000.0, 100.0),
                 (8000.0, 5.0, 1.0)):
        assert np.array_equal(PF.fir_lowpass_design(*args),
                              JF.fir_lowpass_design(*args))
    for sps in (0, 1, 2, 256, 384):
        assert np.array_equal(PF.half_cosine_taps(sps),
                              JF.half_cosine_taps(sps))


@pytest.mark.parametrize("cplx", [False, True])
def test_fir_apply_with_state_and_decimate(cplx):
    taps = JF.fir_lowpass_design(8000.0, 1000.0, 300.0)
    x = sig((2, 1000), 9, cplx)
    ref, rst = jrun(lambda x: JF.fir_apply(x, taps), x)
    got, gst = PF.fir_apply(torch.as_tensor(x), taps)
    close(ref, got)
    close(rst, gst, 0.0)
    a, st = PF.fir_apply(torch.as_tensor(x[:, :333]), taps)
    b, _ = PF.fir_apply(torch.as_tensor(x[:, 333:]), taps, st)
    close(ref, torch.cat([a, b], dim=-1))
    ref, _ = jrun(lambda x: JF.fir_decimate(x, taps, 4), x)
    got, _ = PF.fir_decimate(torch.as_tensor(x), taps, 4)
    close(ref, got)


def test_fir_filter_aligned_bank():
    taps = [JF.fir_lowpass_design(8000.0, 1000.0, 300.0),
            JF.half_cosine_taps(31), np.array([0.2, 0.6, 0.2], np.float32)]
    xs = [sig(1000, 10), sig(1000, 11, cplx=True), sig(1000, 12)]
    ref = JF.fir_filter_aligned_bank(list(zip(xs, taps)))
    got = PF.fir_filter_aligned_bank([(torch.as_tensor(x), t)
                                      for x, t in zip(xs, taps)])
    for r, g in zip(ref, got):
        close(r, g)


@pytest.mark.parametrize("T", [8, 9, 256])
def test_convolve_same_and_valid_as_numpy(T):
    """jnp.convolve flips the kernel and centres 'same' by numpy's rule;
    the even lengths are where a centring off by one would show."""
    k = sig(T, 13)
    z = sig(1000, 14, cplx=True)
    for mode in ("same", "valid"):
        ref = jax.jit(lambda a, b: jnp.convolve(a, b, mode=mode))(z, k)
        close(ref, PF.convolve(torch.as_tensor(z), k, mode))
        close(np.convolve(z.real, k, mode), PF.convolve(
            torch.as_tensor(z.real.copy()), k, mode))


# ── agc ──────────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("attack,release", [(5.0, 50.0), (20.0, 20.0)])
def test_agc_rms_both_branches(cplx, attack, release):
    p = JA.design_agc(8000.0, attack, release, 0.3)
    assert PA.design_agc(8000.0, attack, release, 0.3) == p
    x = sig((2, 800), 15, cplx)
    ref, renv = jrun(JA.agc_rms, x, p)
    got, genv = PA.agc_rms(torch.as_tensor(x), p)
    close(ref, got)
    close(renv, genv)
    env0 = np.array([0.5, 2.0], np.float32)
    ref, renv = jrun(JA.agc_rms, x, p, env0)
    got, genv = PA.agc_rms(torch.as_tensor(x), p, torch.as_tensor(env0))
    close(ref, got)
    close(renv, genv)


@pytest.mark.parametrize("ge", [False, True])
def test_two_rate_plain_version_is_a_float32_loop(ge):
    """The kernel's plain version (the CPU path) equals a numpy loop of
    the same float32 operations bit for bit: a·env and b·x rounded apart,
    then added, with the pole chosen by x > env (or x >= env)."""
    rng = np.random.default_rng(16)
    x = rng.uniform(0, 1, (3, 500)).astype(np.float32)
    x[:, 100:140] = 0.25                          # ties with the envelope
    env0 = np.array([0.0, 0.25, 1.0], np.float32)
    a_hi, a_lo = 0.9, 0.99
    env, last = onepole_two_rate(torch.as_tensor(x), torch.as_tensor(env0),
                                 a_hi, a_lo, ge)
    e = env0.copy()
    ah, al = np.float32(a_hi), np.float32(a_lo)
    for i in range(x.shape[1]):
        hi = x[:, i] >= e if ge else x[:, i] > e
        a = np.where(hi, ah, al)
        b = np.where(hi, np.float32(1) - ah, np.float32(1) - al)
        e = (a * e).astype(np.float32) + (b * x[:, i]).astype(np.float32)
        assert np.array_equal(env[:, i].numpy(), e)
    assert np.array_equal(last.numpy(), e)
    again, _ = onepole_two_rate_reference(torch.as_tensor(x),
                                          torch.as_tensor(env0), a_hi, a_lo,
                                          ge)
    assert torch.equal(again, env)


# ── resample ─────────────────────────────────────────────────────────────────

@pytest.mark.parametrize("up,down", [(3, 2), (2, 3), (147, 160)])
def test_resample_and_streaming_chunk_invariance(up, down):
    assert np.array_equal(PRS.resample_taps(up, down),
                          JRS.resample_taps(up, down))
    x = sig((2, 700), 17, cplx=(up == 3))
    ref = jrun(JRS.resample, x, up, down)
    got = PRS.resample(torch.as_tensor(x), up, down)
    close(ref, got)
    jr, pr, one = JRS.Resampler(up, down), PRS.Resampler(up, down), \
        PRS.Resampler(up, down)
    ref = np.concatenate([jr.feed(x[:, i:i + 97]) for i in range(0, 700, 97)]
                         + [jr.flush()], axis=-1)
    got = torch.cat([pr.feed(torch.as_tensor(x[:, i:i + 97]))
                     for i in range(0, 700, 97)] + [pr.flush()], dim=-1)
    close(ref, got)
    whole = torch.cat([one.feed(torch.as_tensor(x)), one.flush()], dim=-1)
    close(whole, got)
