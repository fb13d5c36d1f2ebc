"""Torch port, Morse (codec/morse.py) against the JAX package on the CPU,
with the same numpy inputs: the captures of tests/test_morse_decode.py,
keyed by the JAX package's cw_mod (the port's cw_mod runs its per-step
plain loop on the CPU; its keying is held to the JAX one in
tests/test_torch_analog.py and on the card by chip_smoke [44]).

Tolerances: exact for the keying envelope (with and without jitter, every
fist setting), the decoded texts and the picked tones; wpm and the
carrier scores within 1e-9 relative (both are host float64 arithmetic on
the same run lengths and the same host Welch spectrum of the same
capture; measured equal)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.codec import morse as PM

from tests.test_torch_dsp_iir import jrun

torch.set_num_threads(1)
CPU = "cpu"
FS = 8000.0
N_SINGLE = int(FS * 10)
N_BAND = int(FS * 14)


def _cw(text, wpm, tone, jitter=0.0, amp=1.0, dash_weight=3.0,
        char_space=3.0):
    enc = J.MorseEncoder(FS, wpm)
    if jitter:
        enc.with_jitter(jitter)
    enc.with_dash_weight(dash_weight).with_char_space(char_space)
    env = enc.encode_text(text)
    iq, _ = jrun(J.cw_mod, env, FS, tone)
    return amp * np.asarray(iq)


def _embed(iq, n, start, noise_rms=0.0, seed=0):
    rng = np.random.default_rng(seed)
    buf = np.zeros(n, np.complex64)
    if noise_rms:
        s = noise_rms / np.sqrt(2.0)
        buf += (rng.normal(0, s, n) + 1j * rng.normal(0, s, n)).astype(
            np.complex64)
    buf[start:start + len(iq)] += iq[: n - start]
    return buf


@pytest.mark.parametrize("wpm,jitter,dash,cs,ws,text", [
    (20.0, 0.0, 3.0, 3.0, 7.0, "PARIS PARIS"),
    (25.0, 10.0, 3.0, 3.0, 7.0, "CQ TEST  DE KA1ABC/P 599 #?"),
    (22.0, 20.0, 3.5, 4.0, 9.0, "THE QUICK BROWN FOX 73"),
    (60.0, 30.0, 2.5, 2.5, 6.0, "E#E  @=+"),
])
def test_encoder_keying_bit_equal(wpm, jitter, dash, cs, ws, text):
    def env(mod):
        e = mod.MorseEncoder(FS, wpm).with_jitter(jitter)
        e.with_dash_weight(dash).with_char_space(cs).with_word_space(ws)
        return e.encode_text(text), e.encode_text(text), e.rng
    ref, got = env(J), env(PM)
    for a, b in zip(ref[:2], got[:2]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert ref[2] == got[2]
    assert PM.MORSE_TABLE == J.codec.morse.MORSE_TABLE


def _same_band(ref, got):
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert g.text == r.text and g.tone_hz == r.tone_hz
        assert g.wpm == pytest.approx(r.wpm, rel=1e-9)
        assert g.score_db == pytest.approx(r.score_db, rel=1e-9)


@pytest.fixture(scope="module")
def singles():
    """The single-signal captures of tests/test_morse_decode.py with the
    tone each decodes at (None: auto)."""
    caps = []
    for wpm, text in ((10.0, "CQ TEST"), (20.0, "CQ DE KA1ABC K"),
                      (40.0, "THE QUICK BROWN FOX 599")):
        caps.append((_embed(_cw(text, wpm, 700.0), N_SINGLE, int(FS * 0.5)),
                     700.0, text))
    caps.append((_embed(_cw("PARIS PARIS 73", 22.0, 650.0, jitter=20.0,
                            dash_weight=3.5, char_space=4.0), N_SINGLE,
                        int(FS * 0.3)), 650.0, "PARIS PARIS 73"))
    hello = _embed(_cw("HELLO WORLD", 18.0, 833.0), N_SINGLE, int(FS * 0.8))
    caps += [(hello, None, "HELLO WORLD"), (hello, 863.0, "HELLO WORLD")]
    caps.append((_embed(_cw("CQ DX DE W1AW", 20.0, 700.0, amp=0.25),
                        N_SINGLE, int(FS * 0.5), noise_rms=0.25, seed=3),
                 700.0, "CQ DX DE W1AW"))
    return caps


def test_morse_decode_matches(singles):
    for buf, tone, text in singles:
        ref = J.morse_decode(buf, FS, tone)
        assert ref == text
        assert P.morse_decode(buf, FS, tone, device=CPU) == ref


def test_morse_decode_band_three_signals_matches():
    sigs = (("CQ DX", 15.0, 500.0, 1.0), ("HELLO WORLD", 28.0, 900.0, 0.3),
            ("73 GL", 35.0, 1300.0, 0.1))
    rng = np.random.default_rng(11)
    buf = _embed(np.zeros(0, np.complex64), N_BAND, 0, noise_rms=0.028,
                 seed=11)
    for text, wpm, tone, amp in sigs:
        iq = _cw(text, wpm, tone, jitter=10.0, amp=amp)
        s = int(rng.integers(0, FS))
        buf[s:s + len(iq)] += iq[: N_BAND - s]
    ref = J.morse_decode_band(buf, FS, 400.0, 1500.0)
    got = P.morse_decode_band(buf, FS, 400.0, 1500.0, device=CPU)
    assert sorted(r.text for r in ref) == sorted(s[0] for s in sigs)
    _same_band(ref, got)


def test_morse_decode_band_sideband_rejection_matches():
    buf = _embed(_cw("CQ CQ DE KA1ABC K", 20.0, 800.0, amp=3.0),
                 N_BAND, int(FS * 0.5), noise_rms=0.01, seed=5)
    ref = J.morse_decode_band(buf, FS, 400.0, 1500.0)
    got = P.morse_decode_band(buf, FS, 400.0, 1500.0, device=CPU)
    assert len(ref) == 1
    _same_band(ref, got)


def test_morse_decode_edges_match():
    t = np.arange(N_SINGLE) / FS
    tone = np.exp(2j * np.pi * 700.0 * t).astype(np.complex64)
    for buf, tone_hz in ((np.zeros(0, np.complex64), None),
                         (np.zeros(4096, np.complex64), None),
                         (tone, 700.0)):
        assert P.morse_decode(buf, FS, tone_hz, device=CPU) == \
            J.morse_decode(buf, FS, tone_hz) == ""
    z = np.zeros(8192, np.complex64)
    assert P.morse_decode_band(z, FS, 400.0, 1500.0, device=CPU) == \
        J.morse_decode_band(z, FS, 400.0, 1500.0) == []
    # non-finite samples are blanked before the spectrum, as in the JAX
    # package (sanitize_iq)
    bad = np.zeros(8192, np.complex64)
    bad[100:200] = np.nan
    assert P.morse_decode(bad, FS, device=CPU) == J.morse_decode(bad, FS)
