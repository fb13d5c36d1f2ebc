"""Torch port, chirp spread spectrum (modulate/css.py, demodulate/css.py)
against the JAX package on the CPU, with the same numpy inputs.

Tolerances: exact for symbols, payloads, CRC flags and the None cases
wherever the JAX package decodes (two of its faults are not copied, see
the last two tests);
the frame IQ within 2e-3 absolute (its phase is a cumulative sum the port
forms in float64 and rounds once, XLA as a float32 tree: measured 3.4e-4
rad at 20 000 samples); the dechirped |FFT| within 1e-5 of its peak (the
two FFTs round apart); the SNR estimate within 0.05 dB. Every receive
case carries noise: see test_css_roundtrip_unknown_offset_matches."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.demodulate import css as JD
from orion_sdr_tpu.dsp.osc import rotate as jrotate
from orion_sdr_tpu.modulate import css as JM

from orion_sdr_tpu_torch.demodulate import css as PD
from orion_sdr_tpu_torch.modulate import css as PM

torch.set_num_threads(1)
CPU = "cpu"
MSG = b"hello chirp world"
IQ_ATOL = 2e-3


def _same_frame(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        assert got.payload == want.payload and got.crc_ok == want.crc_ok
        assert got.snr_db == pytest.approx(want.snr_db, abs=0.05)


@pytest.mark.parametrize("sf,fs", [(7, None), (9, 250_000.0)])
def test_css_mod_matches(sf, fs):
    ref = np.asarray(JM.css_mod(MSG, sf=sf, fs=fs))
    got = PM.css_mod(MSG, sf=sf, fs=fs, device=CPU).numpy()
    assert got.shape == ref.shape and got.dtype == np.complex64
    assert float(np.abs(got - ref).max()) <= IQ_ATOL
    assert np.array_equal(PM._chirp_phase(sf, 125e3, fs or 125e3, 5, True),
                          JM._chirp_phase(sf, 125e3, fs or 125e3, 5, True))
    assert PM.css_samples_per_symbol(sf, 125e3, fs or 125e3) == \
        JM.css_samples_per_symbol(sf, 125e3, fs or 125e3)


def test_dechirp_fft_matches():
    rng = np.random.default_rng(4)
    sf, n_sym = 8, 12
    spsym = 2 << sf                                  # fs = 2·bw
    z = (rng.standard_normal(n_sym * spsym + 100)
         + 1j * rng.standard_normal(n_sym * spsym + 100)).astype(np.complex64)
    re, im = JD._base(sf, 125e3, 250e3)
    ref = np.asarray(JD._dechirp_fft(z, re, im, n_sym, spsym, 1 << sf))
    base = PD._base_tensor(sf, 125e3, 250e3, False, CPU)
    got = PD._dechirp_fft(torch.as_tensor(z), base, n_sym, spsym,
                          1 << sf).numpy()
    assert got.shape == ref.shape == (n_sym, 1 << sf)
    assert float(np.abs(got - ref).max()) <= 1e-5 * float(ref.max())


def _awgn(z, snr_db, seed):
    rng = np.random.default_rng(seed)
    return (z + (rng.standard_normal(len(z)) + 1j * rng.standard_normal(
        len(z))) * np.sqrt(10 ** (-snr_db / 10) / 2)).astype(np.complex64)


@pytest.mark.parametrize("sf", [7, 9])
def test_css_roundtrip_unknown_offset_matches(sf):
    """tests/test_css.py's roundtrip (777 zeros before the frame) at 10 dB.
    Without noise the offset search is a tie: every sub-symbol offset
    dechirps the repeated preamble upchirps to a pure tone, each scored
    as its peak over a median of rounding residue (~3e6), so which offset
    wins is decided by rounding, in either package (at SF9 the port's
    rounding picks an offset whose preamble run starts one window early
    and its payload fails its CRC; the JAX package's picks one that
    decodes)."""
    iq = np.asarray(JM.css_mod(MSG, sf=sf))
    buf = _awgn(np.concatenate([np.zeros(777, np.complex64), iq,
                                np.zeros(500, np.complex64)]), 10.0, sf)
    want = JD.css_demod(buf, sf=sf)
    got = PD.css_demod(buf, sf=sf, device=CPU)
    _same_frame(got, want)
    assert got.crc_ok and got.payload == MSG


def test_css_below_noise_floor_matches():
    """SF9 at −5 dB IQ SNR (tests/test_css.py), two seeds."""
    iq = np.asarray(JM.css_mod(MSG, sf=9))
    for seed in range(2):
        z = _awgn(np.concatenate([np.zeros(300, np.complex64), iq]), -5.0,
                  seed)
        got = PD.css_demod(z, sf=9, device=CPU)
        _same_frame(got, JD.css_demod(z, sf=9))
        assert got is not None and got.payload == MSG and got.crc_ok


def test_css_crc_guard_and_silence_match():
    iq = np.asarray(JM.css_mod(MSG, sf=7)).copy()
    spsym = PM.css_samples_per_symbol(7, 125_000.0, 125_000.0)
    k = (8 + 2 + 3) * spsym
    iq[k:k + 2 * spsym] = 0                  # two payload symbols gone
    iq = _awgn(iq, 10.0, 1)
    got = PD.css_demod(iq, sf=7, device=CPU)
    _same_frame(got, JD.css_demod(iq, sf=7))
    assert got is None or not got.crc_ok or got.payload == MSG
    assert PD.css_demod(np.zeros(200_000, np.complex64), sf=7,
                        device=CPU) is None
    assert PD.css_demod(np.zeros(100, np.complex64), sf=7,
                        device=CPU) is None
    with pytest.raises(ValueError):
        PM.css_mod(b"x", sf=4, device=CPU)
    with pytest.raises(ValueError):
        PM.css_mod(b"x", sf=7, fs=100_000.0, device=CPU)


def test_css_whole_pad_byte_is_not_payload():
    """At SF 10 the 19 CRC'd bytes pad to 16 symbols with a whole zero
    byte. The JAX receiver tries the longer count first, and it passes
    the CRC falsely (a CRC-16 with no final XOR gives message + first CRC
    byte the checksum "second CRC byte, 0x00"), so it returns the message
    and one extra byte with crc_ok; the port returns the message."""
    iq = np.asarray(JM.css_mod(MSG, sf=10))
    buf = _awgn(np.concatenate([np.zeros(777, np.complex64), iq,
                                np.zeros(500, np.complex64)]), 10.0, 0)
    want = JD.css_demod(buf, sf=10)
    assert want.crc_ok and want.payload == MSG + b"\x95"
    got = PD.css_demod(buf, sf=10, device=CPU)
    assert got.crc_ok and got.payload == MSG
    assert got.snr_db == pytest.approx(want.snr_db, abs=0.05)


def test_css_relocks_from_the_sync_symbols():
    """The offset search scores the preamble alone, and the repeated
    upchirps dechirp to a pure tone at every offset, so the winning lock
    can sit up to half a symbol off; at SF 7 with a −1.5 kHz carrier
    offset (10 dB) the JAX receiver's payload fails its CRC there. The
    port re-times that lock from the preamble's up bin and the sync
    symbols' down bin and decodes."""
    iq = np.asarray(jrotate(np.asarray(JM.css_mod(MSG, sf=7)), -1500.0,
                            125e3)[0])
    buf = _awgn(np.concatenate([np.zeros(777, np.complex64), iq,
                                np.zeros(500, np.complex64)]), 10.0, 0)
    want = JD.css_demod(buf, sf=7)
    assert want is None or not want.crc_ok or want.payload != MSG
    got = PD.css_demod(buf, sf=7, device=CPU)
    assert got is not None and got.crc_ok and got.payload == MSG
