"""Torch port, POCSAG and AIS (codec/pocsag.py, modulate/pocsag.py,
demodulate/pocsag.py, codec/ais.py, modulate/ais.py, demodulate/ais.py)
against the JAX package on the CPU, with the same numpy inputs.

Tolerances: exact for BCH(31,21) codewords, syndrome correction, batch
layouts (sync, idle, frame slots), page decoding, AIS payload fields,
HDLC frames, hard bit streams and the decoded pages and positions. The
FSK and GMSK IQ within 8 float32 ulps of the burst's final phase: the
port sums the float32 phase steps in float64 and rounds once, XLA's
cumsum is a float32 tree (measured 4.6e-5 on a POCSAG page, 1.1e-5 on
an AIS burst)."""

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
from orion_sdr_tpu.codec import ais as JA
from orion_sdr_tpu.codec import pocsag as JP
from orion_sdr_tpu.demodulate import ais as JDA
from orion_sdr_tpu.demodulate import pocsag as JDP
from orion_sdr_tpu.modulate import ais as JMA
from orion_sdr_tpu.modulate import pocsag as JMP

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch.codec import ais as PA
from orion_sdr_tpu_torch.codec import pocsag as PP
from orion_sdr_tpu_torch.demodulate import ais as PDA
from orion_sdr_tpu_torch.demodulate import pocsag as PDP
from orion_sdr_tpu_torch.modulate import ais as PMA
from orion_sdr_tpu_torch.modulate import pocsag as PMP

torch.set_num_threads(1)
CPU = "cpu"
FS_P = 38_400.0
FS_A = 96_000.0
PAGES = [dict(address=0x12345, function=3, text="CALL HOME ASAP"),
         dict(address=0x00FA7, function=0, digits="5551234 88")]
SHIPS = [dict(mmsi=211234567, lat=53.5421, lon=9.9845, sog_kt=12.3,
              cog_deg=87.5, heading_deg=88, nav_status=0),
         dict(mmsi=244000111, lat=-33.8568, lon=151.2153, sog_kt=0.2,
              cog_deg=310.0, msg_type=3)]


def iq_close(got, ref, fs, f_max):
    ph = 2 * np.pi * f_max * len(ref) / fs
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 8 * float(np.spacing(np.float32(ph)))


def test_pocsag_codewords_exact():
    rng = np.random.default_rng(0)
    for _ in range(50):
        flag, pay = int(rng.integers(0, 2)), int(rng.integers(0, 1 << 20))
        cw = PP.pocsag_codeword(flag, pay)
        assert cw == JP.pocsag_codeword(flag, pay)
        for bad in (cw, cw ^ (1 << int(rng.integers(0, 32))),
                    cw ^ 0b101 << int(rng.integers(0, 29))):
            assert PP.pocsag_check(bad) == JP.pocsag_check(bad)
    assert PP.pocsag_check(JP.POCSAG_SYNC) == JP.pocsag_check(JP.POCSAG_SYNC)


def test_pocsag_batches_and_words_exact():
    pp = [P.PocsagPage(**d) for d in PAGES]
    jp = [J.PocsagPage(**d) for d in PAGES]
    words = PP.pocsag_encode_batches(pp)
    assert words == JP.pocsag_encode_batches(jp)
    slots = [PP.pocsag_check(w) for i, w in enumerate(words) if i % 17]
    got = PP.pocsag_decode_words(slots)
    assert [vars(g) for g in got] == [vars(g) for g in
                                      JP.pocsag_decode_words(slots)]
    assert [vars(g) for g in got] == [vars(p) for p in pp]


def test_pocsag_roundtrip_across_packages():
    pp = [P.PocsagPage(**d) for d in PAGES]
    p_iq = P.pocsag_mod(pp, FS_P, device=CPU)
    j_iq = J.pocsag_mod([J.PocsagPage(**d) for d in PAGES], FS_P)
    iq_close(p_iq, j_iq, FS_P, 4500.0)
    assert np.array_equal(PDP.pocsag_demod_bits(j_iq, FS_P, device=CPU),
                          JDP.pocsag_demod_bits(j_iq, FS_P))
    assert P.pocsag_decode(j_iq, FS_P, device=CPU) == pp
    assert [vars(g) for g in J.pocsag_decode(p_iq.numpy(), FS_P)] == \
        [vars(p) for p in pp]
    # inverted discriminator and noise (tests/test_pocsag.py)
    rng = np.random.default_rng(0)
    z = np.conj(j_iq) + ((rng.standard_normal(len(j_iq)) + 1j
                          * rng.standard_normal(len(j_iq))).astype(
                              np.complex64) * 0.15)
    got = P.pocsag_decode(z, FS_P, device=CPU)
    assert [vars(g) for g in got] == [vars(g) for g in
                                      J.pocsag_decode(z, FS_P)]
    assert got == pp
    assert P.pocsag_decode(np.zeros(1000, np.complex64), FS_P,
                           device=CPU) == []
    with pytest.raises(ValueError):
        P.pocsag_mod(pp, 8000.0, device=CPU)


def test_fsk_iq_matches():
    bits = np.random.default_rng(3).integers(0, 2, 300).astype(np.uint8)
    ref = np.asarray(JMP._fsk_iq(bits, FS_P, 32.0, 4500.0, 9600))
    iq_close(PMP._fsk_iq(bits, FS_P, 32.0, 4500.0, 9600, device=CPU), ref,
             FS_P, 4500.0)


def test_ais_payloads_exact():
    for d in SHIPS + [dict(mmsi=1, lat=0.0, lon=0.0)]:
        bits = PA.ais_encode_position(P.AisPosition(**d))
        assert np.array_equal(bits, JA.ais_encode_position(
            J.AisPosition(**d)))
        assert vars(PA.ais_parse(bits)) == vars(JA.ais_parse(bits))
        assert PA.ais_payload_to_bytes(bits) == JA.ais_payload_to_bytes(bits)
    bad = bits.copy()
    bad[:6] = [0, 0, 0, 1, 0, 1]
    assert PA.ais_parse(bad) is None
    payloads = [PA.ais_encode_position(P.AisPosition(**d)) for d in SHIPS]
    stream = PA.ais_frames_to_bits(payloads)
    assert np.array_equal(stream, JA.ais_frames_to_bits(payloads))
    got = PA.ais_bits_to_positions(stream)
    assert [vars(g) for g in got] == [
        vars(g) for g in JA.ais_bits_to_positions(stream)]
    stream[60] ^= 1
    assert len(PA.ais_bits_to_positions(stream)) == 1


def test_gmsk_iq_matches():
    line = np.random.default_rng(4).integers(0, 2, 200).astype(np.uint8)
    taps = JMA._gauss_taps(FS_A, 9600.0, 0.4)
    assert np.array_equal(PMA._gauss_taps(FS_A, 9600.0, 0.4), taps)
    ref = np.asarray(JMA._gmsk_iq(line, FS_A, 10.0, 2400.0,
                                  tuple(taps.tolist()), 2000))
    iq_close(PMA._gmsk_iq(line, FS_A, 10.0, 2400.0, taps, 2000, device=CPU),
             ref, FS_A, 2400.0)


def test_ais_roundtrip_across_packages():
    ps = [P.AisPosition(**d) for d in SHIPS]
    p_iq = P.ais_mod(ps, device=CPU)
    j_iq = J.ais_mod([J.AisPosition(**d) for d in SHIPS])
    iq_close(p_iq, j_iq, FS_A, 2400.0)
    lead = np.zeros(500, np.complex64)
    z = np.concatenate([lead, j_iq])
    assert np.array_equal(PDA.ais_demod_bits(z, FS_A, device=CPU),
                          JDA.ais_demod_bits(z, FS_A))
    assert P.ais_decode(z, FS_A, device=CPU) == ps
    assert [vars(g) for g in J.ais_decode(np.concatenate(
        [lead, p_iq.numpy()]), FS_A)] == [vars(p) for p in ps]
    rng = np.random.default_rng(1)
    zn = j_iq + ((rng.standard_normal(len(j_iq)) + 1j * rng.standard_normal(
        len(j_iq))).astype(np.complex64) * np.sqrt(1.0 / 10 / 2))  # 10 dB
    assert P.ais_decode(zn, FS_A, device=CPU) == ps
    assert P.ais_decode(np.zeros(50_000, np.complex64), FS_A,
                        device=CPU) == []
    with pytest.raises(ValueError):
        P.ais_mod(ps, fs=19_200.0, device=CPU)
