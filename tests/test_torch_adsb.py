"""Torch port, ADS-B 1090ES (codec/adsb.py, modulate/adsb.py,
demodulate/adsb.py) against the JAX package on the CPU, with the same
numpy inputs.

Tolerances: exact for the CRC-24, the CPR encode and global decode, the
three DF17 encoders, the frame decode (the published real-world frame
included), the PPM chips and the modulated capture, and the decoded
message lists (every field, positions included). The preamble score, a
float32 quotient of two correlations, within 2e-6 absolute (measured
~1e-7; a local maximum within that of a neighbour or of the 0.55
threshold could change the candidate set, so the busy-sky draw is
tests/test_adsb.py's own seed, not one picked to agree)."""

import dataclasses

import jax  # noqa: F401  (JAX stays on the CPU: tests/conftest.py)
import numpy as np
import pytest
import torch

from orion_sdr_tpu.codec import adsb as JA
from orion_sdr_tpu.demodulate import adsb as JD
from orion_sdr_tpu.modulate import adsb as JM

from orion_sdr_tpu_torch.codec import adsb as PA
from orion_sdr_tpu_torch.demodulate import adsb as PD
from orion_sdr_tpu_torch.modulate import adsb as PM

torch.set_num_threads(1)
CPU = "cpu"
FS = 8_000_000.0


def _fields(msgs):
    return [dataclasses.astuple(m) for m in msgs]


def test_real_world_frame_and_crc_exact():
    bits = np.unpackbits(np.frombuffer(
        bytes.fromhex("8D4840D6202CC371C32CE0576098"), np.uint8))
    got = PA.adsb_decode_frame(bits)
    assert got is not None and got.callsign == "KLM1023"
    assert dataclasses.astuple(got) == dataclasses.astuple(
        JA.adsb_decode_frame(bits))
    rng = np.random.default_rng(0)
    for n in (1, 24, 88, 112):
        for _ in range(20):
            b = rng.integers(0, 2, n).astype(np.uint8)
            assert PA.adsb_crc24(b) == JA.adsb_crc24(b)


def test_encoders_and_frame_decode_exact():
    rng = np.random.default_rng(1)
    for _ in range(40):
        icao = int(rng.integers(0, 1 << 24))
        lat, lon = float(rng.uniform(-86, 86)), float(rng.uniform(-180, 180))
        alt = int(rng.integers(-40, 2000)) * 25
        odd = int(rng.integers(0, 2))
        gs, trk = float(rng.uniform(0, 900)), float(rng.uniform(0, 360))
        cs = "".join(rng.choice(list("ABCXYZ0129 "), 8))
        for enc, args in ((PA.adsb_encode_identification, (icao, cs)),
                          (PA.adsb_encode_position, (icao, lat, lon, alt,
                                                     odd)),
                          (PA.adsb_encode_velocity, (icao, gs, trk))):
            f = enc(*args)
            assert np.array_equal(f, getattr(JA, enc.__name__)(*args))
            bad = f.copy()
            bad[int(rng.integers(0, 112))] ^= 1
            for bits in (f, bad):
                p, j = PA.adsb_decode_frame(bits), JA.adsb_decode_frame(bits)
                assert (p is None) == (j is None)
                if p is not None:
                    assert dataclasses.astuple(p) == dataclasses.astuple(j)


@pytest.mark.parametrize("lat,lon", [(52.2572, 3.91937), (-33.9, 151.2),
                                     (0.01, -0.01), (65.0, -179.5),
                                     (87.2, 10.0), (0.0, 0.0)])
def test_cpr_exact(lat, lon):
    even, odd = PA.cpr_encode(lat, lon, 0), PA.cpr_encode(lat, lon, 1)
    assert (even, odd) == (JA.cpr_encode(lat, lon, 0),
                           JA.cpr_encode(lat, lon, 1))
    for recent in (False, True):
        assert PA.cpr_decode_global(even, odd, recent) == \
            JA.cpr_decode_global(even, odd, recent)


def test_chips_and_modulator_exact():
    frames = [JA.adsb_encode_identification(0xABCDEF, "ORION1"),
              JA.adsb_encode_velocity(0xABCDEF, 450.0, 245.0)]
    for f in frames:
        assert np.array_equal(PM.adsb_frame_chips(f), JM.adsb_frame_chips(f))
    for fs in (2e6, FS):
        for kw in ({}, dict(offsets_s=[5e-6, 90e-6], amplitudes=[0.4, 1.0],
                            total_s=400e-6)):
            got = PM.adsb_mod(frames, fs, device=CPU, **kw)
            assert got.dtype == torch.complex64
            assert np.array_equal(got.numpy(), JM.adsb_mod(frames, fs, **kw))


@pytest.fixture(scope="module")
def busy_sky():
    """tests/test_adsb.py::test_capture_decode_busy_sky's capture."""
    frames = [
        JA.adsb_encode_identification(0x4840D6, "KLM1023"),
        JA.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=0),
        JA.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=1),
        JA.adsb_encode_velocity(0x4840D6, 450.0, 245.0),
        JA.adsb_encode_identification(0xA1B2C3, "N123AB"),
    ]
    iq = JM.adsb_mod(frames, FS, amplitudes=[1.0, 0.8, 0.8, 0.7, 0.3])
    rng = np.random.default_rng(0)
    return iq + ((rng.standard_normal(len(iq)) + 1j * rng.standard_normal(
        len(iq))).astype(np.complex64) * 0.05)


def test_score_and_chip_sums_match(busy_sky):
    m = 4
    z = busy_sky
    jenv, jscore = JD._envelope_and_score(
        np.ascontiguousarray(z.real, np.float32),
        np.ascontiguousarray(z.imag, np.float32), m)
    penv, pscore = PD._envelope_and_score(torch.as_tensor(z), m)
    assert np.abs(penv.numpy() - np.asarray(jenv)).max() <= 1e-6
    assert np.abs(pscore.numpy() - np.asarray(jscore)).max() <= 2e-6
    starts = np.array([0, 17, 4000, len(z) - 10], np.int64)
    ref = np.asarray(JD._chip_sums(jenv, starts.astype(np.int32), m))
    got = PD._chip_sums(torch.as_tensor(np.array(jenv)), starts, m).numpy()
    assert np.abs(got - ref).max() <= 1e-5


def test_capture_decode_busy_sky_matches(busy_sky):
    ref = JD.adsb_decode_capture(busy_sky, FS)
    assert len(ref) == 5
    got = PD.adsb_decode_capture(busy_sky, FS, device=CPU)
    assert _fields(got) == _fields(ref)
    assert any(m.position for m in got)
    # a candidate cap below the count keeps the strongest, as in the JAX
    # package
    assert _fields(PD.adsb_decode_capture(busy_sky, FS, max_candidates=3,
                                          device=CPU)) == \
        _fields(JD.adsb_decode_capture(busy_sky, FS, max_candidates=3))


def test_capture_validation_and_empty():
    with pytest.raises(ValueError):
        PD.adsb_decode_capture(np.zeros(1000, np.complex64), 3_000_000.0,
                               device=CPU)
    with pytest.raises(ValueError):
        PD.adsb_decode_capture(np.zeros((2, 1000), np.complex64), FS,
                               device=CPU)
    assert PD.adsb_decode_capture(np.zeros(100, np.complex64), FS,
                                  device=CPU) == []
    assert PD.adsb_decode_capture(np.zeros(20000, np.complex64), FS,
                                  device=CPU) == []
    with pytest.raises(ValueError):
        PM.adsb_frame_chips(np.zeros(56, np.uint8))
    with pytest.raises(ValueError):
        PM.adsb_mod([], 3e6, device=CPU)
