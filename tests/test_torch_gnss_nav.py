"""Torch port, the GPS LNAV layer (gnss_nav.py, the port's own numpy copy)
against the JAX package on the CPU, with the same inputs.

Tolerances: exact everywhere. Nav words, parity, solved tails, whole
1500-bit frames (subframes 1–5 with almanac and iono/UTC pages), decoded
subframes and every ephemeris, almanac, iono and UTC field; satellite
positions, Klobuchar delays and fixes (the same float64 numpy). The
capture → ephemeris path runs on the card (chip_smoke.py [41]); here the
bits-level sizes of tests/test_gnss_nav.py, and the port decodes the JAX
package's frames and the JAX package the port's."""

import dataclasses

import numpy as np
import pytest
import torch

import orion_sdr_tpu as J
from orion_sdr_tpu import gnss_nav as JN

import orion_sdr_tpu_torch as P
from orion_sdr_tpu_torch import gnss_nav as PN

torch.set_num_threads(1)

EPH = dict(
    week=221, ura=1, sv_health=0, iodc=0x1A7, t_gd=-5.12e-9,
    t_oc=302400.0, a_f2=0.0, a_f1=-3.1e-12, a_f0=4.57e-4,
    iode=0xA7, c_rs=-112.8125, delta_n=4.3e-9, m0=1.23456,
    c_uc=-6.3e-6, e=0.0123456, c_us=5.2e-6, sqrt_a=5153.712,
    t_oe=302400.0, c_ic=1.1e-7, omega0=-2.2345, c_is=-9.3e-8,
    i0=0.9617, c_rc=287.46875, omega=2.7182, omega_dot=-8.1e-9,
    idot=4.0e-10)
ALM = dict(prn=7, e=0.0091, t_oa=319488.0, delta_i=0.0123,
           omega_dot=-2.51e-9, sv_health=0, sqrt_a=5153.6, omega0=-1.9876,
           omega=0.8765, m0=-2.3456, a_f0=3.8e-5, a_f1=-7.3e-12)
IONO = dict(alpha=(1.1176e-8, 7.4506e-9, -5.9605e-8, -5.9605e-8),
            beta=(1.29e5, 4.9152e4, -1.966e5, 3.277e5))
UTC = dict(a0=9.3e-9, a1=-2.7e-15, t_ot=405504.0, wn_t=221, delta_t_ls=18,
           wn_lsf=137, dn=7, delta_t_lsf=18)


def fields(x):
    return None if x is None else dataclasses.asdict(x)


def frame_fields(f):
    return ([tuple(s) for s in f.subframes], fields(f.ephemeris),
            {k: fields(v) for k, v in (f.almanacs or {}).items()},
            fields(f.iono), fields(f.utc))


def test_word_parity_exact():
    rng = np.random.default_rng(0)
    for d29s in (0, 1):
        for d30s in (0, 1):
            for _ in range(20):
                d = int(rng.integers(0, 1 << 24))
                w = PN.nav_word_encode(d, d29s, d30s)
                assert np.array_equal(w, JN.nav_word_encode(d, d29s, d30s))
                assert PN.nav_word_check(w, d29s, d30s) == d
                bad = w.copy()
                bad[int(rng.integers(0, 30))] ^= 1
                assert PN.nav_word_check(bad, d29s, d30s) is None
                assert JN.nav_word_check(bad, d29s, d30s) is None
            assert PN._solve_tail(0x2ABCDE >> 2, d29s, d30s) == \
                JN._solve_tail(0x2ABCDE >> 2, d29s, d30s)


def _frames(tow=8):
    pe = P.GpsEphemeris(**EPH)
    je = J.GpsEphemeris(**EPH)
    pw = (P.iono_utc_page_words(P.GpsIono(**IONO), P.GpsUtc(**UTC)),
          P.almanac_page_words(P.GpsAlmanac(**ALM)))
    jw = (J.iono_utc_page_words(J.GpsIono(**IONO), J.GpsUtc(**UTC)),
          J.almanac_page_words(J.GpsAlmanac(**ALM)))
    assert pw == jw
    pb = P.nav_subframes_encode(pe, tow, sf4_words=pw[0], sf5_words=pw[1])
    jb = J.nav_subframes_encode(je, tow, sf4_words=jw[0], sf5_words=jw[1])
    return pb, jb


def test_full_frame_encode_decode_exact():
    pb, jb = _frames()
    assert pb.shape == (1500,) and np.array_equal(pb, jb)
    pf = P.nav_subframes_decode(jb)
    jf = J.nav_subframes_decode(pb)
    assert frame_fields(pf) == frame_fields(jf)
    assert [s.sfid for s in pf.subframes] == [1, 2, 3, 4, 5]
    assert set(pf.almanacs) == {7}
    assert P.GpsEphemeris(**fields(pf.ephemeris)) == pf.ephemeris


@pytest.mark.parametrize("lead,invert,flip", [
    (17, False, None), (11, True, None), (0, False, 395)])
def test_decode_bits_at_an_offset_exact(lead, invert, flip):
    """tests/test_gnss_nav.py's bits-level cases: a frame behind random
    bits, inverted, and with a parity error in subframe 2."""
    bits, _ = _frames(4)
    if flip is not None:
        bits = bits.copy()
        bits[flip] ^= 1
    rng = np.random.default_rng(5)
    stream = np.concatenate([rng.integers(0, 2, lead).astype(np.uint8),
                             1 - bits if invert else bits])
    pf, jf = P.nav_subframes_decode(stream), J.nav_subframes_decode(stream)
    assert frame_fields(pf) == frame_fields(jf)
    assert (pf.ephemeris is None) == (flip is not None)


def test_orbit_klobuchar_and_fix_exact():
    pe, je = P.GpsEphemeris(**EPH), J.GpsEphemeris(**EPH)
    for dt in (0.0, 10.0, 2700.0, 400000.0):
        assert np.array_equal(P.eph_sat_pos(pe, pe.t_oe + dt),
                              J.eph_sat_pos(je, je.t_oe + dt))
    pa, ja = P.GpsAlmanac(**ALM), J.GpsAlmanac(**ALM)
    assert np.array_equal(P.alm_sat_pos(pa, 320000.0),
                          J.alm_sat_pos(ja, 320000.0))
    args = (np.deg2rad(40.0), np.deg2rad(-100.0), np.deg2rad(210.0),
            np.deg2rad(20.0))
    for t in (593100.0, 75440.0):
        assert P.klobuchar_delay(P.GpsIono(**IONO), *args, t) == \
            J.klobuchar_delay(J.GpsIono(**IONO), *args, t)
    rng = np.random.default_rng(3)
    truth = np.array([1113194.0, -4842168.0, 3985243.0])
    sats = np.stack([P.eph_sat_pos(P.GpsEphemeris(
        sqrt_a=5153.7, e=0.01, m0=k * 1.05, omega0=k * 1.0, i0=0.96,
        omega=0.3 * k, t_oe=302400.0), 302400.0 + 40.0 * k)
        for k in range(6)])
    pr = np.linalg.norm(sats - truth, axis=1) + 8500.0 \
        + rng.normal(0, 0.5, len(sats))
    pos, b = P.gps_fix(sats, pr)
    jpos, jb = J.gps_fix(sats, pr)
    assert np.array_equal(pos, jpos) and b == jb
    assert np.linalg.norm(pos - truth) < 5.0
    with pytest.raises(ValueError):
        P.gps_fix(np.zeros((3, 3)), np.zeros(3))


def test_nav_frame_defaults():
    assert P.GpsNavFrame([], None).almanacs is None
    assert P.nav_subframes_decode(np.zeros(40, np.uint8)) == \
        P.GpsNavFrame([], None, {})
