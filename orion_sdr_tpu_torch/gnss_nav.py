"""GPS LNAV navigation-message layer, IS-GPS-200 wire format (the port's
own copy of ``orion_sdr_tpu/gnss_nav.py``, numpy, bit-exact with it).

Codec (subframe encode for test synthesis), wire-format decode (word
parity, TLM/HOW, subframe 1-3 ephemeris fields, subframe 4/5 almanac and
iono/UTC pages), and the orbital/PVT math (Kepler satellite position from
ephemeris or almanac, Klobuchar delay, iterative least-squares fix).

Wire compatibility: the (32, 26) extended-Hamming word parity (Table
20-XIV), the D30*-complement data encoding, the solved non-information
bits of HOW and word 10 (forcing D29 = D30 = 0 so every subframe starts
parity-independent), and the subframe 1-3 field layouts/scale factors
(Tables 20-I, 20-III) follow IS-GPS-200. All parsing is host numpy: nav
bits arrive at 50 bps, so there is nothing for the device to win here; the
device programs end at ``gnss.gps_track``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .dsp.device import to_device
from .gnss import (GPS_NAV_PREAMBLE, gps_acquire, gps_nav_frame_sync,
                   gps_track)

# WGS-84 / IS-GPS-200 constants
GPS_MU = 3.986005e14            # m^3/s^2
GPS_OMEGA_E = 7.2921151467e-5   # rad/s
GPS_PI = 3.1415926535898        # the ICD's fixed pi (semicircle scaling)
GPS_C = 2.99792458e8            # m/s

# parity taps: 1-based data-bit index sets for D25..D30 (Table 20-XIV)
_PARITY_TAPS = (
    (1, 2, 3, 5, 6, 10, 11, 12, 13, 14, 17, 18, 20, 23),
    (2, 3, 4, 6, 7, 11, 12, 13, 14, 15, 18, 19, 21, 24),
    (1, 3, 4, 5, 7, 8, 12, 13, 14, 15, 16, 19, 20, 22),
    (2, 4, 5, 6, 8, 9, 13, 14, 15, 16, 17, 20, 21, 23),
    (1, 3, 5, 6, 7, 9, 10, 14, 15, 16, 17, 18, 21, 22, 24),
    (3, 5, 6, 8, 9, 10, 11, 13, 15, 19, 22, 23, 24),
)
# D25..D28 and D30 seed from D29*; D29 seeds from D30* — per the table
_PARITY_SEED_IS_D29 = (True, False, True, False, False, True)


def _bits_of(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    np.uint8)


def _int_of(bits) -> int:
    v = 0
    for b in np.asarray(bits).astype(int):
        v = (v << 1) | (b & 1)
    return v


def nav_word_encode(d24: int, d29s: int, d30s: int) -> np.ndarray:
    """Encode 24 data bits into a 30-bit word given the previous word's
    last two bits D29*, D30*. Data bits transmit complemented by D30*."""
    d = _bits_of(d24, 24)
    seeds = (d29s, d30s)
    par = []
    for taps, from29 in zip(_PARITY_TAPS, _PARITY_SEED_IS_D29):
        p = seeds[0] if from29 else seeds[1]
        for t in taps:
            p ^= int(d[t - 1])
        par.append(p)
    out = np.concatenate([d ^ d30s, np.array(par, np.uint8)])
    return out.astype(np.uint8)


def nav_word_check(word30, d29s: int, d30s: int) -> Optional[int]:
    """Parity-check one received 30-bit word; returns the 24 decoded data
    bits as an int, or None on parity failure."""
    w = np.asarray(word30).astype(np.uint8) % 2
    if w.shape != (30,):
        raise ValueError("nav word must be 30 bits")
    d = (w[:24] ^ d30s).astype(np.uint8)
    seeds = (d29s, d30s)
    for taps, from29, rx in zip(_PARITY_TAPS, _PARITY_SEED_IS_D29, w[24:]):
        p = seeds[0] if from29 else seeds[1]
        for t in taps:
            p ^= int(d[t - 1])
        if p != int(rx):
            return None
    return _int_of(d)


def _solve_tail(d22: int, d29s: int, d30s: int) -> int:
    """Choose the two non-information bits (d23, d24) of HOW / word 10 so
    the word's D29 = D30 = 0 (IS-GPS-200 20.3.3.2: keeps every following
    word's data independent of this one's parity state)."""
    for tail in range(4):
        d24 = (d22 << 2) | tail
        w = nav_word_encode(d24, d29s, d30s)
        if w[28] == 0 and w[29] == 0:
            return d24
    raise AssertionError("unreachable: the tail bits span the parity coset")


def _twos(value: float, scale_pow2: int, bits: int) -> int:
    """Quantize to two's complement with LSB 2**scale_pow2."""
    q = int(round(value / (2.0 ** scale_pow2)))
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    if not lo <= q <= hi:
        raise ValueError(f"field overflow: {value} in {bits} bits")
    return q & ((1 << bits) - 1)


def _untwos(raw: int, scale_pow2: int, bits: int) -> float:
    if raw >= (1 << (bits - 1)):
        raw -= 1 << bits
    return raw * (2.0 ** scale_pow2)


def _uns(value: float, scale_pow2: int, bits: int) -> int:
    q = int(round(value / (2.0 ** scale_pow2)))
    if not 0 <= q < (1 << bits):
        raise ValueError(f"field overflow: {value} in {bits} bits")
    return q


@dataclass(frozen=True)
class GpsEphemeris:
    """Subframe 1-3 clock + ephemeris. Angles in RADIANS (converted from
    the wire's semicircles), times in seconds, per IS-GPS-200 scaling."""
    week: int = 0
    ura: int = 0
    sv_health: int = 0
    iodc: int = 0
    t_gd: float = 0.0
    t_oc: float = 0.0
    a_f2: float = 0.0
    a_f1: float = 0.0
    a_f0: float = 0.0
    iode: int = 0
    c_rs: float = 0.0
    delta_n: float = 0.0          # rad/s
    m0: float = 0.0               # rad
    c_uc: float = 0.0
    e: float = 0.0
    c_us: float = 0.0
    sqrt_a: float = 0.0           # sqrt(m)
    t_oe: float = 0.0
    c_ic: float = 0.0
    omega0: float = 0.0           # rad
    c_is: float = 0.0
    i0: float = 0.0               # rad
    c_rc: float = 0.0
    omega: float = 0.0            # rad
    omega_dot: float = 0.0        # rad/s
    idot: float = 0.0             # rad/s


_SEMI = GPS_PI                    # semicircles → radians


def _sc(rad: float) -> float:
    return rad / _SEMI


def _rad(semi: float) -> float:
    return semi * _SEMI


@dataclass(frozen=True)
class GpsAlmanac:
    """Subframe 4/5 almanac page (IS-GPS-200 20.3.3.5.1.2, Table 20-VI).
    Angles in radians; ``delta_i`` is relative to the 0.3-semicircle
    reference inclination."""
    prn: int = 1
    e: float = 0.0
    t_oa: float = 0.0
    delta_i: float = 0.0          # rad, relative to 0.3 sc
    omega_dot: float = 0.0        # rad/s
    sv_health: int = 0
    sqrt_a: float = 0.0           # sqrt(m)
    omega0: float = 0.0           # rad
    omega: float = 0.0            # rad
    m0: float = 0.0               # rad
    a_f0: float = 0.0
    a_f1: float = 0.0


@dataclass(frozen=True)
class GpsIono:
    """Klobuchar ionospheric coefficients (subframe 4 page 18, 20.3.3.5.1.7).
    alpha: s, s/sc, s/sc², s/sc³; beta: s, s/sc, s/sc², s/sc³."""
    alpha: tuple = (0.0, 0.0, 0.0, 0.0)
    beta: tuple = (0.0, 0.0, 0.0, 0.0)


@dataclass(frozen=True)
class GpsUtc:
    """UTC parameters (subframe 4 page 18 words 6-10, 20.3.3.5.1.6)."""
    a0: float = 0.0               # s
    a1: float = 0.0               # s/s
    t_ot: float = 0.0             # s
    wn_t: int = 0
    delta_t_ls: int = 0           # s (current leap seconds)
    wn_lsf: int = 0
    dn: int = 0
    delta_t_lsf: int = 0


# data ID for the current LNAV almanac structure (20.3.3.5.1.1)
_DATA_ID = 1
_IONO_UTC_SVID = 56               # subframe 4 page 18


def almanac_page_words(alm: GpsAlmanac) -> List[int]:
    """Eight data words (words 3..10-head) of one almanac page. The SV ID
    field carries the PRN for pages assigned to satellites."""
    e16 = _uns(alm.e, -21, 16)
    di16 = _twos(_sc(alm.delta_i), -19, 16)
    od16 = _twos(_sc(alm.omega_dot), -38, 16)
    sqa24 = _uns(alm.sqrt_a, -11, 24)
    om0_24 = _twos(_sc(alm.omega0), -23, 24)
    w24 = _twos(_sc(alm.omega), -23, 24)
    m0_24 = _twos(_sc(alm.m0), -23, 24)
    af0 = _twos(alm.a_f0, -20, 11)
    af1 = _twos(alm.a_f1, -38, 11)
    return [
        (_DATA_ID << 22) | ((alm.prn & 0x3F) << 16) | e16,
        (_uns(alm.t_oa, 12, 8) << 16) | di16,
        (od16 << 8) | (alm.sv_health & 0xFF),
        sqa24,
        om0_24,
        w24,
        m0_24,
        # word 10 head (22 bits): a_f0 MSBs(8), a_f1(11), a_f0 LSBs(3)
        ((af0 >> 3) << 14) | (af1 << 3) | (af0 & 0x7),
    ]


def iono_utc_page_words(iono: GpsIono, utc: GpsUtc) -> List[int]:
    """Subframe 4 page 18 data words: Klobuchar α/β + UTC parameters."""
    a = [_twos(v, s, 8) for v, s in zip(iono.alpha, (-30, -27, -24, -24))]
    b = [_twos(v, s, 8) for v, s in zip(iono.beta, (11, 14, 16, 16))]
    a1_24 = _twos(utc.a1, -50, 24)
    a0_32 = _twos(utc.a0, -30, 32)
    return [
        (_DATA_ID << 22) | (_IONO_UTC_SVID << 16) | (a[0] << 8) | a[1],
        (a[2] << 16) | (a[3] << 8) | b[0],
        (b[1] << 16) | (b[2] << 8) | b[3],
        a1_24,
        a0_32 >> 8,
        ((a0_32 & 0xFF) << 16) | (_uns(utc.t_ot, 12, 8) << 8)
        | (utc.wn_t & 0xFF),
        (_twos(float(utc.delta_t_ls), 0, 8) << 16)
        | ((utc.wn_lsf & 0xFF) << 8) | (utc.dn & 0xFF),
        _twos(float(utc.delta_t_lsf), 0, 8) << 14,   # word 10 head (22 bits)
    ]


def nav_subframes_encode(eph: GpsEphemeris, tow_count_start: int = 0,
                         sf4_words: Optional[List[int]] = None,
                         sf5_words: Optional[List[int]] = None
                         ) -> np.ndarray:
    """Encode one full 1500-bit LNAV frame (subframes 1..5).
    ``sf4_words``/``sf5_words``: the eight data words of that subframe's
    page this frame (see ``almanac_page_words`` / ``iono_utc_page_words``);
    zero-filled reserved pages when omitted. ``tow_count_start``: 1.5-s TOW
    count at the start of subframe 1 (multiple of 4). Returns (1500,) uint8."""
    if tow_count_start % 4:
        raise ValueError("subframes start on 6 s epochs (TOW multiple of 4)")

    def tlm() -> int:
        return (_int_of(GPS_NAV_PREAMBLE) << 16) | (0 << 2) | 0

    def sf_words(sfid: int, data_words: List[int], tow_next: int,
                 d29s: int, d30s: int) -> List[np.ndarray]:
        words = []
        w = nav_word_encode(tlm(), d29s, d30s)
        words.append(w)
        d29s, d30s = int(w[28]), int(w[29])
        how22 = ((tow_next // 4) << 5) | (0 << 4) | (0 << 3) | sfid
        w = nav_word_encode(_solve_tail(how22, d29s, d30s), d29s, d30s)
        words.append(w)
        d29s, d30s = int(w[28]), int(w[29])
        for k, dw in enumerate(data_words):
            if k == len(data_words) - 1:            # word 10: solved tail
                w = nav_word_encode(_solve_tail(dw, d29s, d30s), d29s, d30s)
            else:
                w = nav_word_encode(dw, d29s, d30s)
            words.append(w)
            d29s, d30s = int(w[28]), int(w[29])
        return words

    e = eph
    iodc10, iode8 = e.iodc & 0x3FF, e.iode & 0xFF
    sf1 = [
        ((e.week & 0x3FF) << 14) | (1 << 12) | ((e.ura & 0xF) << 8)
        | ((e.sv_health & 0x3F) << 2) | (iodc10 >> 8),
        0, 0, 0,
        _twos(e.t_gd, -31, 8),
        ((iodc10 & 0xFF) << 16) | _uns(e.t_oc, 4, 16),
        (_twos(e.a_f2, -55, 8) << 16) | _twos(e.a_f1, -43, 16),
        _twos(e.a_f0, -31, 22),                      # word 10 head (22 bits)
    ]
    m0_32 = _twos(_sc(e.m0), -31, 32)
    e_32 = _uns(e.e, -33, 32)
    sqa_32 = _uns(e.sqrt_a, -19, 32)
    sf2 = [
        (iode8 << 16) | _twos(e.c_rs, -5, 16),
        (_twos(_sc(e.delta_n) * 1.0, -43, 16) << 8) | (m0_32 >> 24),
        m0_32 & 0xFFFFFF,
        (_twos(e.c_uc, -29, 16) << 8) | (e_32 >> 24),
        e_32 & 0xFFFFFF,
        (_twos(e.c_us, -29, 16) << 8) | (sqa_32 >> 24),
        sqa_32 & 0xFFFFFF,
        (_uns(e.t_oe, 4, 16) << 6) | 0,              # word 10 head (22 bits)
    ]
    om0_32 = _twos(_sc(e.omega0), -31, 32)
    i0_32 = _twos(_sc(e.i0), -31, 32)
    w_32 = _twos(_sc(e.omega), -31, 32)
    sf3 = [
        (_twos(e.c_ic, -29, 16) << 8) | (om0_32 >> 24),
        om0_32 & 0xFFFFFF,
        (_twos(e.c_is, -29, 16) << 8) | (i0_32 >> 24),
        i0_32 & 0xFFFFFF,
        (_twos(e.c_rc, -5, 16) << 8) | (w_32 >> 24),
        w_32 & 0xFFFFFF,
        _twos(_sc(e.omega_dot), -43, 24),
        (iode8 << 14) | (_twos(_sc(e.idot), -43, 14)),  # word 10 head
    ]
    filler = [0] * 7 + [0]
    sf4 = list(sf4_words) if sf4_words is not None else filler
    sf5 = list(sf5_words) if sf5_words is not None else filler
    for nm, sf in (("sf4", sf4), ("sf5", sf5)):
        if len(sf) != 8:
            raise ValueError(f"{nm}_words must be the 8 data words of the "
                             "page (words 3..10-head)")

    out = []
    d29s = d30s = 0          # previous subframe's word 10 forces 0, 0
    for sfid, words in ((1, sf1), (2, sf2), (3, sf3),
                        (4, sf4), (5, sf5)):
        tow_next = tow_count_start + 4 * sfid      # TOW of NEXT subframe
        sw = sf_words(sfid, words, tow_next, d29s, d30s)
        out.extend(sw)
        d29s = d30s = 0                            # word-10 tail solved
    return np.concatenate(out).astype(np.uint8)


class GpsSubframe(NamedTuple):
    sfid: int
    tow_s: float                  # seconds-of-week of the NEXT subframe
    words: List[int]              # ten 24-bit data words


class GpsNavFrame(NamedTuple):
    subframes: List[GpsSubframe]
    ephemeris: Optional[GpsEphemeris]
    # prn → GpsAlmanac; ``None`` means "no almanac pages decoded" (a dict
    # default on a NamedTuple would be one shared mutable object across
    # every default-constructed instance). ``nav_subframes_decode`` always
    # fills in a fresh dict.
    almanacs: Optional[dict] = None
    iono: Optional[GpsIono] = None
    utc: Optional[GpsUtc] = None


def nav_subframes_decode(bits) -> GpsNavFrame:
    """Frame-sync a nav bit stream (either polarity), parity-check every
    word, parse TLM/HOW, and assemble the ephemeris once subframes 1-3
    all pass. Subframes with any parity failure are dropped."""
    b = np.asarray(bits).astype(np.uint8) % 2
    start = gps_nav_frame_sync(b)
    if start is None:
        return GpsNavFrame([], None, {})
    # polarity: the TLM preamble transmits complemented by the previous
    # D30* (= 0 after a solved word 10), so an inverted preamble means an
    # inverted stream
    if not np.array_equal(b[start:start + 8], GPS_NAV_PREAMBLE):
        b = 1 - b
    subframes: List[GpsSubframe] = []
    raw: dict = {}
    almanacs: dict = {}
    iono: Optional[GpsIono] = None
    utc: Optional[GpsUtc] = None
    pos = start
    while pos + 300 <= len(b):
        d29s = d30s = 0
        words = []
        ok = True
        for w in range(10):
            dw = nav_word_check(b[pos + 30 * w: pos + 30 * (w + 1)],
                                d29s, d30s)
            if dw is None:
                ok = False
                break
            words.append(dw)
            d29s = int(b[pos + 30 * w + 28])
            d30s = int(b[pos + 30 * w + 29])
        pos += 300
        if not ok or not np.array_equal(
                _bits_of(words[0] >> 16, 8), GPS_NAV_PREAMBLE):
            continue
        sfid = (words[1] >> 2) & 0x7
        tow = float((words[1] >> 7) * 6.0)
        subframes.append(GpsSubframe(sfid, tow, words))
        if sfid in (1, 2, 3):
            raw[sfid] = words
        elif sfid in (4, 5):
            # int(): words accumulate numpy ints via _int_of — keep the
            # public dict keyed by plain Python int
            svid = int((words[2] >> 16) & 0x3F)
            if 1 <= svid <= 32:
                almanacs[svid] = _parse_almanac_page(words)
            elif sfid == 4 and svid == _IONO_UTC_SVID:
                iono, utc = _parse_iono_utc_page(words)

    eph = None
    if {1, 2, 3} <= raw.keys():
        w1, w2, w3 = raw[1], raw[2], raw[3]
        iodc = (((w1[2] & 0x3) << 8) | (w1[7] >> 16)) & 0x3FF
        m0 = _rad(_untwos(((w2[3] & 0xFF) << 24) | w2[4], -31, 32))
        ecc = (((w2[5] & 0xFF) << 24) | w2[6]) * 2.0 ** -33
        sqa = (((w2[7] & 0xFF) << 24) | w2[8]) * 2.0 ** -19
        om0 = _rad(_untwos(((w3[2] & 0xFF) << 24) | w3[3], -31, 32))
        i0 = _rad(_untwos(((w3[4] & 0xFF) << 24) | w3[5], -31, 32))
        ww = _rad(_untwos(((w3[6] & 0xFF) << 24) | w3[7], -31, 32))
        eph = GpsEphemeris(
            week=(w1[2] >> 14) & 0x3FF,
            ura=(w1[2] >> 8) & 0xF,
            sv_health=(w1[2] >> 2) & 0x3F,
            iodc=iodc,
            t_gd=_untwos(w1[6] & 0xFF, -31, 8),
            t_oc=float((w1[7] & 0xFFFF) * 16),
            a_f2=_untwos(w1[8] >> 16, -55, 8),
            a_f1=_untwos(w1[8] & 0xFFFF, -43, 16),
            a_f0=_untwos((w1[9] >> 2) & 0x3FFFFF, -31, 22),
            iode=(w2[2] >> 16) & 0xFF,
            c_rs=_untwos(w2[2] & 0xFFFF, -5, 16),
            delta_n=_rad(_untwos((w2[3] >> 8) & 0xFFFF, -43, 16)),
            m0=m0,
            c_uc=_untwos((w2[5] >> 8) & 0xFFFF, -29, 16),
            e=ecc,
            c_us=_untwos((w2[7] >> 8) & 0xFFFF, -29, 16),
            sqrt_a=sqa,
            t_oe=float(((w2[9] >> 8) & 0xFFFF) * 16),
            c_ic=_untwos((w3[2] >> 8) & 0xFFFF, -29, 16),
            omega0=om0,
            c_is=_untwos((w3[4] >> 8) & 0xFFFF, -29, 16),
            i0=i0,
            c_rc=_untwos((w3[6] >> 8) & 0xFFFF, -5, 16),
            omega=ww,
            omega_dot=_rad(_untwos(w3[8], -43, 24)),
            idot=_rad(_untwos((w3[9] >> 2) & 0x3FFF, -43, 14)),
        )
    return GpsNavFrame(subframes, eph, almanacs, iono, utc)


def _parse_almanac_page(words: List[int]) -> GpsAlmanac:
    w = words
    af0 = ((w[9] >> 16) & 0xFF) << 3 | ((w[9] >> 2) & 0x7)
    return GpsAlmanac(
        prn=int((w[2] >> 16) & 0x3F),
        e=(w[2] & 0xFFFF) * 2.0 ** -21,
        t_oa=float(((w[3] >> 16) & 0xFF) * 4096),
        delta_i=_rad(_untwos(w[3] & 0xFFFF, -19, 16)),
        omega_dot=_rad(_untwos((w[4] >> 8) & 0xFFFF, -38, 16)),
        sv_health=int(w[4] & 0xFF),
        sqrt_a=w[5] * 2.0 ** -11,
        omega0=_rad(_untwos(w[6], -23, 24)),
        omega=_rad(_untwos(w[7], -23, 24)),
        m0=_rad(_untwos(w[8], -23, 24)),
        a_f0=_untwos(af0, -20, 11),
        a_f1=_untwos((w[9] >> 5) & 0x7FF, -38, 11),
    )


def _parse_iono_utc_page(words: List[int]):
    w = words
    alpha = tuple(_untwos(v, s, 8) for v, s in zip(
        ((w[2] >> 8) & 0xFF, w[2] & 0xFF, (w[3] >> 16) & 0xFF,
         (w[3] >> 8) & 0xFF), (-30, -27, -24, -24)))
    beta = tuple(_untwos(v, s, 8) for v, s in zip(
        (w[3] & 0xFF, (w[4] >> 16) & 0xFF, (w[4] >> 8) & 0xFF, w[4] & 0xFF),
        (11, 14, 16, 16)))
    utc = GpsUtc(
        a1=_untwos(w[5], -50, 24),
        a0=_untwos((w[6] << 8) | ((w[7] >> 16) & 0xFF), -30, 32),
        t_ot=float(((w[7] >> 8) & 0xFF) * 4096),
        wn_t=int(w[7] & 0xFF),
        delta_t_ls=int(_untwos((w[8] >> 16) & 0xFF, 0, 8)),
        wn_lsf=int((w[8] >> 8) & 0xFF),
        dn=int(w[8] & 0xFF),
        delta_t_lsf=int(_untwos((w[9] >> 16) & 0xFF, 0, 8)),
    )
    return GpsIono(alpha, beta), utc


def alm_sat_pos(alm: GpsAlmanac, t_sow: float) -> np.ndarray:
    """ECEF satellite position from an almanac page: the ephemeris Kepler
    algorithm with the almanac's reduced parameter set (20.3.3.5.2.1 —
    i = 0.3 semicircles + δi, no harmonic corrections, Δn = 0)."""
    eph = GpsEphemeris(
        e=alm.e, sqrt_a=alm.sqrt_a, m0=alm.m0, omega=alm.omega,
        omega0=alm.omega0, omega_dot=alm.omega_dot,
        i0=_rad(0.3) + alm.delta_i, t_oe=alm.t_oa,
    )
    return eph_sat_pos(eph, t_sow)


def klobuchar_delay(iono: GpsIono, lat_rad: float, lon_rad: float,
                    az_rad: float, el_rad: float, t_sow: float) -> float:
    """Klobuchar single-frequency ionospheric delay in SECONDS on L1 for a
    receiver at geodetic (lat, lon) observing a satellite at (az, el)
    (IS-GPS-200 20.3.3.5.2.5, angles in the ICD's semicircle units
    internally). Multiply by c for meters."""
    a0, a1, a2, a3 = iono.alpha
    b0, b1, b2, b3 = iono.beta
    el_sc = max(el_rad / _SEMI, 0.0)
    lat_sc = lat_rad / _SEMI
    lon_sc = lon_rad / _SEMI
    az = az_rad
    # earth-centred angle to the ionospheric pierce point (semicircles)
    psi = 0.0137 / (el_sc + 0.11) - 0.022
    phi_i = lat_sc + psi * np.cos(az)
    phi_i = min(max(phi_i, -0.416), 0.416)
    lam_i = lon_sc + psi * np.sin(az) / np.cos(phi_i * _SEMI)
    phi_m = phi_i + 0.064 * np.cos((lam_i - 1.617) * _SEMI)
    t = 4.32e4 * lam_i + t_sow
    t = t % 86400.0
    amp = a0 + phi_m * (a1 + phi_m * (a2 + phi_m * a3))
    per = b0 + phi_m * (b1 + phi_m * (b2 + phi_m * b3))
    amp = max(amp, 0.0)
    per = max(per, 72000.0)
    x = 2.0 * np.pi * (t - 50400.0) / per
    slant = 1.0 + 16.0 * (0.53 - el_sc) ** 3
    if abs(x) < 1.57:
        return float(slant * (5.0e-9 + amp * (1.0 - x * x / 2.0
                                              + x ** 4 / 24.0)))
    return float(slant * 5.0e-9)


def eph_sat_pos(eph: GpsEphemeris, t_sow: float) -> np.ndarray:
    """ECEF satellite position (meters) at GPS seconds-of-week ``t_sow``
    from broadcast ephemeris (IS-GPS-200 Table 20-IV algorithm)."""
    A = eph.sqrt_a ** 2
    n = np.sqrt(GPS_MU / A ** 3) + eph.delta_n
    tk = t_sow - eph.t_oe
    if tk > 302400.0:
        tk -= 604800.0
    elif tk < -302400.0:
        tk += 604800.0
    M = eph.m0 + n * tk
    E = M
    for _ in range(12):
        E = E - (E - eph.e * np.sin(E) - M) / (1.0 - eph.e * np.cos(E))
    nu = np.arctan2(np.sqrt(1.0 - eph.e ** 2) * np.sin(E),
                    np.cos(E) - eph.e)
    phi = nu + eph.omega
    s2, c2 = np.sin(2 * phi), np.cos(2 * phi)
    du = eph.c_us * s2 + eph.c_uc * c2
    dr = eph.c_rs * s2 + eph.c_rc * c2
    di = eph.c_is * s2 + eph.c_ic * c2
    u = phi + du
    r = A * (1.0 - eph.e * np.cos(E)) + dr
    i = eph.i0 + di + eph.idot * tk
    xo, yo = r * np.cos(u), r * np.sin(u)
    om = eph.omega0 + (eph.omega_dot - GPS_OMEGA_E) * tk \
        - GPS_OMEGA_E * eph.t_oe
    x = xo * np.cos(om) - yo * np.cos(i) * np.sin(om)
    y = xo * np.sin(om) + yo * np.cos(i) * np.cos(om)
    z = yo * np.sin(i)
    return np.array([x, y, z])


def gps_fix(sat_pos, pseudoranges, x0=None, n_iter: int = 8):
    """Iterative least-squares position + receiver clock bias from ≥4
    satellites. ``sat_pos``: (N, 3) ECEF meters; ``pseudoranges``: (N,)
    meters. Returns (ecef_pos (3,), clock_bias_m)."""
    sp = np.asarray(sat_pos, np.float64)
    pr = np.asarray(pseudoranges, np.float64)
    if sp.shape[0] < 4:
        raise ValueError("a 3D fix needs at least 4 satellites")
    x = np.zeros(4) if x0 is None else np.concatenate(
        [np.asarray(x0, np.float64), [0.0]])
    for _ in range(n_iter):
        d = sp - x[:3]
        rho = np.linalg.norm(d, axis=1)
        h = np.concatenate([-d / rho[:, None], np.ones((len(pr), 1))],
                           axis=1)
        dz = pr - (rho + x[3])
        x = x + np.linalg.lstsq(h, dz, rcond=None)[0]
    return x[:3], float(x[3])


def gps_decode_ephemeris(iq, fs: float, prn: int,
                         doppler_hz: Optional[float] = None,
                         code_phase_samples: Optional[int] = None,
                         device="cuda") -> GpsNavFrame:
    """Capture → ephemeris: acquire (unless Doppler and code phase are
    given), track, recover nav bits, frame-sync, parity-check, parse. The
    acquisition and the tracking loops run on ``device``."""
    iq = to_device(iq, device, torch.complex64)      # one copy for both
    if doppler_hz is None or code_phase_samples is None:
        acq = [a for a in gps_acquire(iq, fs, prns=[prn], device=device)
               if a.prn == prn]
        if not acq:
            return GpsNavFrame([], None, {})
        doppler_hz = acq[0].doppler_hz
        code_phase_samples = acq[0].code_phase_samples
    trk = gps_track(iq, fs, prn, doppler_hz, code_phase_samples,
                    device=device)
    return nav_subframes_decode(trk.nav_bits)
