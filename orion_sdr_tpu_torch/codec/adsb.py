"""ADS-B 1090ES (Mode S extended squitter, DO-260 / ICAO Annex 10) message
codec (counterpart of ``orion_sdr_tpu/codec/adsb.py``; host numpy, the
port's own copy, bit for bit the reference's). The PPM physical layer lives
in ``modulate/adsb.py`` and ``demodulate/adsb.py``.

* Mode S CRC-24 (generator 0xFFF409) over the first 88 bits of a 112-bit
  DF17 frame.
* DF17 ME payloads: aircraft identification (TC 1-4, 6-bit charset),
  airborne position (TC 9-18: 12-bit Q-altitude + CPR even/odd), airborne
  velocity (TC 19 subtype 1, ground speed).
* CPR airborne encode + globally-unambiguous even/odd pair decode (NZ=15).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

ADSB_CRC_POLY = 0xFFF409
ADSB_FRAME_BITS = 112
_NZ = 15
_CHARSET = ("#ABCDEFGHIJKLMNOPQRSTUVWXYZ#####"
            " ###############0123456789######")


def adsb_crc24(bits) -> int:
    """Mode S parity: remainder of msg(x)·x²⁴ mod G(x) over the given bits
    (MSB-first)."""
    b = np.asarray(bits, np.uint8) & 1
    reg = 0
    for bit in b:
        reg = ((reg << 1) | int(bit)) & 0xFFFFFFFF
        if reg & (1 << 24):
            reg ^= (1 << 24) | ADSB_CRC_POLY
    for _ in range(24):
        reg = (reg << 1) & 0xFFFFFFFF
        if reg & (1 << 24):
            reg ^= (1 << 24) | ADSB_CRC_POLY
    return reg & 0xFFFFFF


def _put(bits, start, width, value):
    for j in range(width):
        bits[start + j] = (value >> (width - 1 - j)) & 1


def _get(bits, start, width) -> int:
    v = 0
    for j in range(width):
        v = (v << 1) | int(bits[start + j])
    return v


# ── CPR (compact position reporting), airborne, NZ = 15 ──────────────────────


def _cpr_nl(lat: float) -> int:
    """Longitude-zone count NL(lat) — closed form from the CPR spec."""
    if abs(lat) >= 87.0:
        return 1 if abs(lat) > 87.0 else 2
    if lat == 0.0:
        return 59
    a = 1.0 - np.cos(np.pi / (2.0 * _NZ))
    b = np.cos(np.pi / 180.0 * abs(lat)) ** 2
    return int(np.floor(2.0 * np.pi
                        / np.arccos(1.0 - a / b)))


def cpr_encode(lat: float, lon: float, odd: int) -> Tuple[int, int]:
    """(lat, lon) degrees → 17-bit (YZ, XZ) for the even (0) / odd (1)
    frame."""
    dlat = 360.0 / (4.0 * _NZ - odd)
    yz = int(np.floor(131072.0 * (lat % dlat) / dlat + 0.5)) % 131072
    rlat = dlat * (yz / 131072.0 + np.floor(lat / dlat))
    nl = _cpr_nl(rlat)
    n_lon = max(nl - odd, 1)
    dlon = 360.0 / n_lon
    xz = int(np.floor(131072.0 * (lon % dlon) / dlon + 0.5)) % 131072
    return yz, xz


def cpr_decode_global(even: Tuple[int, int], odd: Tuple[int, int],
                      most_recent_odd: bool = False
                      ) -> Optional[Tuple[float, float]]:
    """One even + one odd (YZ, XZ) pair → unambiguous (lat, lon), or None
    when the pair straddles a latitude-zone boundary."""
    yz0, xz0 = even
    yz1, xz1 = odd
    dlat0 = 360.0 / (4 * _NZ)
    dlat1 = 360.0 / (4 * _NZ - 1)
    j = int(np.floor((59.0 * yz0 - 60.0 * yz1) / 131072.0 + 0.5))
    lat0 = dlat0 * ((j % 60) + yz0 / 131072.0)
    lat1 = dlat1 * ((j % 59) + yz1 / 131072.0)
    if lat0 >= 270.0:
        lat0 -= 360.0
    if lat1 >= 270.0:
        lat1 -= 360.0
    if _cpr_nl(lat0) != _cpr_nl(lat1):
        return None
    if most_recent_odd:
        lat, nl, i_odd, xz = lat1, _cpr_nl(lat1), 1, xz1
    else:
        lat, nl, i_odd, xz = lat0, _cpr_nl(lat0), 0, xz0
    m = int(np.floor((xz0 * (nl - 1) - xz1 * nl) / 131072.0 + 0.5))
    n_lon = max(nl - i_odd, 1)
    dlon = 360.0 / n_lon
    lon = dlon * ((m % n_lon) + xz / 131072.0)
    if lon >= 180.0:
        lon -= 360.0
    return lat, lon


# ── DF17 frames ──────────────────────────────────────────────────────────────


@dataclass
class AdsbMessage:
    """Decoded DF17 content (fields None unless that message type)."""
    icao: int
    type_code: int
    callsign: Optional[str] = None
    altitude_ft: Optional[int] = None
    cpr: Optional[Tuple[int, int, int]] = None      # (odd, YZ, XZ)
    ground_speed_kt: Optional[float] = None
    track_deg: Optional[float] = None
    position: Optional[Tuple[float, float]] = None  # filled by pair decode


def _frame(icao: int, me_bits: np.ndarray) -> np.ndarray:
    bits = np.zeros(ADSB_FRAME_BITS, np.uint8)
    _put(bits, 0, 5, 17)                       # DF17
    _put(bits, 5, 3, 5)                        # CA
    _put(bits, 8, 24, icao & 0xFFFFFF)
    bits[32:88] = me_bits
    _put(bits, 88, 24, adsb_crc24(bits[:88]))
    return bits


def adsb_encode_identification(icao: int, callsign: str,
                               type_code: int = 4) -> np.ndarray:
    """→ 112 frame bits carrying an 8-char callsign."""
    me = np.zeros(56, np.uint8)
    _put(me, 0, 5, type_code)
    _put(me, 5, 3, 0)
    cs = (callsign.upper() + " " * 8)[:8]
    for i, ch in enumerate(cs):
        code = _CHARSET.index(ch) if ch in _CHARSET else 32
        _put(me, 8 + 6 * i, 6, code)
    return _frame(icao, me)


def adsb_encode_position(icao: int, lat: float, lon: float, alt_ft: int,
                         odd: int, type_code: int = 11) -> np.ndarray:
    """→ 112 frame bits: Q-bit altitude + CPR even/odd position."""
    me = np.zeros(56, np.uint8)
    _put(me, 0, 5, type_code)
    n = int(round((alt_ft + 1000) / 25.0))
    raw11 = n & 0x7FF
    alt12 = ((raw11 & 0x7F0) << 1) | 0x010 | (raw11 & 0x00F)  # Q-bit set
    _put(me, 8, 12, alt12)
    _put(me, 21, 1, odd & 1)
    yz, xz = cpr_encode(lat, lon, odd & 1)
    _put(me, 22, 17, yz)
    _put(me, 39, 17, xz)
    return _frame(icao, me)


def adsb_encode_velocity(icao: int, gs_kt: float, track_deg: float,
                         ) -> np.ndarray:
    """→ 112 frame bits: TC19 subtype-1 ground velocity."""
    me = np.zeros(56, np.uint8)
    _put(me, 0, 5, 19)
    _put(me, 5, 3, 1)
    rad = np.deg2rad(track_deg)
    v_ew = gs_kt * np.sin(rad)
    v_ns = gs_kt * np.cos(rad)
    _put(me, 13, 1, 1 if v_ew < 0 else 0)      # west
    _put(me, 14, 10, min(int(round(abs(v_ew))) + 1, 1023))
    _put(me, 24, 1, 1 if v_ns < 0 else 0)      # south
    _put(me, 25, 10, min(int(round(abs(v_ns))) + 1, 1023))
    return _frame(icao, me)


def adsb_decode_frame(bits) -> Optional[AdsbMessage]:
    """112 frame bits → AdsbMessage | None (CRC or format failure)."""
    b = np.asarray(bits, np.uint8) & 1
    if len(b) != ADSB_FRAME_BITS:
        return None
    if _get(b, 0, 5) != 17:
        return None
    if adsb_crc24(b[:88]) != _get(b, 88, 24):
        return None
    icao = _get(b, 8, 24)
    me = b[32:88]
    tc = _get(me, 0, 5)
    msg = AdsbMessage(icao=icao, type_code=tc)
    if 1 <= tc <= 4:
        msg.callsign = "".join(
            _CHARSET[_get(me, 8 + 6 * i, 6)] for i in range(8)).rstrip()
    elif 9 <= tc <= 18:
        alt12 = _get(me, 8, 12)
        if alt12 & 0x010:                        # Q-bit
            n = ((alt12 & 0xFE0) >> 1) | (alt12 & 0x00F)
            msg.altitude_ft = n * 25 - 1000
        msg.cpr = (_get(me, 21, 1), _get(me, 22, 17), _get(me, 39, 17))
    elif tc == 19 and _get(me, 5, 3) == 1:
        sew = -1 if _get(me, 13, 1) else 1
        vew = _get(me, 14, 10) - 1
        sns = -1 if _get(me, 24, 1) else 1
        vns = _get(me, 25, 10) - 1
        if vew >= 0 and vns >= 0:
            vx, vy = sew * vew, sns * vns
            msg.ground_speed_kt = float(np.hypot(vx, vy))
            msg.track_deg = float(np.rad2deg(np.arctan2(vx, vy)) % 360.0)
    return msg


def adsb_pair_positions(messages: List[AdsbMessage]) -> None:
    """Fill ``position`` on position messages by globally decoding each
    aircraft's most recent even/odd CPR pair (in-place)."""
    last: dict = {}
    for m in messages:
        if m.cpr is None:
            continue
        odd, yz, xz = m.cpr
        last.setdefault(m.icao, {})[odd] = (yz, xz)
        pair = last[m.icao]
        if 0 in pair and 1 in pair:
            pos = cpr_decode_global(pair[0], pair[1],
                                    most_recent_odd=bool(odd))
            if pos is not None:
                m.position = pos
