"""AIS (marine Automatic Identification System, ITU-R M.1371) message
codec (the port's own copy of ``orion_sdr_tpu/codec/ais.py``, numpy,
bit-exact with it). Position report types 1–3: 168-bit payload over the
shared HDLC layer (same flags, stuffing, and CRC-16/X.25 as AX.25), GMSK
physical layer in modulate/ais.py / demodulate/ais.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

AIS_POSITION_BITS = 168


def _put(bits, start, width, value):
    v = int(value) & ((1 << width) - 1)
    for j in range(width):
        bits[start + j] = (v >> (width - 1 - j)) & 1


def _get(bits, start, width, signed=False) -> int:
    v = 0
    for j in range(width):
        v = (v << 1) | int(bits[start + j])
    if signed and v >= 1 << (width - 1):
        v -= 1 << width
    return v


@dataclass
class AisPosition:
    """Type 1-3 position report (the fields receivers care about)."""
    mmsi: int
    lat: float                   # degrees
    lon: float                   # degrees
    sog_kt: float = 0.0
    cog_deg: float = 0.0
    heading_deg: Optional[int] = None
    nav_status: int = 0
    msg_type: int = 1


def ais_encode_position(p: AisPosition) -> np.ndarray:
    """AisPosition → 168 payload bits (fields big-endian per M.1371)."""
    bits = np.zeros(AIS_POSITION_BITS, np.uint8)
    _put(bits, 0, 6, p.msg_type)
    _put(bits, 6, 2, 0)                                # repeat
    _put(bits, 8, 30, p.mmsi)
    _put(bits, 38, 4, p.nav_status)
    _put(bits, 42, 8, 0x80)                            # ROT not available
    _put(bits, 50, 10, min(int(round(p.sog_kt * 10)), 1022))
    _put(bits, 60, 1, 1)                               # high accuracy
    _put(bits, 61, 28, int(round(p.lon * 600_000.0)))
    _put(bits, 89, 27, int(round(p.lat * 600_000.0)))
    _put(bits, 116, 12, int(round(p.cog_deg * 10)) % 3600)
    _put(bits, 128, 9, 511 if p.heading_deg is None
         else int(p.heading_deg) % 360)
    _put(bits, 137, 6, 60)                             # ts not available
    # maneuver(2) + spare(3) + RAIM(1) + radio(19) stay zero
    return bits


def ais_parse(bits) -> Optional[AisPosition]:
    """168 payload bits → AisPosition | None (non-position types)."""
    b = np.asarray(bits, np.uint8) & 1
    if len(b) < AIS_POSITION_BITS:
        return None
    t = _get(b, 0, 6)
    if t not in (1, 2, 3):
        return None
    hdg = _get(b, 128, 9)
    return AisPosition(
        mmsi=_get(b, 8, 30),
        nav_status=_get(b, 38, 4),
        sog_kt=_get(b, 50, 10) / 10.0,
        lon=_get(b, 61, 28, signed=True) / 600_000.0,
        lat=_get(b, 89, 27, signed=True) / 600_000.0,
        cog_deg=_get(b, 116, 12) / 10.0,
        heading_deg=None if hdg == 511 else hdg,
        msg_type=t)


def ais_payload_to_bytes(bits) -> bytes:
    """168 payload bits → 21 frame bytes (MSB-first packing; the HDLC
    layer then serializes bytes LSB-first — a fixed, self-consistent
    convention)."""
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def ais_bytes_to_payload(data: bytes) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data[:21], np.uint8))


def ais_frames_to_bits(payloads: List[np.ndarray]) -> np.ndarray:
    """Payload bit arrays → one HDLC bit stream with the AIS 24-bit
    0101… training sequence up front (FCS appended per frame)."""
    from .ax25 import ax25_crc, hdlc_encode
    frames = []
    for p in payloads:
        body = ais_payload_to_bytes(p)
        fcs = ax25_crc(body)
        frames.append(body + bytes([fcs & 0xFF, (fcs >> 8) & 0xFF]))
    train = np.tile(np.uint8([0, 1]), 12)
    return np.concatenate([train, hdlc_encode(frames, lead_flags=1,
                                              tail_flags=2, inter_flags=2)])


def ais_bits_to_positions(bits) -> List[AisPosition]:
    """HDLC bit stream → decoded position reports (FCS-gated)."""
    from .ax25 import hdlc_frames_raw
    out = []
    for raw, _pos in hdlc_frames_raw(bits):
        if len(raw) != 21 + 2:
            continue
        got = ais_parse(ais_bytes_to_payload(raw[:-2]))
        if got is not None:
            out.append(got)
    return out
