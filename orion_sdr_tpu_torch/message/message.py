"""FT8 77-bit message packing (counterpart of
``orion_sdr_tpu/message/message.py``; behavioral spec: message/message.rs;
bit-exact to ft8_lib). Messages are small dataclasses; pack77/unpack77 map
them to/from the 10-byte payload fed to the FT8/FT4 codecs."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from .callsign import CallsignHashTable, pack28, pack58, unpack28, unpack58
from .free_text import decode_free_text, encode_free_text
from .grid import packgrid, unpackgrid

Payload77 = np.ndarray  # 10 bytes, MSB-first, bits 77-79 of byte 9 zero


@dataclass
class Standard:
    """i3=1/2: two callsigns + grid/report/token extra."""
    call_to: str
    call_de: str
    extra: str = ""


@dataclass
class FreeText:
    text: str


@dataclass
class NonStd:
    """i3=4: one 58-bit nonstandard callsign + one 12-bit hashed callsign."""
    call_to: str
    call_de: str
    extra: str = ""       # "", "RRR", "RR73", "73"


@dataclass
class Telemetry:
    data: np.ndarray      # 9 bytes (71 bits)


@dataclass
class Unknown:
    payload: np.ndarray


Ft8Message = Union[Standard, FreeText, NonStd, Telemetry, Unknown]

_NRPT = {"": 0, "RRR": 1, "RR73": 2, "73": 3}
_NRPT_INV = {v: k for k, v in _NRPT.items()}


def _as_bytes(data) -> bytes:
    """Accept bytes/bytearray or any uint8 array-like (drop-in ergonomics:
    the reference bindings take bytes-like payloads)."""
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    return bytes(np.asarray(data, np.uint8))


def _bits_to_payload(v: int) -> Payload77:
    return np.frombuffer(v.to_bytes(10, "big"), np.uint8).copy()


def pack77(msg: Ft8Message, ht: Optional[CallsignHashTable] = None
           ) -> Optional[Payload77]:
    """Message → 77-bit payload (10 bytes), or None if unencodable."""
    ht = ht if ht is not None else CallsignHashTable()
    if isinstance(msg, Standard):
        return _pack_standard(msg, ht)
    if isinstance(msg, FreeText):
        b71 = encode_free_text(msg.text)
        if b71 is None:
            return None
        v = int.from_bytes(bytes(b71), "big") << 1   # left-shift into bits 0-70
        return _bits_to_payload(v << 8)              # i3=0, n3=0
    if isinstance(msg, NonStd):
        return _pack_nonstd(msg, ht)
    if isinstance(msg, Telemetry):
        v = int.from_bytes(_as_bytes(msg.data), "big")
        v &= (1 << 71) - 1   # top bit of data[0] is outside the 71-bit field
        p = _bits_to_payload((v << 1) << 8)
        p[8] |= 0x01                   # n3 bit 2
        p[9] = 0b01 << 6               # n3 low bits = 01 → n3=5; i3=0
        return p
    if isinstance(msg, Unknown):
        return np.asarray(msg.payload, np.uint8).copy()
    return None


def _pack_standard(msg: Standard, ht: CallsignHashTable) -> Optional[Payload77]:
    ra = pack28(msg.call_to, ht)
    rb = pack28(msg.call_de, ht)
    if ra is None or rb is None:
        return None
    (n28a, ipa), (n28b, ipb) = ra, rb
    i3 = 2 if (msg.call_to.endswith("/P") or msg.call_de.endswith("/P")) else 1
    n29a = (n28a << 1) | int(ipa)
    n29b = (n28b << 1) | int(ipb)
    igrid4, ir = packgrid(msg.extra)
    v = (n29a << 48) | (n29b << 19) | (int(ir) << 18) | (igrid4 << 3) | i3
    return _bits_to_payload(v << 3)   # 77 bits → left-aligned in 80


def _pack_nonstd(msg: NonStd, ht: CallsignHashTable) -> Optional[Payload77]:
    i3 = 4
    icq = 1 if (msg.call_to == "CQ" or msg.call_to.startswith("CQ ")) else 0
    if icq:
        iflip, n12 = 0, 0
        call58 = msg.call_de
    else:
        iflip = 0
        _, n12, _ = ht.save(msg.call_to)
        call58 = msg.call_de
    n58 = pack58(call58, ht)
    if n58 is None:
        return None
    nrpt = 0 if icq else _NRPT.get(msg.extra, 0)
    v = (n12 << 65) | (n58 << 7) | (iflip << 6) | (nrpt << 4) | (icq << 3) | i3
    return _bits_to_payload(v << 3)


def unpack77(payload, ht: Optional[CallsignHashTable] = None) -> Ft8Message:
    """77-bit payload → decoded message."""
    ht = ht if ht is not None else CallsignHashTable()
    if isinstance(payload, (bytes, bytearray, memoryview)):
        p = np.frombuffer(bytes(payload), np.uint8)
    else:
        p = np.asarray(payload, np.uint8)
    i3 = (int(p[9]) >> 3) & 0x07
    n3 = ((int(p[8]) << 2) | (int(p[9]) >> 6)) & 0x07
    v = int.from_bytes(bytes(p), "big") >> 3   # the 77 bits, right-aligned

    if i3 == 0:
        b71 = np.frombuffer(((v >> 6) & ((1 << 71) - 1)).to_bytes(9, "big"),
                            np.uint8).copy()
        if n3 == 0:
            return FreeText(decode_free_text(b71))
        if n3 == 5:
            return Telemetry(b71)
        return Unknown(p.copy())
    if i3 in (1, 2):
        n29a = (v >> 48) & ((1 << 29) - 1)
        n29b = (v >> 19) & ((1 << 29) - 1)
        ir = bool((v >> 18) & 1)
        igrid4 = (v >> 3) & 0x7FFF
        call_to = unpack28(n29a >> 1, bool(n29a & 1), i3, ht) or "<?>"
        call_de = unpack28(n29b >> 1, bool(n29b & 1), i3, ht) or "<?>"
        return Standard(call_to, call_de, unpackgrid(igrid4, ir))
    if i3 == 4:
        n12 = (v >> 65) & 0xFFF
        n58 = (v >> 7) & ((1 << 58) - 1)
        iflip = (v >> 6) & 1
        nrpt = (v >> 4) & 0x3
        icq = (v >> 3) & 1
        decoded = unpack58(n58)
        hashed_name = ht.lookup_n12(n12)
        hashed = f"<{hashed_name}>" if hashed_name else "<...>"
        call_to, call_de = (hashed, decoded) if iflip == 0 else (decoded, hashed)
        if icq:
            call_to = "CQ"
        return NonStd(call_to, call_de, _NRPT_INV.get(nrpt, ""))
    return Unknown(p.copy())


# ── reference drop-in convenience wrappers (python/ft8.rs:386-505) ───────────


def ft8_pack_standard(call_to: str, call_de: str, extra: str = "") -> bytes:
    """Standard message → 10-byte payload; raises ValueError if unencodable."""
    p = pack77(Standard(call_to, call_de, extra), CallsignHashTable())
    if p is None:
        raise ValueError("ft8_pack_standard: failed to pack message")
    return bytes(p)


def ft8_pack_free_text(text: str) -> bytes:
    """Free text (≤13 chars of the base-42 alphabet) → 10-byte payload."""
    p = pack77(FreeText(text), CallsignHashTable())
    if p is None:
        raise ValueError(
            "ft8_pack_free_text: failed to pack message "
            "(text too long or invalid chars?)")
    return bytes(p)


def ft8_pack_telemetry(data) -> bytes:
    """9 bytes (71 bits, top bit masked) → 10-byte payload."""
    d = bytes(data)
    if len(d) != 9:
        raise ValueError(f"ft8_pack_telemetry: expected 9 bytes, got {len(d)}")
    p = pack77(Telemetry(np.frombuffer(d, np.uint8).copy()),
               CallsignHashTable())
    if p is None:
        raise ValueError("ft8_pack_telemetry: failed to pack message")
    return bytes(p)


def ft8_unpack(payload) -> dict:
    """10-byte payload → dict with a "type" key plus the message fields
    (mirrors the reference binding's return shape)."""
    d = bytes(payload)
    if len(d) != 10:
        raise ValueError(f"ft8_unpack: expected 10 bytes, got {len(d)}")
    msg = unpack77(np.frombuffer(d, np.uint8).copy(), CallsignHashTable())
    if isinstance(msg, Standard):
        return {"type": "standard", "call_to": msg.call_to,
                "call_de": msg.call_de, "extra": msg.extra}
    if isinstance(msg, FreeText):
        return {"type": "free_text", "text": msg.text}
    if isinstance(msg, Telemetry):
        return {"type": "telemetry", "data": bytes(msg.data)}
    if isinstance(msg, NonStd):
        return {"type": "nonstd", "call_to": msg.call_to,
                "call_de": msg.call_de, "extra": msg.extra}
    return {"type": "unknown"}
