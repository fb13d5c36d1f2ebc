"""WSPR weak-signal beacon, wire-compatible with the published protocol
(the port's own copy of ``orion_sdr_tpu/codec/wspr.py``, numpy,
bit-exact with it). Every layer follows the standard coding process (G4JNT, "The WSPR Coding
Process"; WSJT-X): callsign/grid/power → 50 bits, rate-1/2 K=32
convolution with the Layland–Lushbaugh polynomials 0xF2D05351/0xE4613C47,
bit-reversed-address interleaving, and the PUBLISHED 162-chip pseudo-random
sync vector, so standard WSPR transmissions encode/decode byte-exactly.
Decoding uses this framework's K=32 SEQUENTIAL (stack) decoder
(fec/sequential.py) instead of WSJT-X's Fano decoder — same code, a
different search.

Physical layer: 162 symbols, 4 tones at fs/8192 spacing, 8192 samples per
symbol at 12 kHz (≈110.6 s); tone = sync_chip + 2·coded_bit (standard).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..fec.sequential import conv_encode_long, stack_decode

WSPR_SYMBOLS = 162
WSPR_INFO_BITS = 50
WSPR_SPS = 8192
WSPR_FS = 12_000.0

_CALL_CHARS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ "

# The published 162-symbol WSPR synchronisation vector (G4JNT "The WSPR
# Coding Process" §Synchronisation; identical table in WSJT-X and the
# independent encoder implementations). A spec wire constant, like the
# FT8 LDPC tables — keep bit-exact; test_wspr.py guards it.
WSPR_SYNC = np.array([
    1, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0,
    0, 1, 0, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1,
    0, 0, 0, 0, 0, 0, 1, 0, 1, 1, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1,
    1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 1, 0, 1, 0, 0, 1,
    0, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 0, 0, 0, 1, 0,
    0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1,
    0, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 1,
    0, 0, 0, 0, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 0, 0, 1, 1, 0,
    0, 0], np.uint8)


def _interleave_map() -> np.ndarray:
    """Bit-reversed-address interleaver: destination order = the first 162
    bit-reversed 8-bit values (the published WSPR scheme)."""
    dest = []
    for i in range(256):
        r = int(f"{i:08b}"[::-1], 2)
        if r < WSPR_SYMBOLS:
            dest.append(r)
    return np.asarray(dest, np.int64)


_IL = _interleave_map()


def wspr_pack(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """(callsign ≤6, 4-char grid, power dBm 0..60) → 50 bits."""
    cs = callsign.upper().strip()
    # pad so the third character is the digit (standard alignment)
    if len(cs) < 3 or not cs[2].isdigit():
        if len(cs) >= 2 and cs[1].isdigit():
            cs = " " + cs
        else:
            raise ValueError("callsign needs a digit in position 2 or 3")
    cs = cs.ljust(6)
    if len(cs) != 6:
        raise ValueError("callsign too long")

    n = _CALL_CHARS.index(cs[0])                 # 0-9, A-Z, space
    c1 = _CALL_CHARS.index(cs[1])
    if c1 >= 36:
        raise ValueError("callsign char 2 cannot be a space")
    n = n * 36 + c1
    n = n * 10 + int(cs[2])
    for j in (3, 4, 5):
        c = cs[j]
        v = 26 if c == " " else ord(c) - ord("A")
        if not (0 <= v <= 26):
            raise ValueError(f"bad callsign suffix char {c!r}")
        n = n * 27 + v

    g = grid.upper()
    if len(g) != 4 or not (g[0].isalpha() and g[1].isalpha()
                           and g[2].isdigit() and g[3].isdigit()):
        raise ValueError("grid must be a 4-character locator like FN42")
    lon = (ord(g[0]) - ord("A")) * 20 + int(g[2]) * 2 - 180
    lat = (ord(g[1]) - ord("A")) * 10 + int(g[3]) - 90
    m = (179 - lon) // 2 * 180 + (lat + 90)
    m = m * 128 + min(max(int(dbm), 0), 60) + 64

    bits = np.zeros(WSPR_INFO_BITS, np.uint8)
    for j in range(28):
        bits[j] = (n >> (27 - j)) & 1
    for j in range(22):
        bits[28 + j] = (m >> (21 - j)) & 1
    return bits


@dataclass
class WsprMessage:
    callsign: str
    grid: str
    dbm: int


def wspr_unpack(bits) -> Optional[WsprMessage]:
    b = np.asarray(bits, np.uint8) & 1
    n = 0
    for j in range(28):
        n = (n << 1) | int(b[j])
    m = 0
    for j in range(22):
        m = (m << 1) | int(b[28 + j])
    suffix = []
    for _ in range(3):
        v = n % 27
        n //= 27
        suffix.append(" " if v == 26 else chr(ord("A") + v))
    d2 = n % 10
    n //= 10
    c1 = n % 36
    n //= 36
    if n >= 37:
        return None
    cs = (_CALL_CHARS[n] + _CALL_CHARS[c1] + str(d2)
          + "".join(reversed(suffix))).strip()
    pw = m % 128 - 64
    m //= 128
    lat = m % 180 - 90
    lon = 179 - (m // 180) * 2 - 1
    if not (-180 <= lon < 180 and -90 <= lat < 90):
        return None
    g = (chr(ord("A") + (lon + 180) // 20)
         + chr(ord("A") + (lat + 90) // 10)
         + str(((lon + 180) % 20) // 2) + str((lat + 90) % 10))
    if not (0 <= pw <= 60):
        return None
    return WsprMessage(callsign=cs, grid=g, dbm=pw)


def wspr_symbols(callsign: str, grid: str, dbm: int) -> np.ndarray:
    """Message → 162 channel tones (0..3)."""
    coded = conv_encode_long(wspr_pack(callsign, grid, dbm))
    inter = np.zeros(WSPR_SYMBOLS, np.uint8)
    inter[_IL] = coded
    return (WSPR_SYNC + 2 * inter).astype(np.uint8)


def wspr_decode_symbols(tone_energies) -> Optional[WsprMessage]:
    """(162, 4) tone energies → message (sync chips known per symbol:
    the data LLR compares tone sync vs sync+2)."""
    e = np.asarray(tone_energies, np.float32)
    s = WSPR_SYNC.astype(np.int64)
    e0 = e[np.arange(WSPR_SYMBOLS), s]          # data bit 0
    e1 = e[np.arange(WSPR_SYMBOLS), s + 2]      # data bit 1
    scale = np.median(np.abs(e1 - e0)) + 1e-12
    llr_inter = (e0 - e1) / scale * 2.0         # positive ⇒ bit 0
    llr = llr_inter[_IL]                        # deinterleave
    bits = stack_decode(llr, WSPR_INFO_BITS)
    if bits is None:
        return None
    return wspr_unpack(bits)
