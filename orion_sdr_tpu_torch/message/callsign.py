"""FT8 callsign packing (counterpart of ``orion_sdr_tpu/message/callsign.py``;
behavioral spec: message/callsign.rs; bit-exact to
ft8_lib): pack28/unpack28 standard calls + tokens, pack58/unpack58 base-38
nonstandard calls, 22-bit multiply-shift hash table."""

from __future__ import annotations

from typing import Optional, Tuple

from .tables import (nchar, charn, FULL, ALNUM_SPACE_SLASH, ALNUM_SPACE,
                     LETTERS_SPACE, ALNUM, NUMERIC)

NTOKENS = 2_063_592
MAX22 = 1 << 22


def hash22(call: str) -> int:
    """Base-38 encode (11 chars, space-padded) then multiply-shift."""
    n58 = 0
    chars = (call[:11] + " " * 11)[:11]
    for c in chars:
        j = nchar(c, ALNUM_SPACE_SLASH)
        n58 = 38 * n58 + (j if j is not None else 0)
    return ((47_055_833_459 * n58) >> (64 - 22)) & 0x3F_FFFF


class CallsignHashTable:
    """22-bit hash → callsign store (ref CallsignHashTable)."""

    def __init__(self) -> None:
        self._inner: dict[int, str] = {}

    def save(self, call: str) -> Tuple[int, int, int]:
        n22 = hash22(call)
        self._inner[n22] = call
        return n22, n22 >> 10, n22 >> 12

    def lookup_n22(self, n22: int) -> Optional[str]:
        return self._inner.get(n22)

    def lookup_n12(self, n12: int) -> Optional[str]:
        lo = n12 << 10
        for k, v in self._inner.items():
            if lo <= k < lo + 1024:
                return v
        return None


def pack_basecall(call: str) -> Optional[int]:
    """Standard 6-char basecall → packed int, or None."""
    n = len(call)
    if n <= 2:
        return None
    c6 = None
    if call.startswith("3DA0") and 4 < n <= 7:
        c6 = ("3D0" + call[4:]).ljust(6)            # Swaziland
    elif call.startswith("3X") and n >= 3 and call[2].isupper() and n <= 7:
        c6 = ("Q" + call[2:]).ljust(6)              # Guinea
    elif n >= 3 and call[2].isdigit() and n <= 6:
        c6 = call.ljust(6)
    elif n >= 2 and call[1].isdigit() and n <= 5:
        c6 = (" " + call).ljust(6)
    else:
        return None
    idx = [nchar(c6[0], ALNUM_SPACE), nchar(c6[1], ALNUM),
           nchar(c6[2], NUMERIC), nchar(c6[3], LETTERS_SPACE),
           nchar(c6[4], LETTERS_SPACE), nchar(c6[5], LETTERS_SPACE)]
    if any(i is None for i in idx):
        return None
    v = idx[0]
    for i, radix in zip(idx[1:], (36, 10, 27, 27, 27)):
        v = v * radix + i
    return v


def _unpack_basecall(n: int) -> Optional[str]:
    c5 = charn(n % 27, LETTERS_SPACE); n //= 27
    c4 = charn(n % 27, LETTERS_SPACE); n //= 27
    c3 = charn(n % 27, LETTERS_SPACE); n //= 27
    c2 = charn(n % 10, NUMERIC); n //= 10
    c1 = charn(n % 36, ALNUM); n //= 36
    c0 = charn(n % 37, ALNUM_SPACE)
    s = (c0 + c1 + c2 + c3 + c4 + c5).strip(" ")
    if s.startswith("3D0") and len(s) > 3:
        return "3DA0" + s[3:]
    if s.startswith("Q") and len(s) > 1 and s[1].isupper():
        return "3X" + s[1:]
    return s if len(s) >= 3 else None


def _parse_cq_modifier(s: str) -> Optional[int]:
    rest = s[3:].split(" ")[0]
    if len(rest) == 3 and rest.isdigit():
        return int(rest)
    if 1 <= len(rest) <= 4 and rest.isalpha() and rest.isupper():
        m = 0
        for c in rest:
            m = 27 * m + (ord(c) - ord("A") + 1)
        return 1000 + m
    return None


def pack28(call: str, ht: CallsignHashTable) -> Optional[Tuple[int, bool]]:
    """Callsign → (n28, ip). ip = /R or /P suffix present."""
    if call == "DE":
        return 0, False
    if call == "QRZ":
        return 1, False
    if call == "CQ":
        return 2, False
    if call.startswith("CQ ") and len(call) < 8:
        v = _parse_cq_modifier(call)
        return (3 + v, False) if v is not None else None
    base, ip = (call[:-2], True) if call.endswith(("/R", "/P")) else (call, False)
    n28 = pack_basecall(base)
    if n28 is not None:
        ht.save(call)
        return NTOKENS + MAX22 + n28, ip
    if 3 <= len(call) <= 11 and all(
            nchar(c, ALNUM_SPACE_SLASH) is not None for c in call):
        n22, _, _ = ht.save(call)
        return NTOKENS + n22, False
    return None


def unpack28(n28: int, ip: bool, i3: int, ht: CallsignHashTable) -> Optional[str]:
    if n28 < NTOKENS:
        if n28 <= 2:
            return ("DE", "QRZ", "CQ")[n28]
        if n28 <= 1002:
            return f"CQ {n28 - 3:03d}"
        if n28 <= 532_443:
            n = n28 - 1003
            s = ""
            for _ in range(4):
                s = charn(n % 27, LETTERS_SPACE) + s
                n //= 27
            return "CQ " + s.strip(" ")
        return None
    n28 -= NTOKENS
    if n28 < MAX22:
        found = ht.lookup_n22(n28)
        return f"<{found}>" if found else "<...>"
    call = _unpack_basecall(n28 - MAX22)
    if call is None:
        return None
    if ip:
        if i3 == 1:
            call += "/R"
        elif i3 == 2:
            call += "/P"
        else:
            return None
    return call


def pack58(call: str, ht: CallsignHashTable) -> Optional[int]:
    """Full callsign (≤11 chars) → 58-bit base-38 value."""
    src = call[1:-1] if call.startswith("<") and call.endswith(">") else call
    n58 = 0
    for c in src:
        j = nchar(c, ALNUM_SPACE_SLASH)
        if j is None:
            return None
        n58 = n58 * 38 + j
    ht.save(src)
    return n58


def unpack58(n58: int, ht: Optional[CallsignHashTable] = None) -> str:
    chars = []
    for _ in range(11):
        chars.append(charn(n58 % 38, ALNUM_SPACE_SLASH))
        n58 //= 38
    s = "".join(reversed(chars)).strip(" ")
    if ht is not None and len(s) >= 3:
        ht.save(s)
    return s
