"""POCSAG radio-paging codec, ITU-R M.584 / CCIR 584 (the port's own copy
of ``orion_sdr_tpu/codec/pocsag.py``, numpy, bit-exact with it). The FSK
physical layer lives in modulate/pocsag.py / demodulate/pocsag.py.

Structure: ≥576-bit 1010… preamble, then batches of one sync codeword
(0x7CD215D8) + 8 frames × 2 codewords. Each 32-bit codeword = flag bit
(0 address / 1 message) + 20 payload bits + BCH(31,21) checks
(g = x¹⁰+x⁹+x⁸+x⁶+x⁵+x³+1) + even parity. An address codeword carries
address[20:3] (the low 3 bits are the frame index) + 2 function bits;
message codewords pack 7-bit ASCII (alpha) or 4-bit BCD (numeric)
MSB-first through the 20-bit payloads.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

POCSAG_SYNC = 0x7CD215D8
POCSAG_IDLE = 0x7A89C197
_BCH_GEN = 0b11101101001          # g(x), degree 10
_BCD = "0123456789*U -)("


def _bch_checks(data21: int) -> int:
    """10 BCH check bits for the 21 data bits (data·x¹⁰ mod g)."""
    reg = data21 << 10
    for i in range(20, -1, -1):
        if reg & (1 << (i + 10)):
            reg ^= _BCH_GEN << i
    return reg & 0x3FF


def pocsag_codeword(flag: int, payload20: int) -> int:
    """flag + 20 payload bits → full 32-bit codeword (BCH + even parity)."""
    data21 = ((flag & 1) << 20) | (payload20 & 0xFFFFF)
    cw31 = (data21 << 10) | _bch_checks(data21)
    parity = bin(cw31).count("1") & 1
    return (cw31 << 1) | parity


def pocsag_check(cw: int) -> Optional[int]:
    """Validate/correct a received 32-bit codeword → corrected 31-bit
    payload+checks (parity stripped) or None. Corrects 1-bit errors by
    syndrome search (BCH(31,21) dmin = 5 allows 2; single covers the
    operating point and keeps the table tiny)."""
    cw31 = cw >> 1
    synd = 0
    reg = cw31
    for i in range(30, 9, -1):
        if reg & (1 << i):
            reg ^= _BCH_GEN << (i - 10)
    synd = reg & 0x3FF
    if synd == 0:
        # clean BCH with wrong overall parity = the parity bit itself
        # flipped — still a 1-bit error, the 31 payload+check bits are
        # intact, so accept
        return cw31
    for bit in range(31):
        flipped = cw31 ^ (1 << bit)
        reg = flipped
        for i in range(30, 9, -1):
            if reg & (1 << i):
                reg ^= _BCH_GEN << (i - 10)
        if (reg & 0x3FF) == 0:
            return flipped
    return None


@dataclass
class PocsagPage:
    address: int
    function: int
    text: Optional[str] = None        # alpha pages
    digits: Optional[str] = None      # numeric pages


def _pack_payload_bits(bits: List[int]) -> List[int]:
    """Bit list → 20-bit message payloads (idle-padded)."""
    out = []
    for i in range(0, len(bits), 20):
        chunk = bits[i:i + 20]
        chunk += [0] * (20 - len(chunk))
        v = 0
        for b in chunk:
            v = (v << 1) | (b & 1)
        out.append(v)
    return out


def pocsag_encode_batches(pages: List[PocsagPage]) -> List[int]:
    """Pages → flat codeword list (sync words included), addresses slotted
    at frame = address & 7 per the spec."""
    words: List[int] = []
    slots: List[int] = []             # flat 16-slot batches, idle-filled

    def ensure(idx):
        while len(slots) <= idx:
            slots.append(POCSAG_IDLE)

    cursor = 0
    for p in pages:
        frame = p.address & 7
        # next slot at/after cursor whose frame index matches
        start = cursor
        while True:
            batch, slot = divmod(start, 16)
            if slot // 2 == frame and slots[start:start + 1] in (
                    [], [POCSAG_IDLE]):
                break
            start += 1
        ensure(start)
        addr_payload = (((p.address >> 3) & 0x3FFFF) << 2) | (p.function & 3)
        slots[start] = pocsag_codeword(0, addr_payload)
        cursor = start + 1
        if p.text is not None:
            bits = []
            for ch in p.text:
                c = ord(ch) & 0x7F
                bits.extend((c >> j) & 1 for j in range(7))   # LSB-first
            payloads = _pack_payload_bits(bits)
        elif p.digits is not None:
            bits = []
            for ch in p.digits:
                c = _BCD.index(ch) if ch in _BCD else 10
                bits.extend((c >> (3 - j)) & 1 for j in range(4))
            while len(bits) % 20:
                bits.extend((1, 1, 0, 0))      # BCD pad = space (0b1100)
            payloads = _pack_payload_bits(bits)
        else:
            payloads = []
        for pay in payloads:
            ensure(cursor)
            slots[cursor] = pocsag_codeword(1, pay)
            cursor += 1
    # pad to whole batches
    while len(slots) % 16:
        slots.append(POCSAG_IDLE)
    for b in range(len(slots) // 16):
        words.append(POCSAG_SYNC)
        words.extend(slots[16 * b:16 * (b + 1)])
    return words


def pocsag_decode_words(words: List[Optional[int]]) -> List[PocsagPage]:
    """Validated 31-bit words (None = uncorrectable) in batch order →
    pages. ``words`` excludes sync codewords; the caller supplies the slot
    index stream so frame positions are implicit (slot // 2) & 7... here
    simply (index % 16) // 2."""
    pages: List[PocsagPage] = []
    cur: Optional[PocsagPage] = None
    cur_bits: List[int] = []

    def finish():
        nonlocal cur, cur_bits
        if cur is None:
            return
        if cur_bits:
            # try alpha (7-bit LSB-first); fall back to numeric per function
            if cur.function == 0:
                digs = []
                for i in range(0, len(cur_bits) - 3, 4):
                    v = 0
                    for j in range(4):
                        v = (v << 1) | cur_bits[i + j]
                    digs.append(_BCD[v])
                cur.digits = "".join(digs).rstrip(" ")
            else:
                chars = []
                for i in range(0, len(cur_bits) - 6, 7):
                    c = 0
                    for j in range(7):
                        c |= cur_bits[i + j] << j
                    chars.append(chr(c))
                text = "".join(chars)
                cur.text = text.split("\x04")[0].rstrip("\x00\x17 ")
        pages.append(cur)
        cur, cur_bits = None, []

    for idx, w in enumerate(words):
        if w is None:
            continue
        data21 = w >> 10
        flag = (data21 >> 20) & 1
        payload = data21 & 0xFFFFF
        if w == (POCSAG_IDLE >> 1):
            finish()
            continue
        if flag == 0:
            finish()
            frame = (idx % 16) // 2
            address = (((payload >> 2) & 0x3FFFF) << 3) | frame
            cur = PocsagPage(address=address, function=payload & 3)
        else:
            if cur is not None:
                cur_bits.extend((payload >> (19 - j)) & 1
                                for j in range(20))
    finish()
    return pages
