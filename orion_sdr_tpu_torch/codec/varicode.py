"""IZ8BLY / G3PLX Varicode for PSK31 (counterpart of
``orion_sdr_tpu/codec/varicode.py``, a numpy copy; behavioral spec:
codec/varicode.rs).

Text-domain codec, host-side Python/numpy (31.25 baud text is not device
work). Each ASCII character (0-127) maps to a codeword of 1-10 bits,
MSB first, with no "00" pair inside; characters are separated by two 0
bits on the wire. Table: Peter Martinez G3PLX, "PSK31: A New
Radio-Teletype Mode" (1998), as published in the fldigi source
(varicode.cxx).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, List, Optional, Tuple

import numpy as np

VARICODE_MAX_BITS = 10

# (codeword, length) per ASCII value 0..127; codeword is MSB-first so bit
# (length-1) is transmitted first. Canonical G3PLX/fldigi table.
VARICODE: List[Tuple[int, int]] = [
    (0b1010101011, 10), (0b1011011011, 10), (0b1011101101, 10), (0b1101110111, 10),
    (0b1011101011, 10), (0b1101011111, 10), (0b1011101111, 10), (0b1011111101, 10),
    (0b1011111111, 10), (0b11101111, 8), (0b11101, 5), (0b1101101111, 10),
    (0b1011011101, 10), (0b11111, 5), (0b1101110101, 10), (0b1110101011, 10),
    (0b1011110111, 10), (0b1011110101, 10), (0b1110101101, 10), (0b1110101111, 10),
    (0b1101011011, 10), (0b1101101011, 10), (0b1101101101, 10), (0b1101010111, 10),
    (0b1101111011, 10), (0b1101111101, 10), (0b1110110111, 10), (0b1101010101, 10),
    (0b1101011101, 10), (0b1110111011, 10), (0b1011111011, 10), (0b1101111111, 10),
    (0b1, 1), (0b111111111, 9), (0b101011111, 9), (0b111110101, 9),
    (0b111011011, 9), (0b1011010101, 10), (0b1010111011, 10), (0b101111111, 9),
    (0b11111011, 8), (0b11110111, 8), (0b101101111, 9), (0b111011111, 9),
    (0b1110101, 7), (0b110101, 6), (0b1010111, 7), (0b110101111, 9),
    (0b10110111, 8), (0b10111101, 8), (0b11101101, 8), (0b11111111, 8),
    (0b101110111, 9), (0b101011011, 9), (0b101101011, 9), (0b110101101, 9),
    (0b110101011, 9), (0b110110111, 9), (0b11110101, 8), (0b110111101, 9),
    (0b111101101, 9), (0b1010101, 7), (0b111010111, 9), (0b1010101111, 10),
    (0b1010111101, 10), (0b1111101, 7), (0b11101011, 8), (0b10101101, 8),
    (0b10110101, 8), (0b1110111, 7), (0b11011011, 8), (0b11111101, 8),
    (0b101010101, 9), (0b1111111, 7), (0b111111101, 9), (0b101111101, 9),
    (0b11010111, 8), (0b10111011, 8), (0b11011101, 8), (0b10101011, 8),
    (0b11010101, 8), (0b111011101, 9), (0b10101111, 8), (0b1101111, 7),
    (0b1101101, 7), (0b101010111, 9), (0b110110101, 9), (0b101011101, 9),
    (0b101110101, 9), (0b101111011, 9), (0b1010101101, 10), (0b111110111, 9),
    (0b111101111, 9), (0b111111011, 9), (0b1010111111, 10), (0b101101101, 9),
    (0b1011011111, 10), (0b1011, 4), (0b1011111, 7), (0b101111, 6),
    (0b101101, 6), (0b11, 2), (0b111101, 6), (0b1011011, 7),
    (0b101011, 6), (0b1101, 4), (0b111101011, 9), (0b10111111, 8),
    (0b11011, 5), (0b111011, 6), (0b1111, 4), (0b111, 3),
    (0b111111, 6), (0b110111111, 9), (0b10101, 5), (0b10111, 5),
    (0b101, 3), (0b110111, 6), (0b1111011, 7), (0b1101011, 7),
    (0b11011111, 8), (0b1011101, 7), (0b111010101, 9), (0b1010110111, 10),
    (0b110111011, 9), (0b1010110101, 10), (0b1011010111, 10), (0b1110110101, 10),
]

_DECODE = {(cw, ln): i for i, (cw, ln) in enumerate(VARICODE)}


def varicode_encode(byte: int) -> Tuple[int, int]:
    """ASCII byte → (codeword, length); values ≥128 map to the NUL entry."""
    return VARICODE[byte] if byte < 128 else VARICODE[0]


def varicode_decode(bits: int, length: int) -> Optional[int]:
    """Codeword → ASCII byte, or None if not in the table."""
    return _DECODE.get((bits, length))


class VaricodeEncoder:
    """Stateful bit-stream encoder: "00" gaps between characters, leading gap
    suppressed; preamble = 0-bits (phase reversals), postamble = 1-bits."""

    def __init__(self) -> None:
        self.pending: deque = deque()
        self.first = True

    def push_preamble(self, n_bits: int) -> None:
        # Preamble zeros double as the first character's gap: `first` stays
        # True so push_byte skips its "00" prefix.
        self.pending.extend([0] * n_bits)
        self.first = True

    def push_byte(self, b: int) -> None:
        if not self.first:
            self.pending.extend((0, 0))
        self.first = False
        cw, ln = varicode_encode(b)
        self.pending.extend((cw >> i) & 1 for i in range(ln - 1, -1, -1))

    def push_postamble(self, n_bits: int) -> None:
        # "00" gap first so the decoder flushes the last character.
        if not self.first:
            self.pending.extend((0, 0))
        self.pending.extend([1] * n_bits)

    def drain_bits(self) -> np.ndarray:
        out = np.fromiter(self.pending, dtype=np.uint8, count=len(self.pending))
        self.pending.clear()
        return out


def encode_text(text: bytes | str, preamble_bits: int = 32,
                postamble_bits: int = 32) -> np.ndarray:
    """Text → differential bit stream (uint8) with preamble/postamble."""
    if isinstance(text, str):
        text = text.encode("ascii", "replace")
    enc = VaricodeEncoder()
    enc.push_preamble(preamble_bits)
    for b in text:
        enc.push_byte(b)
    enc.push_postamble(postamble_bits)
    return enc.drain_bits()


class VaricodeDecoder:
    """Stateful bit-stream decoder: characters emitted at "00" boundaries."""

    def __init__(self) -> None:
        self.shift = 0
        self.len = 0
        self.prev_zero = False
        self.chars: deque = deque()

    def push_bit(self, bit: int) -> None:
        is_zero = bit == 0
        if is_zero and self.prev_zero:
            # "00" boundary: the previous zero was already shifted in; the
            # codeword is shift >> 1 with length len - 1.
            cw = self.shift >> 1 if self.len > 0 else 0
            cw_len = max(self.len - 1, 0)
            if cw_len > 0:
                ch = varicode_decode(cw, cw_len)
                if ch is not None:
                    self.chars.append(ch)
            self.shift = 0
            self.len = 0
            self.prev_zero = False
        else:
            self.shift = ((self.shift << 1) | (bit & 1)) & 0x7FF
            if self.len < VARICODE_MAX_BITS + 1:
                self.len += 1
            self.prev_zero = is_zero

    def pop_char(self) -> Optional[int]:
        return self.chars.popleft() if self.chars else None

    def push_bits(self, bits: Iterable[int]) -> str:
        """Feed a bit array; return newly decoded printable ASCII."""
        out = []
        for b in bits:
            self.push_bit(int(b))
            while self.chars:
                ch = self.chars.popleft()
                if 0x20 <= ch < 0x7F:
                    out.append(chr(ch))
        return "".join(out)


def decode_bits(bits) -> str:
    """One-shot bit stream → printable text (trailing "00" flush included)."""
    dec = VaricodeDecoder()
    text = dec.push_bits(np.asarray(bits, dtype=np.uint8))
    return text + dec.push_bits([0, 0])
