"""RTTY, Baudot/ITA2 over 45.45-baud 2-FSK, the classic HF teletype mode
(the port's own copy of ``orion_sdr_tpu/codec/rtty.py``, numpy, bit-exact
with it).

Text layer: 5-bit ITA2 with LTRS/FIGS shift pages (US-TTY figures).
Physical layer: start/stop asynchronous framing (1 start space, 5 data
bits LSB-first, 1.5 stop marks) over the shared 2-FSK engine
(modulate/afsk.py::fsk2_tones, demodulate/afsk.py::fsk2_decision) at the
standard 2125/2295 Hz audio pair.
"""

from __future__ import annotations

from typing import List

import numpy as np

RTTY_BAUD = 45.45
RTTY_MARK_HZ = 2125.0
RTTY_SPACE_HZ = 2295.0
RTTY_STOP_BITS = 1.5

_LTRS = 0x1F
_FIGS = 0x1B

BAUDOT_LETTERS = [
    "\x00", "E", "\n", "A", " ", "S", "I", "U",
    "\r", "D", "R", "J", "N", "F", "C", "K",
    "T", "Z", "L", "W", "H", "Y", "P", "Q",
    "O", "B", "G", "\x1b", "M", "X", "V", "\x1f",
]
BAUDOT_FIGURES = [
    "\x00", "3", "\n", "-", " ", "\x07", "8", "7",
    "\r", "$", "4", "'", ",", "!", ":", "(",
    "5", '"', ")", "2", "#", "6", "0", "1",
    "9", "?", "&", "\x1b", ".", "/", ";", "\x1f",
]
_LTRS_IDX = {c: i for i, c in enumerate(BAUDOT_LETTERS) if i not in
             (_LTRS, _FIGS)}
_FIGS_IDX = {c: i for i, c in enumerate(BAUDOT_FIGURES) if i not in
             (_LTRS, _FIGS)}


def baudot_encode(text: str) -> List[int]:
    """Text → 5-bit codes with LTRS/FIGS shifts inserted (starts with an
    explicit LTRS so receivers begin in a known page)."""
    out = [_LTRS]
    page = 0                    # 0 letters, 1 figures
    tables = (_LTRS_IDX, _FIGS_IDX)
    shifts = (_LTRS, _FIGS)
    for ch in text.upper():
        if ch in tables[page]:              # stays on the current page
            out.append(tables[page][ch])
        elif ch in tables[1 - page]:        # needs a shift
            page = 1 - page
            out.append(shifts[page])
            out.append(tables[page][ch])
        # unknown characters are dropped
    return out


def baudot_decode(codes) -> str:
    """5-bit codes → text (LTRS/FIGS pages tracked; control codes pass
    through as their characters)."""
    out = []
    page = 0
    for c in codes:
        c = int(c) & 0x1F
        if c == _LTRS:
            page = 0
        elif c == _FIGS:
            page = 1
        else:
            out.append((BAUDOT_LETTERS if page == 0 else BAUDOT_FIGURES)[c])
    return "".join(out)


def rtty_frame_bits(codes, stop_bits: float = RTTY_STOP_BITS,
                    lead_marks: int = 8) -> np.ndarray:
    """5-bit codes → async line states (1 = mark): idle marks, then per
    char [start 0, b0..b4 LSB-first, stop 1s]. Stop is rounded up to whole
    bits on the line grid (receivers hunt edges, so ≥1.5 is conformant)."""
    stop_i = max(int(np.ceil(stop_bits)), 1)
    line = [1] * lead_marks
    for c in codes:
        line.append(0)
        line.extend((int(c) >> j) & 1 for j in range(5))
        line.extend([1] * stop_i)
    line.extend([1] * 4)
    return np.asarray(line, np.uint8)


def rtty_unframe_bits(states) -> List[int]:
    """Line states sampled at the bit grid → 5-bit codes (start-bit hunt,
    stop-bit verified; a failed stop re-hunts from the next bit)."""
    s = np.asarray(states, np.uint8) & 1
    out = []
    i = 0
    while i + 7 <= len(s):
        if s[i] == 0 and (i == 0 or s[i - 1] == 1):     # mark→space edge
            if s[i + 6] == 1:                           # stop bit holds
                code = 0
                for j in range(5):
                    code |= int(s[i + 1 + j]) << j
                out.append(code)
                i += 7
                continue
        i += 1
    return out
