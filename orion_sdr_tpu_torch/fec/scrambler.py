"""Additive PN (LFSR) scramblers (counterpart of
``orion_sdr_tpu/fec/scrambler.py``).

Fibonacci LFSR: feedback = parity of tapped bits, shift right, feedback into
top bit; PN bit = register bit 0; data bits LSB-first per byte. The PN byte
stream for (taps, width, seed, length) is built once on the host and XORed
in one vectorized op; the streaming form carries the bytes consumed.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

DVB_TAPS = (1 << 14) | (1 << 13)  # x^15 + x^14 + 1: feedback bits 14, 13


@lru_cache(maxsize=64)
def _pn_bytes(taps: int, width: int, seed: int, nbytes: int) -> bytes:
    if not (2 <= width <= 32) or seed == 0:
        raise ValueError(f"bad LFSR width {width} / seed {seed}")
    mask = (1 << width) - 1
    if seed & ~mask or taps & ~mask:
        raise ValueError("seed and taps must fit the register width")
    top = width - 1
    reg = seed & mask
    out = bytearray(nbytes)
    for i in range(nbytes):
        b = 0
        for bit in range(8):
            b |= (reg & 1) << bit
            fb = bin(reg & taps).count("1") & 1
            reg = ((reg >> 1) | (fb << top)) & mask
        out[i] = b
    return bytes(out)


def pn_sequence(taps: int, width: int, seed: int, nbytes: int) -> np.ndarray:
    """The PN whitening byte stream (LSB-first within each byte)."""
    return np.frombuffer(_pn_bytes(taps, width, seed, nbytes),
                         dtype=np.uint8).copy()


def scramble(data, taps: int, width: int, seed: int) -> np.ndarray:
    """XOR the PN sequence (restarted from ``seed``) over the bytes of
    ``data`` along its last axis. Self-inverse."""
    d = np.asarray(data, np.uint8)
    return d ^ pn_sequence(taps, width, seed, d.shape[-1])


class PnScramblerStream:
    """:func:`scramble` across ``feed`` calls: the register runs on from
    where the last call left it."""

    def __init__(self, taps: int, width: int, seed: int):
        self.taps, self.width, self.seed = taps, width, seed
        self._consumed = 0

    def reset(self) -> None:
        self._consumed = 0

    def feed(self, data) -> np.ndarray:
        d = np.asarray(data, np.uint8)
        n = d.shape[-1]
        pn = pn_sequence(self.taps, self.width, self.seed,
                         self._consumed + n)
        self._consumed += n
        return d ^ pn[len(pn) - n:]
