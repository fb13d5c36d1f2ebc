"""GF(2^8) tables and the host binary BCH and Reed–Solomon codes
(counterpart of ``orion_sdr_tpu/fec/galois.py``).

Primitive polynomial 0x11D; BCH generator = lcm of the minimal polynomials
of α^1..α^2t; RS generator = Π(x + α^i), i = 0..n_parity−1 (FCR = 0);
shortened codes occupy the high end of the length-255 frame. Both run on
the host through the native batch encoders/decoders
(``orion_sdr_tpu_torch.native``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from .. import native

_PRIM = 0x11D


def _build_tables():
    exp = np.zeros(512, np.uint8)
    log = np.zeros(256, np.uint8)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM
    exp[255:510] = exp[:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Vectorized GF(2^8) multiply (0-handling included)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = GF_EXP[GF_LOG[a].astype(np.int32) + GF_LOG[b].astype(np.int32)]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a):
    """Multiplicative inverse in GF(2^8) (0 has none: its entry is
    meaningless)."""
    a = np.asarray(a, np.uint8)
    return GF_EXP[255 - GF_LOG[a].astype(np.int32)].astype(np.uint8)


def gf_pow_alpha(e):
    """α^e for integer exponents (arrays too)."""
    return GF_EXP[np.asarray(e) % 255].astype(np.uint8)


def _poly_mul(a, b):
    out = np.zeros(len(a) + len(b) - 1, np.uint8)
    for i, ai in enumerate(a):
        if ai:
            out[i:i + len(b)] ^= gf_mul(ai, b)
    return out


class BchError(ValueError):
    pass


@lru_cache(maxsize=None)
def _bch_generator(t: int) -> tuple:
    """g(x) = lcm of minimal polys of α^1..α^2t, returned MSB-first GF(2)."""
    g = np.array([1], np.uint8)  # low-degree-first
    used = set()
    for j in range(1, 2 * t + 1):
        coset = []
        r = j
        while r not in coset:
            coset.append(r)
            r = (r * 2) % 255
        key = min(coset)
        if key in used:
            continue
        used.add(key)
        minp = np.array([1], np.uint8)
        for r in coset:
            minp = _poly_mul(minp, np.array([GF_EXP[r], 1], np.uint8))
        g = _poly_mul(g, minp)
    if len(g) - 1 >= 255:
        raise BchError(f"t={t} too large")
    return tuple(int(v & 1) for v in g[::-1])


class Bch:
    """Binary BCH(n, k, t), optionally shortened."""

    def __init__(self, t: int, n: int = 255):
        gen = np.array(_bch_generator(t), np.uint8)  # MSB-first
        parity = len(gen) - 1
        if n == 0 or n > 255 or parity >= n:
            raise BchError(f"bad n={n}")
        self.n, self.t = n, t
        self.k = n - parity
        self.gen = gen

    @property
    def parity_bits(self) -> int:
        return len(self.gen) - 1

    def encode(self, message) -> np.ndarray:
        """Systematic encode: (..., k) bits → (..., n) bits."""
        msg = np.asarray(message, np.uint8) & 1
        lead = msg.shape[:-1]
        out = native.bch_encode_batch(self.n, self.k, self.t,
                                      msg.reshape(-1, self.k))
        return out.reshape(lead + (self.n,))

    def decode(self, received) -> np.ndarray:
        """Correct up to t bit errors in each codeword of (..., n) bits →
        (..., k); raises BchError if any codeword is uncorrectable."""
        r = np.asarray(received, np.uint8) & 1
        if r.shape[-1] != self.n:
            raise BchError(f"codeword length {r.shape[-1]} != n={self.n}")
        msg, ok = self.decode_batch(r.reshape(-1, self.n))
        if not np.all(ok):
            raise BchError("uncorrectable codeword")
        return msg.reshape(r.shape[:-1] + (self.k,))

    def decode_batch(self, received_bits):
        """(B, n) bits → ((B, k), ok flags); failed rows hold the systematic
        prefix."""
        r = np.asarray(received_bits, np.uint8) & 1
        return native.bch_decode_batch(self.n, self.k, self.t, r)


# ── Reed-Solomon ─────────────────────────────────────────────────────────────


class RsError(ValueError):
    pass


@lru_cache(maxsize=None)
def _rs_generator(n_parity: int) -> tuple:
    """Π(x + α^i), i = 0..n_parity−1, low-degree-first."""
    g = np.array([1], np.uint8)
    for i in range(n_parity):
        g = _poly_mul(g, np.array([GF_EXP[i % 255], 1], np.uint8))
    return tuple(int(v) for v in g)


class ReedSolomon:
    """RS(n, k = n − n_parity) over GF(2^8), FCR = 0. ``ReedSolomon.dvb()``
    is RS(204, 188), t = 8: DVB-T's outer code."""

    def __init__(self, n: int, n_parity: int):
        if n == 0 or n > 255 or n_parity >= n:
            raise RsError(f"bad RS({n}, parity {n_parity})")
        self.n, self.n_parity = n, n_parity
        self.k = n - n_parity
        self.gen = np.array(_rs_generator(n_parity), np.uint8)  # low-first

    @staticmethod
    def dvb() -> "ReedSolomon":
        return ReedSolomon(204, 16)

    @property
    def t(self) -> int:
        return self.n_parity // 2

    def encode(self, message) -> np.ndarray:
        """Systematic encode: (..., k) bytes → (..., n)."""
        msg = np.asarray(message, np.uint8)
        out = native.rs_encode_batch(self.n, self.n_parity,
                                     msg.reshape(-1, self.k))
        return out.reshape(msg.shape[:-1] + (self.n,))

    def decode(self, received) -> np.ndarray:
        """Correct ≤ t byte errors in one (n,) word; raises RsError if
        uncorrectable."""
        r = np.asarray(received, np.uint8)
        if r.shape != (self.n,):
            raise ValueError(f"expected ({self.n},) bytes, got {r.shape}")
        msg, ok = self.decode_batch(r[None])
        if not ok[0]:
            raise RsError("uncorrectable")
        return msg[0]

    def decode_batch(self, received):
        """(B, n) → ((B, k), ok flags); failed rows hold the systematic
        prefix."""
        return native.rs_decode_batch(self.n, self.n_parity,
                                      np.asarray(received, np.uint8))
