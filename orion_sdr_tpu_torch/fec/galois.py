"""GF(2^8) tables and the host binary BCH and Reed–Solomon codes
(counterpart of ``orion_sdr_tpu/fec/galois.py``).

Primitive polynomial 0x11D; BCH generator = lcm of the minimal polynomials
of α^1..α^2t; RS generator = Π(x + α^i), i = 0..n_parity−1 (FCR = 0);
shortened codes occupy the high end of the length-255 frame. Both run on
the host through the native batch encoders/decoders
(``orion_sdr_tpu_torch.native``), whose fixed buffers hold at most 64
syndromes: an RS code with more than 64 parity bytes, or a BCH code with
t > 16, is decoded by the numpy decoders here, copies of the JAX package's,
chosen by the code's parameters where the JAX package chooses them. Such an
RS code is also encoded by the JAX package's numpy LFSR: the native
encoder's four-row lanes hold 64 parity bytes.
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


# the largest codes the native batch coders take
NATIVE_MAX_RS_PARITY = 64
NATIVE_MAX_BCH_T = 16


def _poly_eval(p, x):
    """Horner over GF(2^8); p low-degree-first, scalars."""
    acc = np.uint8(0)
    for c in p[::-1]:
        acc = gf_mul(acc, x) ^ np.uint8(c)
    return acc


def _poly_mul(a, b):
    out = np.zeros(len(a) + len(b) - 1, np.uint8)
    for i, ai in enumerate(a):
        if ai:
            out[i:i + len(b)] ^= gf_mul(ai, b)
    return out


def _berlekamp_massey(s, t, start):
    """σ(x) low-degree-first from syndromes; ``start``=1 for BCH (s[1..2t]),
    0 for RS (s[0..2t−1])."""
    sigma = np.array([1], np.uint8)
    b = np.array([1], np.uint8)
    l, m = 0, 1
    rng = range(1, 2 * t + 1) if start == 1 else range(0, 2 * t)
    for n in rng:
        delta = int(s[n])
        for i in range(1, l + 1):
            if i < len(sigma):
                delta ^= int(gf_mul(sigma[i], s[n - i]))
        cond = (2 * l < n) if start == 1 else (2 * l <= n)
        if delta == 0:
            m += 1
        elif cond:
            t_sigma = sigma.copy()
            sigma = _apply_correction(sigma, b, delta, m)
            l = (n - l) if start == 1 else (n + 1 - l)
            b = gf_mul(t_sigma, gf_inv(np.uint8(delta)))
            m = 1
        else:
            sigma = _apply_correction(sigma, b, delta, m)
            m += 1
    return sigma


def _apply_correction(sigma, b, coef, shift):
    needed = len(b) + shift
    out = np.zeros(max(len(sigma), needed), np.uint8)
    out[:len(sigma)] = sigma
    out[shift:shift + len(b)] ^= gf_mul(np.uint8(coef), b)
    return out


def _chien(sigma):
    """σ(α^{-i}) for i = 0..254."""
    i_all = np.arange(255)
    xinv = GF_EXP[(255 - i_all % 255) % 255]
    vals = np.zeros(255, np.uint8)
    xp = np.ones(255, np.uint8)
    for c in sigma:
        vals ^= gf_mul(np.uint8(c), xp)
        xp = gf_mul(xp, xinv)
    return vals


def _decode_rows(decode_word, r, k, error):
    """(B, n) → ((B, k), ok flags) one row at a time; a row ``decode_word``
    raises ``error`` on keeps its systematic prefix."""
    out = np.empty((r.shape[0], k), np.uint8)
    ok = np.ones(r.shape[0], bool)
    for i, row in enumerate(r):
        try:
            out[i] = decode_word(row)
        except error:
            out[i] = row[:k]
            ok[i] = False
    return out, ok


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
        self._shift = 255 - n
        deg = (n - 1 - np.arange(n)) + self._shift
        js = np.arange(1, 2 * t + 1)
        self._synmat = GF_EXP[(js[:, None] * deg[None, :]) % 255].astype(
            np.uint8)

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
        prefix. The native decoder up to t = ``NATIVE_MAX_BCH_T``, the numpy
        one beyond."""
        r = np.asarray(received_bits, np.uint8) & 1
        if self.t <= NATIVE_MAX_BCH_T:
            return native.bch_decode_batch(self.n, self.k, self.t, r)
        return _decode_rows(self._decode_word, r, self.k, BchError)

    def _syndromes(self, bits):
        mask = np.asarray(bits).astype(bool)
        acc = np.zeros(2 * self.t, np.uint8)
        cols = self._synmat[:, mask]
        for c in range(cols.shape[1]):
            acc ^= cols[:, c]
        return acc

    def _decode_word(self, r):
        """The JAX package's numpy decoder of one (n,) word of bits."""
        s = np.concatenate([[0], self._syndromes(r)]).astype(np.uint8)
        if not s[1:].any():
            return r[:self.k].copy()
        vals = _chien(_berlekamp_massey(s, self.t, start=1))
        corrected = r.copy()
        n_found = 0
        for d in np.nonzero(vals == 0)[0]:
            if self._shift <= d <= self.n - 1 + self._shift:
                p = self.n - 1 + self._shift - d
                if p < self.n:
                    corrected[p] ^= 1
                    n_found += 1
        residual = int((self._syndromes(corrected) != 0).sum())
        if residual != 0 or n_found > self.t:
            raise BchError(f"uncorrectable ({max(residual, n_found)})")
        return corrected[:self.k].copy()


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
        self._shift = 255 - n
        deg = (n - 1 - np.arange(n)) + self._shift   # code degree a position
        js = np.arange(n_parity)
        # syndrome matrix: M[j, p] = α^(j·deg(p))
        self._synmat = GF_EXP[(js[:, None] * deg[None, :]) % 255].astype(
            np.uint8)

    @staticmethod
    def dvb() -> "ReedSolomon":
        return ReedSolomon(204, 16)

    @property
    def t(self) -> int:
        return self.n_parity // 2

    def encode(self, message) -> np.ndarray:
        """Systematic encode: (..., k) bytes → (..., n). The native encoder
        up to ``NATIVE_MAX_RS_PARITY`` parity bytes (its four-row lanes hold
        64 each), the numpy LFSR beyond."""
        msg = np.asarray(message, np.uint8)
        rows = msg.reshape(-1, self.k)
        if self.n_parity <= NATIVE_MAX_RS_PARITY:
            out = native.rs_encode_batch(self.n, self.n_parity, rows)
        else:
            reg = np.zeros((rows.shape[0], self.n_parity), np.uint8)
            gen_hi = self.gen[:-1][::-1]   # taps for the shift update
            for i in range(self.k):
                fb = rows[:, i] ^ reg[:, 0]
                reg = np.concatenate([reg[:, 1:], np.zeros_like(reg[:, :1])],
                                     axis=-1) ^ gf_mul(fb[:, None], gen_hi)
            out = np.concatenate([rows, reg], axis=-1)
        return out.reshape(msg.shape[:-1] + (self.n,))

    def decode(self, received) -> np.ndarray:
        """Correct ≤ t byte errors in each word of (..., n) bytes → (..., k);
        raises RsError if any word is uncorrectable."""
        r = np.asarray(received, np.uint8)
        if r.shape[-1] != self.n:
            raise ValueError(f"expected (..., {self.n}) bytes, got {r.shape}")
        msg, ok = self.decode_batch(r.reshape(-1, self.n))
        if not np.all(ok):
            raise RsError("uncorrectable")
        return msg.reshape(r.shape[:-1] + (self.k,))

    def decode_batch(self, received):
        """(B, n) → ((B, k), ok flags); failed rows hold the systematic
        prefix. The native decoder up to ``NATIVE_MAX_RS_PARITY`` parity
        bytes, the numpy one beyond."""
        r = np.asarray(received, np.uint8)
        if self.n_parity <= NATIVE_MAX_RS_PARITY:
            return native.rs_decode_batch(self.n, self.n_parity, r)
        return _decode_rows(self._decode_word, r, self.k, RsError)

    def _syndromes(self, word):
        prods = gf_mul(word[None, :], self._synmat)
        acc = np.zeros(self.n_parity, np.uint8)
        for p in range(self.n):
            acc ^= prods[:, p]
        return acc

    def _decode_word(self, r):
        """The JAX package's numpy decoder of one (n,) word."""
        s = self._syndromes(r)
        if not s.any():
            return r[:self.k].copy()
        sigma = _berlekamp_massey(s, self.t, start=0)
        # Chien: σ(α^{-i}) == 0 → error at code degree i
        err_deg = np.nonzero(_chien(sigma) == 0)[0]
        sigma_deg = int(np.nonzero(sigma)[0].max()) if sigma.any() else 0
        if len(err_deg) != sigma_deg or sigma_deg > self.t:
            raise RsError(f"uncorrectable ({sigma_deg})")
        # Forney
        omega = np.zeros(self.n_parity, np.uint8)
        for i, si in enumerate(s):
            if si:
                for j, sj in enumerate(sigma):
                    if sj and i + j < self.n_parity:
                        omega[i + j] ^= gf_mul(np.uint8(si), np.uint8(sj))
        deriv = np.zeros(max(len(sigma) - 1, 1), np.uint8)
        for kk in range(1, len(sigma), 2):
            deriv[kk - 1] = sigma[kk]
        corrected = r.copy()
        for i in err_deg:
            x = GF_EXP[i % 255]
            x_inv = gf_inv(np.uint8(x))
            ov = _poly_eval(omega, x_inv)
            dv = _poly_eval(deriv, x_inv)
            if dv == 0:
                raise RsError("uncorrectable (zero derivative)")
            mag = gf_mul(np.uint8(x), gf_mul(ov, gf_inv(dv)))
            if self._shift <= i <= self.n - 1 + self._shift:
                p = self.n - 1 + self._shift - i
                corrected[p] ^= mag
        if self._syndromes(corrected).any():
            raise RsError("uncorrectable (residual)")
        return corrected[:self.k].copy()
