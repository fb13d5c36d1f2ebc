"""The benchmark's plain binary BCH code over GF(2^8) (primitive polynomial
0x11D), shortened: generator = lcm of the minimal polynomials of
α^1..α^2t, systematic codewords [message | parity] with the message bit of
highest degree first, the shortened code at the high end of the length-255
frame. Decoding: syndromes for every word as one product mod 2, then
Berlekamp-Massey and a Chien search for the words whose syndromes are not
zero; a word with more than t errors, or one whose correction leaves a
syndrome, fails and keeps its systematic prefix."""

from __future__ import annotations

from functools import lru_cache

import numpy as np

PRIM = 0x11D


def _tables():
    exp = np.zeros(512, np.int64)
    log = np.zeros(256, np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= PRIM
    exp[255:510] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    return 0 if a == 0 or b == 0 else int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    return int(EXP[255 - LOG[a]])


def _poly_mul(a, b):
    out = [0] * (len(a) + len(b) - 1)
    for i, x in enumerate(a):
        for j, y in enumerate(b):
            out[i + j] ^= mul(x, y)
    return out


@lru_cache(maxsize=None)
def generator(t: int) -> tuple:
    """g(x) coefficients over GF(2), highest degree first."""
    g = [1]
    used = set()
    for j in range(1, 2 * t + 1):
        coset, r = [], j
        while r not in coset:
            coset.append(r)
            r = r * 2 % 255
        if min(coset) in used:
            continue
        used.add(min(coset))
        mp = [1]
        for r in coset:
            mp = _poly_mul(mp, [int(EXP[r]), 1])      # lowest degree first
        g = _poly_mul(g, mp)
    return tuple(int(v) & 1 for v in g[::-1])


class Bch:
    """BCH(n, k, t), shortened to n bits."""

    def __init__(self, t: int, k: int):
        self.g = np.array(generator(t), np.int64)
        self.p = len(self.g) - 1
        self.t, self.k, self.n = t, k, k + self.p
        self.shift = 255 - self.n
        # parity rows: the remainder of x^(n - 1 - i) mod g(x), i < k
        rows = np.zeros((k, self.p), np.int64)
        gint = int("".join(map(str, self.g)), 2)
        for i in range(k):
            r = 1 << (self.n - 1 - i)
            for d in range(self.n - 1, self.p - 1, -1):
                if r >> d & 1:
                    r ^= gint << (d - self.p)
            rows[i] = [(r >> (self.p - 1 - j)) & 1 for j in range(self.p)]
        self.par = rows
        deg = (self.n - 1 - np.arange(self.n)) + self.shift
        syn = EXP[(np.arange(1, 2 * t + 1)[:, None] * deg[None, :]) % 255]
        self.syn = syn                                  # (2t, n) field values
        self.syn_bits = ((syn.T[:, :, None] >> np.arange(8)) & 1).reshape(
            self.n, 2 * t * 8).astype(np.float64)

    def encode(self, msg: np.ndarray) -> np.ndarray:
        """(B, k) bits → (B, n) bits."""
        msg = np.asarray(msg, np.int64) & 1
        return np.concatenate([msg, (msg @ self.par) & 1], 1).astype(np.uint8)

    def syndromes(self, words: np.ndarray) -> np.ndarray:
        """(B, n) bits → (B, 2t) syndromes S_1..S_2t."""
        # sums of at most n ones: exact in float64
        s = (np.asarray(words, np.float64) @ self.syn_bits).astype(
            np.int64) & 1
        return (s.reshape(-1, 2 * self.t, 8) << np.arange(8)).sum(-1)

    def _locator(self, s):
        """Berlekamp-Massey over s[1..2t] → σ(x), lowest degree first."""
        sigma, b = [1], [1]
        L, m = 0, 1
        for r in range(1, 2 * self.t + 1):
            delta = int(s[r])
            for i in range(1, L + 1):
                if i < len(sigma):
                    delta ^= mul(sigma[i], int(s[r - i]))
            if delta == 0:
                m += 1
                continue
            new = sigma + [0] * max(0, len(b) + m - len(sigma))
            for i, v in enumerate(b):
                new[i + m] ^= mul(delta, v)
            if 2 * L < r:
                b = [mul(v, inv(delta)) for v in sigma]
                L, m = r - L, 1
            else:
                m += 1
            sigma = new
        return sigma

    def _correct(self, word, s):
        sigma = self._locator(np.concatenate([[0], s]))
        found = []
        for d in range(255):
            xinv = int(EXP[(255 - d) % 255])
            acc, xp = 0, 1
            for c in sigma:
                acc ^= mul(c, xp)
                xp = mul(xp, xinv)
            if acc == 0 and self.shift <= d <= self.n - 1 + self.shift:
                found.append(self.n - 1 + self.shift - d)
        out = word.copy()
        for p in found:
            out[p] ^= 1
        if len(found) > self.t or self.syndromes(out[None])[0].any():
            return None
        return out

    def decode(self, words: np.ndarray):
        """(B, n) bits → ((B, k) message bits, (B,) bool ok)."""
        return self.decode_counted(words)[:2]

    def decode_counted(self, words: np.ndarray):
        """``decode``, and (B,) bool: the words with a nonzero syndrome."""
        words = np.asarray(words, np.uint8) & 1
        msg = words[:, :self.k].copy()
        ok = np.ones(len(words), bool)
        s = self.syndromes(words)
        for i in np.flatnonzero(s.any(1)):
            fixed = self._correct(words[i], s[i])
            if fixed is None:
                ok[i] = False
            else:
                msg[i] = fixed[:self.k]
        return msg, ok, s.any(1)
