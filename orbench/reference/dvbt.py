"""The benchmark's plain DVB-T 2K link (ETSI EN 300 744, non-hierarchical):
transmitter and receiver in plain torch and numpy, written from the link's
definition.

Transmitter, a frame of ``n_symbols`` (68) OFDM symbols: the payload in
188-byte TS packets (0x47 and 187 bytes), null packets (PID 0x1FFF) after
them until the coded stream fills every data cell; energy dispersal over
the packets (§4.3.1: the PRBS 1 + X^14 + X^15 restarts every 8 packets, the
group's first sync byte sent inverted); RS(204, 188, t = 8) on each packet
(§4.3.2: GF(2^8) with x^8 + x^4 + x^3 + x^2 + 1, roots α^0..α^15, the
shortened word at the low-degree end); the Forney interleaver I = 12, M =
17; the K = 7 code (G1 = 171, G2 = 133 octal) with a zero tail, punctured;
the coded stream cut at the frame's capacity; Figure-9a mapping (unit mean
energy) onto the 1512 data carriers of each symbol in ascending carrier
order; continual and scattered pilots at ±4/3 from w_k (§4.5); the 17 TPS
carriers DBPSK at ±1 (§4.6: BCH(67, 53) t = 2); a 2048-point inverse FFT
(scaled by 1/N) and a cyclic prefix.

Departures from EN 300 744, as the program and orion-sdr run the link:
- no inner interleaver (§4.3.4): the coded stream maps straight onto the
  cells, y0..y(v−1) from consecutive bits, even bits on I, odd on Q;
- puncturing with Table 2's X and Y rows swapped (2/3 sends X1 Y1 X2);
- each frame stands alone: the conv code starts at state 0 and ends in a
  zero tail, the Forney interleaver starts empty and is flushed
  (12·11·17 bytes) inside the frame, the dispersal restarts with it, and
  the scattered-pilot pattern starts at phase 0; a broadcast runs all of
  them on across frames;
- 2K mode only; the TPS word's reserved bits are zero.

Receiver, on aligned frames and a flat channel: the FFT of each symbol
after its cyclic prefix; the TPS word from the raw TPS cells (differential
decisions, then the nearest BCH(67, 53) codeword within 2 bit errors by
its syndrome); per symbol, a zero-forcing channel estimate from its
continual and scattered pilots (TPS left out), interpolated linearly in
FFT-bin order with the end values held beyond the outermost pilots (so not
across DC), as the program does; max-log LLRs (positive ⇒ bit 0, squared
distances in the unit-energy plane) weighted by |ĥ|² over its symbol's
mean; depuncturing with zero LLRs; the Viterbi decode over the
configuration's chunk plan (:func:`viterbi_chunks`; each row starts
free, as the program's, not at the encoder's state 0: :func:`chunk_rows`);
the Forney deinterleaver; RS decoding (syndromes, Berlekamp-Massey, Chien,
Forney's formula); the dispersal undone; the sync bytes checked and
stripped.

``rnd`` rounds the FFT output and the LLRs to a lower precision for the
control; None keeps float32 (TF32 plays no part: no products of matrices).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch

from .bch import EXP, LOG

N_FFT = 2048
KMAX = 1704
CENTER = KMAX // 2
DATA_CARRIERS = 1512
TS_LEN = 188
TS_PAYLOAD = 187
SYNC = 0x47
GUARDS = {"1/32": 64, "1/16": 128, "1/8": 256, "1/4": 512}
BPS = {"qpsk": 2, "qam16": 4, "qam64": 6}
# Figure 9a: an axis's level for its bits (y0 y2 y4 on I, y1 y3 y5 on Q)
# read as a binary number, most significant first
AXIS = {2: [1, -1], 4: [3, 1, -3, -1], 6: [7, 5, 1, 3, -7, -5, -1, -3]}
# Table 2 as the program sends it (X and Y rows swapped): (X row, Y row)
PUNCTURE = {"1/2": ((1,), (1,)), "2/3": ((1, 1), (1, 0)),
            "3/4": ((1, 1, 0), (1, 0, 1)),
            "5/6": ((1, 1, 0, 1, 0), (1, 0, 1, 0, 1)),
            "7/8": ((1, 1, 1, 1, 0, 1, 0), (1, 0, 0, 0, 1, 0, 1))}
# Table 7 (2K): continual pilots; Table 8 (2K): TPS carriers
CONTINUAL = (0, 48, 54, 87, 141, 156, 192, 201, 255, 279, 282, 333, 432, 450,
             483, 525, 531, 618, 636, 714, 759, 765, 780, 804, 873, 888, 918,
             939, 942, 969, 984, 1050, 1101, 1107, 1110, 1137, 1140, 1146,
             1206, 1269, 1323, 1377, 1491, 1683, 1704)
TPS_CARRIERS = (34, 50, 209, 346, 413, 569, 595, 688, 790, 901, 1073, 1219,
                1262, 1286, 1469, 1594, 1687)
TPS_SYNC = (0b0011010111101110, 0b1100101000010001)
TPS_GEN = 0x4377                       # x^14+x^9+x^8+x^6+x^5+x^4+x^2+x+1
TPS_CONST = {"qpsk": 0, "qam16": 1, "qam64": 2}
TPS_RATE = {"1/2": 0, "2/3": 1, "3/4": 2, "5/6": 3, "7/8": 4}
TPS_GUARD = {"1/32": 0, "1/16": 1, "1/8": 2, "1/4": 3}
# add-compare-select work a state and trellis step, as viterbi_chunks does
# it: two candidates of two additions each, one comparison, one select,
# and the renormalisation's maximum and subtraction
ACS_OPS_PER_STATE = 8
_BIG = -1e30


def _keep(x):
    return x


# ── the link ─────────────────────────────────────────────────────────────────


@dataclass(frozen=True)
class Link:
    constellation: str
    code_rate: str
    guard: str
    n_symbols: int = 68
    g1: int = 0o171
    g2: int = 0o133
    K: int = 7
    branches: int = 12
    depth: int = 17
    rs_n: int = 204
    rs_k: int = 188
    chunk_steps: int = 1024
    chunk_overlap: int = 96

    @classmethod
    def of(cls, cfg: dict) -> "Link":
        k = cfg["link"]
        c, il, rs, v = k["inner_code"], k["outer_interleaver"], k["rs"], \
            cfg["viterbi"]
        if (tuple(c["puncture_x"]), tuple(c["puncture_y"])) \
                != PUNCTURE[k["code_rate"]]:
            raise ValueError("puncturing differs from the reference's")
        return cls(k["constellation"], k["code_rate"], k["guard"],
                   k["symbols_per_frame"], int(c["g1_octal"], 8),
                   int(c["g2_octal"], 8), c["K"], il["branches"],
                   il["depth"], rs["n"], rs["k"], v["chunk_steps"],
                   v["chunk_overlap"])

    @property
    def cp_len(self) -> int:
        return GUARDS[self.guard]

    @property
    def sps(self) -> int:
        return N_FFT + self.cp_len

    @property
    def vbits(self) -> int:
        return BPS[self.constellation]

    @property
    def capacity(self) -> int:
        """Coded bits a frame carries."""
        return self.n_symbols * DATA_CARRIERS * self.vbits

    @property
    def delay(self) -> int:
        """The Forney pair's delay in bytes."""
        return self.branches * (self.branches - 1) * self.depth

    def info_bits(self, n_pkt: int) -> int:
        """Bits into the conv code for ``n_pkt`` packets (their RS words,
        padded to the interleaver's branches, and the flush)."""
        n = -(-n_pkt * self.rs_n // self.branches) * self.branches
        return (n + self.delay) * 8

    def coded_bits(self, n_pkt: int) -> int:
        x, y = PUNCTURE[self.code_rate]
        n, P = self.info_bits(n_pkt) + self.K - 1, len(x)
        return (n // P) * (sum(x) + sum(y)) + sum(x[:n % P]) + sum(y[:n % P])

    @property
    def payload_packets(self) -> int:
        """The most whole packets whose coded stream fits one frame."""
        n = 1
        while self.coded_bits(n + 1) <= self.capacity:
            n += 1
        return n

    @property
    def payload_bytes(self) -> int:
        return self.payload_packets * TS_PAYLOAD

    def frame_packets(self, n_pay: int) -> int:
        """Packets a frame of ``n_pay`` payload packets sends: those, then
        nulls until it is full."""
        n = n_pay
        while self.coded_bits(n) < self.capacity:
            n += 1
        return n


def _keep_mask(rate: str, n_steps: int) -> np.ndarray:
    """Which of the 2·n_steps mother-code bits (X0 Y0 X1 Y1 ...) are sent."""
    x, y = PUNCTURE[rate]
    col = np.arange(n_steps) % len(x)
    keep = np.empty(2 * n_steps, bool)
    keep[0::2] = np.asarray(x, bool)[col]
    keep[1::2] = np.asarray(y, bool)[col]
    return keep


# ── the carrier grid (§4.5) ──────────────────────────────────────────────────


@lru_cache(maxsize=1)
def wk() -> np.ndarray:
    """w_k of every active carrier: an 11-stage register of ones; the
    oldest stage is the output, and the new stage is the XOR of the second
    and the eleventh."""
    reg = [1] * 11                      # reg[0] newest
    out = np.empty(KMAX + 1, np.uint8)
    for k in range(KMAX + 1):
        out[k] = reg[10]
        reg = [reg[10] ^ reg[1]] + reg[:10]
    return out


def to_bin(carriers) -> np.ndarray:
    return (np.asarray(carriers, np.int64) - CENTER) % N_FFT


@dataclass(frozen=True)
class Phase:
    data: np.ndarray          # (1512,) FFT bins, ascending carrier order
    pilots: np.ndarray        # bins of continual + scattered pilots
    pilot_vals: np.ndarray    # their ±4/3
    left: np.ndarray          # interpolation: left pilot (bin order) a bin
    right: np.ndarray
    t: np.ndarray             # the right pilot's weight


@lru_cache(maxsize=4)
def phase(p: int) -> Phase:
    """Symbol l of a frame uses phase l mod 4: scattered pilots on carriers
    k ≡ 3·p (mod 12)."""
    w = wk()
    scattered = set(range(3 * p, KMAX + 1, 12))
    pil = sorted(set(CONTINUAL) | scattered)
    taken = set(pil) | set(TPS_CARRIERS)
    data = np.array([k for k in range(KMAX + 1) if k not in taken])
    assert len(data) == DATA_CARRIERS
    pb = to_bin(pil)
    order = np.argsort(pb)
    pb, pv = pb[order], (4.0 / 3.0) * (1.0 - 2.0 * w[np.asarray(pil)[order]])
    db = to_bin(data)
    r = np.searchsorted(pb, db)                     # first pilot bin >= b
    left = np.clip(r - 1, 0, len(pb) - 1)
    right = np.clip(r, 0, len(pb) - 1)
    t = np.zeros(len(db))
    inside = (r > 0) & (r < len(pb))
    t[inside] = (db[inside] - pb[left[inside]]) / (pb[right[inside]]
                                                   - pb[left[inside]])
    exact = (r < len(pb)) & (pb[right] == db)
    left[exact], t[exact] = right[exact], 0.0
    return Phase(db, pb, pv.astype(np.float32), left, right,
                 t.astype(np.float32))


def _levels(v: int) -> np.ndarray:
    m = 1 << (v // 2)
    return np.asarray(AXIS[v], np.float64) / np.sqrt(2.0 * (m * m - 1) / 3.0)


def map_cells(bits: torch.Tensor, v: int) -> torch.Tensor:
    """(..., n·v) bits → (..., n) complex64 Figure-9a points."""
    b = bits.to(torch.int64).reshape(bits.shape[:-1] + (-1, v))
    k = v // 2
    w = torch.tensor([1 << (k - 1 - i) for i in range(k)], device=b.device)
    lv = torch.as_tensor(_levels(v), dtype=torch.float32, device=b.device)
    return torch.complex(lv[(b[..., 0::2] * w).sum(-1)],
                         lv[(b[..., 1::2] * w).sum(-1)])


def soft_llr(z: torch.Tensor, v: int) -> torch.Tensor:
    """(..., n) cells → (..., n·v) float32 max-log LLRs, y0..y(v−1)."""
    k = v // 2
    lv = torch.as_tensor(_levels(v), dtype=torch.float32, device=z.device)
    idx = np.arange(1 << k)
    inf = torch.tensor(float("inf"), device=z.device)

    def axis(x):
        d2 = (x[..., None] - lv) ** 2
        out = []
        for j in range(k):
            one = torch.as_tensor((idx >> (k - 1 - j)) & 1 == 1,
                                  device=z.device)
            out.append(torch.where(one, d2, inf).amin(-1)
                       - torch.where(~one, d2, inf).amin(-1))
        return out
    i, q = axis(z.real), axis(z.imag)
    return torch.stack([x for pair in zip(i, q) for x in pair], -1) \
        .reshape(z.shape[:-1] + (-1,)).to(torch.float32)


# ── TPS (§4.6) ───────────────────────────────────────────────────────────────


def _tps_remainder(bits) -> int:
    """The word's remainder mod the BCH(67, 53) generator (14 bits)."""
    reg = 0
    for b in bits:
        reg = (reg << 1) | int(b)
        if reg >> 14:
            reg ^= TPS_GEN
    return reg


def tps_bits(frame_number: int, link: Link, cell_id: int) -> np.ndarray:
    """s0..s67 of a frame: s0 the DBPSK start, then s1..s53 and parity."""
    fields = [(TPS_SYNC[frame_number % 2], 16), (0b011111, 6),
              (frame_number & 3, 2), (TPS_CONST[link.constellation], 2),
              (0, 3), (TPS_RATE[link.code_rate], 3),
              (TPS_RATE[link.code_rate], 3), (TPS_GUARD[link.guard], 2),
              (0, 2), (cell_id & 0xFF, 8), (0, 6)]
    info = [(v >> (w - 1 - j)) & 1 for v, w in fields for j in range(w)]
    par = _tps_remainder(info + [0] * 14)
    return np.array([0] + info + [(par >> (13 - j)) & 1 for j in range(14)],
                    np.uint8)


@lru_cache(maxsize=1)
def _tps_table() -> dict:
    """Syndrome → the error pattern of at most two bit errors among the 67
    code bits."""
    table = {0: ()}
    for i in range(67):
        e = [0] * 67
        e[i] = 1
        table.setdefault(_tps_remainder(e), (i,))
        for j in range(i + 1, 67):
            e2 = list(e)
            e2[j] = 1
            table.setdefault(_tps_remainder(e2), (i, j))
    return table


def tps_decode(cells: np.ndarray):
    """(68, 17) raw TPS cells of a frame → (frame number, constellation,
    code rate, guard, cell id), or None."""
    c = np.asarray(cells, np.complex128)
    flips = (np.sum((c[1:] * np.conj(c[:-1])).real, -1) < 0).astype(np.uint8)
    word = flips[:67].copy()
    fix = _tps_table().get(_tps_remainder(word))
    if fix is None:
        return None
    for i in fix:
        word[i] ^= 1
    info = word[:53]

    def get(a, w):
        return int("".join(map(str, info[a:a + w])), 2)
    fn = get(22, 2)
    if get(0, 16) != TPS_SYNC[fn % 2] or get(16, 6) != 0b011111 \
            or get(26, 3) != 0 or get(37, 2) != 0:
        return None
    const = {v: k for k, v in TPS_CONST.items()}.get(get(24, 2))
    rate = {v: k for k, v in TPS_RATE.items()}.get(get(29, 3))
    if const is None or rate is None or get(32, 3) != get(29, 3):
        return None
    guard = {v: k for k, v in TPS_GUARD.items()}[get(35, 2)]
    return (fn, const, rate, guard, get(39, 8))


# ── TS, dispersal, RS, Forney ────────────────────────────────────────────────


@lru_cache(maxsize=1)
def _dispersal_plane() -> np.ndarray:
    """(8, 188) XOR bytes of one group of 8 packets."""
    reg = [1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0, 0]   # stages 1..15
    n = 8 * TS_LEN - 1
    bits = np.empty(n * 8, np.uint8)
    for i in range(n * 8):
        fb = reg[13] ^ reg[14]
        bits[i] = fb
        reg = [fb] + reg[:14]
    pn = np.packbits(bits)
    plane = np.zeros((8, TS_LEN), np.uint8)
    plane[0, 0] = SYNC ^ 0xB8
    for p in range(8):
        start = p * TS_LEN           # PRBS bytes: after the 1st sync byte
        plane[p, 1:] = pn[start:start + TS_PAYLOAD]
    return plane


def disperse(packets: np.ndarray) -> np.ndarray:
    """(..., n, 188) packets ⇄ dispersed (self-inverse)."""
    n = packets.shape[-2]
    plane = np.tile(_dispersal_plane(), (-(-n // 8), 1))[:n]
    return packets ^ plane


def null_packet() -> np.ndarray:
    p = np.full(TS_LEN, 0xFF, np.uint8)
    p[:4] = (SYNC, 0x1F, 0xFF, 0x10)
    return p


def _gf_mul(a, b):
    a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
    return np.where((a == 0) | (b == 0), 0,
                    EXP[(LOG[a] + LOG[b]) % 255])


@lru_cache(maxsize=4)
def rs_generator(n_parity: int) -> np.ndarray:
    """g(x) = Π (x + α^i), i < n_parity, highest degree first."""
    g = np.array([1], np.int64)
    for i in range(n_parity):
        nxt = np.zeros(len(g) + 1, np.int64)
        nxt[:-1] = g
        nxt[1:] ^= _gf_mul(g, int(EXP[i]))
        g = nxt
    return g


def rs_encode(msg: np.ndarray, n: int = 204) -> np.ndarray:
    """(B, k) bytes → (B, n): [message | remainder of m(x)·x^(n−k)]."""
    msg = np.asarray(msg, np.int64)
    p = n - msg.shape[1]
    g = rs_generator(p)[1:]
    reg = np.zeros((msg.shape[0], p), np.int64)
    for i in range(msg.shape[1]):
        fb = msg[:, i] ^ reg[:, 0]
        reg = np.concatenate([reg[:, 1:], np.zeros_like(reg[:, :1])], 1) \
            ^ _gf_mul(fb[:, None], g[None, :])
    return np.concatenate([msg, reg], 1).astype(np.uint8)


@dataclass
class RsResult:
    msg: np.ndarray           # (W, k) corrected message, or the received one
    ok: np.ndarray            # (W,) corrected or clean
    in_error: np.ndarray      # (W,) nonzero syndrome
    errors: np.ndarray        # (W,) bytes corrected
    bit_errors: np.ndarray    # (W,) bits the correction flipped


def rs_decode(words: np.ndarray, n_parity: int = 16) -> RsResult:
    """(W, n) bytes → the bounded-distance decode of every word, t =
    n_parity/2: a word with a nonzero syndrome whose locator has more than
    t roots' degree, or fewer roots among the word's positions than its
    degree, fails and keeps its systematic part. Vectorised over words."""
    r = np.asarray(words, np.int64)
    W, n = r.shape
    t2 = n_parity
    deg = n - 1 - np.arange(n)                       # position → degree
    out = r.copy()
    ok = np.ones(W, bool)
    errors = np.zeros(W, np.int64)
    # syndromes S_j = r(α^j), j < 2t
    powers = EXP[(np.arange(t2)[:, None] * deg[None, :]) % 255]   # (2t, n)
    S = np.zeros((W, t2), np.int64)
    for p in range(n):
        S ^= _gf_mul(r[:, p:p + 1], powers[None, :, p])
    bad = np.flatnonzero(S.any(1))
    if len(bad):
        s = S[bad]
        B = len(bad)
        C = np.zeros((B, t2 + 1), np.int64)
        C[:, 0] = 1
        Bp = C.copy()
        L = np.zeros(B, np.int64)
        m = np.ones(B, np.int64)
        b = np.ones(B, np.int64)
        cols = np.arange(t2 + 1)
        for k in range(t2):
            d = s[:, k].copy()
            for i in range(1, t2 + 1):
                if i <= k:
                    d ^= np.where(i <= L, _gf_mul(C[:, i], s[:, k - i]), 0)
            coef = _gf_mul(d, EXP[(255 - LOG[np.maximum(b, 1)]) % 255])
            src = cols[None, :] - m[:, None]
            shifted = np.where(src >= 0, np.take_along_axis(
                Bp, np.clip(src, 0, t2), 1), 0)
            newC = C ^ _gf_mul(coef[:, None], shifted)
            grow = (d != 0) & (2 * L <= k)
            keep = d != 0
            Bp = np.where(grow[:, None], C, Bp)
            L = np.where(grow, k + 1 - L, L)
            b = np.where(grow, d, b)
            m = np.where(grow, 1, m + 1)
            C = np.where(keep[:, None], newC, C)
        # Chien: position p is in error where Λ(α^−deg(p)) = 0
        xinv = EXP[(255 - deg) % 255]                                 # (n,)
        xp = np.ones(n, np.int64)
        val = np.zeros((B, n), np.int64)
        xpows = []
        for i in range(t2 + 1):
            xpows.append(xp.copy())
            val ^= _gf_mul(C[:, i:i + 1], xp[None, :])
            xp = _gf_mul(xp, xinv)
        roots = val == 0
        # Ω(x) = S(x)Λ(x) mod x^2t; e = X·Ω(X^−1)/Λ'(X^−1)
        omega = np.zeros((B, t2), np.int64)
        for i in range(t2):
            for j in range(i + 1):
                omega[:, i] ^= _gf_mul(s[:, j], C[:, i - j])
        om = np.zeros((B, n), np.int64)
        for i in range(t2):
            om ^= _gf_mul(omega[:, i:i + 1], xpows[i][None, :])
        dl = np.zeros((B, n), np.int64)
        for i in range(1, t2 + 1, 2):          # odd terms of Λ'
            dl ^= _gf_mul(C[:, i:i + 1], xpows[i - 1][None, :])
        X = EXP[deg % 255][None, :]
        inv_dl = EXP[(255 - LOG[np.maximum(dl, 1)]) % 255]
        e = _gf_mul(X, _gf_mul(om, inv_dl))
        good = (L <= t2 // 2) & (roots.sum(1) == L) & \
            ~(roots & ((dl == 0) | (e == 0))).any(1)
        fix = np.where(roots & good[:, None], e, 0)
        out[bad] ^= fix
        ok[bad] = good
        errors[bad] = np.where(good, roots.sum(1), 0)
    fixed = out.astype(np.uint8)
    flips = np.unpackbits((fixed ^ r.astype(np.uint8)), axis=1).sum(1)
    k = n - n_parity
    msg = np.where(ok[:, None], fixed[:, :k], r[:, :k].astype(np.uint8))
    return RsResult(msg.astype(np.uint8), ok, S.any(1), errors,
                    np.where(ok, flips, 0))


def forney(x: np.ndarray, branches: int, depth: int,
           inverse: bool = False) -> np.ndarray:
    """(..., n) bytes through the Forney interleaver (or deinterleaver)
    from an empty state: byte t goes down branch j = t mod I, delayed by
    j·M·I (interleave) or (I−1−j)·M·I (deinterleave) stream positions."""
    n = x.shape[-1]
    t = np.arange(n)
    j = t % branches
    d = ((branches - 1 - j) if inverse else j) * depth * branches
    src = t - d
    out = np.zeros_like(x)
    ok = src >= 0
    out[..., ok] = x[..., src[ok]]
    return out


# ── convolutional code and the chunked Viterbi ───────────────────────────────


def _parity(v: int) -> int:
    return bin(v).count("1") & 1


def conv_encode(bits: torch.Tensor, link: Link) -> torch.Tensor:
    """(B, n) info bits → (B, punctured) coded bits: zero tail, then the
    mother code's X (G1) and Y (G2) for each input, punctured."""
    K = link.K
    b = torch.nn.functional.pad(bits.to(torch.int32),
                                (K - 1, K - 1))           # history, tail
    n = bits.shape[1] + K - 1
    x = torch.zeros((bits.shape[0], n), dtype=torch.int32, device=bits.device)
    y = torch.zeros_like(x)
    for j in range(K):                   # tap j: the input j steps back
        win = b[:, K - 1 - j:K - 1 - j + n]
        if link.g1 >> (K - 1 - j) & 1:
            x ^= win
        if link.g2 >> (K - 1 - j) & 1:
            y ^= win
    both = torch.stack([x, y], -1).reshape(bits.shape[0], 2 * n)
    keep = torch.as_tensor(np.flatnonzero(_keep_mask(link.code_rate, n)),
                           device=bits.device)
    return both[:, keep].to(torch.uint8)


@lru_cache(maxsize=4)
def trellis(K: int, g1: int, g2: int):
    """The state s holds the last K−1 inputs, the newest at the top bit.
    For each state s and each of its two predecessors z: the predecessor
    ((s mod 2^(K−2)) << 1) | z and the signs (1 − 2c) of the X and Y bits
    sent on that branch."""
    S = 1 << (K - 1)
    prev = np.zeros((S, 2), np.int64)
    sx = np.zeros((S, 2), np.float32)
    sy = np.zeros((S, 2), np.float32)
    for s in range(S):
        u = s >> (K - 2)
        for z in range(2):
            p = ((s & (S // 2 - 1)) << 1) | z
            reg = (u << (K - 1)) | p            # input, then K−1 older ones
            prev[s, z] = p
            sx[s, z] = 1 - 2 * _parity(reg & g1)
            sy[s, z] = 1 - 2 * _parity(reg & g2)
    return prev, sx, sy


def chunk_rows(llr: torch.Tensor, info: int, link: Link):
    """(B, ≥ coded) LLRs → the chunk plan's lanes: c0, c1 (B·nchunk, C+2V)
    LLRs of X and Y (zeros where punctured and in the margins), pm0
    (B·nchunk, S) start metrics (the first chunk of a row at state 0,
    the others uniform), and nchunk. The first chunk's pin sits before
    its zero left margin, as the program's does, so no state is held at
    the row's first real step: the decode starts free."""
    n_steps = info + link.K - 1
    keep = np.flatnonzero(_keep_mask(link.code_rate, n_steps))
    full = llr.new_zeros((llr.shape[0], 2 * n_steps))
    full[:, torch.as_tensor(keep, device=llr.device)] = llr[:, :len(keep)]
    C, V = link.chunk_steps, link.chunk_overlap
    nchunk = -(-n_steps // C)
    pad = (V, nchunk * C - n_steps + V)
    x = torch.nn.functional.pad(full[:, 0::2], pad)
    y = torch.nn.functional.pad(full[:, 1::2], pad)
    span = C + 2 * V
    idx = torch.as_tensor((np.arange(nchunk)[:, None] * C
                           + np.arange(span)[None, :]).reshape(-1),
                          device=llr.device)
    B = llr.shape[0]
    c0 = x[:, idx].reshape(B * nchunk, span).contiguous()
    c1 = y[:, idx].reshape(B * nchunk, span).contiguous()
    S = 1 << (link.K - 1)
    pm0 = llr.new_zeros((B, nchunk, S))
    pm0[:, 0] = _BIG
    pm0[:, 0, 0] = 0.0
    return c0, c1, pm0.reshape(B * nchunk, S), nchunk


def viterbi_chunks(c0: torch.Tensor, c1: torch.Tensor, pm0: torch.Tensor,
                   link: Link, block: int = 4096) -> torch.Tensor:
    """The chunked decode, lanes in parallel (``block`` at a time): each
    step a state's two candidates are (metric of the predecessor + sign·X
    LLR) + sign·Y LLR, the larger wins (the predecessor with z = 0 on a
    tie), and the step's largest metric is subtracted from all; the
    traceback starts at the first state of largest final metric and gives
    each step's input, the state's top bit. (L, span) → (L, span) uint8."""
    prev, sx, sy = trellis(link.K, link.g1, link.g2)
    dev = c0.device
    prev = torch.as_tensor(prev, device=dev)
    sx = torch.as_tensor(sx, device=dev)
    sy = torch.as_tensor(sy, device=dev)
    S = prev.shape[0]
    top = link.K - 2
    out = torch.empty(c0.shape, dtype=torch.uint8, device=dev)
    for a in range(0, c0.shape[0], block):
        x = c0[a:a + block].t().contiguous()
        y = c1[a:a + block].t().contiguous()
        pm = pm0[a:a + block].clone()
        L, T = pm.shape[0], x.shape[0]
        dec = torch.empty((T, L, S), dtype=torch.bool, device=dev)
        for t in range(T):
            cand = (pm[:, prev] + sx * x[t][:, None, None]) \
                + sy * y[t][:, None, None]
            d = cand[..., 1] > cand[..., 0]
            pm = torch.where(d, cand[..., 1], cand[..., 0])
            pm = pm - pm.max(-1, keepdim=True).values
            dec[t] = d
        state = pm.argmax(-1)
        lanes = torch.arange(L, device=dev)
        for t in range(T - 1, -1, -1):
            out[a + lanes, t] = (state >> top).to(torch.uint8)
            state = ((state & (S // 2 - 1)) << 1) | dec[t][lanes, state] \
                .to(torch.int64)
    return out


def decoded_rows(bits: torch.Tensor, B: int, info: int,
                 link: Link) -> torch.Tensor:
    """The lanes' decisions without their margins, a row's chunks joined:
    (B·nchunk, span) → (B, info)."""
    V = link.chunk_overlap
    return bits[:, V:V + link.chunk_steps].reshape(B, -1)[:, :info]


def viterbi_ops(lanes: int, span: int, link: Link) -> int:
    """The add-compare-select operations of :func:`viterbi_chunks`."""
    return lanes * span * (1 << (link.K - 1)) * ACS_OPS_PER_STATE


# ── transmitter ──────────────────────────────────────────────────────────────


def transmit(link: Link, frames: list, device) -> torch.Tensor:
    """frames: [(frame number, cell id, payload uint8 array)], payloads of
    one length that fits a frame, each zero-padded to whole packets →
    (B, n_symbols·sps) complex64 on ``device``."""
    B = len(frames)
    n_pay = max(-(-len(frames[0][2]) // TS_PAYLOAD), 1)
    n_pkt = link.frame_packets(n_pay)
    pk = np.zeros((B, n_pkt, TS_LEN), np.uint8)
    pk[:, :, 0] = SYNC
    for i, (_, _, p) in enumerate(frames):
        pk[i, :n_pay, 1:] = np.concatenate([np.asarray(p, np.uint8), np.zeros(
            n_pay * TS_PAYLOAD - len(p), np.uint8)]).reshape(n_pay, TS_PAYLOAD)
    pk[:, n_pay:] = null_packet()
    words = rs_encode(disperse(pk).reshape(-1, TS_LEN), link.rs_n)
    stream = words.reshape(B, -1)
    pad = -(-stream.shape[1] // link.branches) * link.branches \
        - stream.shape[1]
    stream = np.concatenate([stream, np.zeros((B, pad + link.delay),
                                              np.uint8)], 1)
    il = forney(stream, link.branches, link.depth)
    coded = conv_encode(torch.as_tensor(np.unpackbits(il, axis=1),
                                        device=device), link)
    coded = coded[:, :link.capacity]
    cells = map_cells(coded, link.vbits).reshape(B, link.n_symbols,
                                                 DATA_CARRIERS)
    grid = torch.zeros((B, link.n_symbols, N_FFT), dtype=torch.complex64,
                       device=device)
    for p in range(4):
        ph = phase(p)
        s = torch.arange(p, link.n_symbols, 4, device=device)
        sub = torch.zeros((B, len(s), N_FFT), dtype=torch.complex64,
                          device=device)
        sub[..., torch.as_tensor(ph.data, device=device)] = cells[:, s]
        sub[..., torch.as_tensor(ph.pilots, device=device)] = torch.as_tensor(
            ph.pilot_vals, device=device).to(torch.complex64)
        grid[:, s] = sub
    w = wk()
    ref = 1.0 - 2.0 * w[np.asarray(TPS_CARRIERS)].astype(np.float32)
    tps = np.zeros((B, link.n_symbols, len(TPS_CARRIERS)), np.float32)
    for i, (fn, cid, _) in enumerate(frames):
        bits = tps_bits(fn, link, cid)
        sign = np.cumprod(np.where(np.arange(link.n_symbols) == 0, 1.0,
                                   1.0 - 2.0 * bits[:link.n_symbols]))
        tps[i] = sign[:, None] * ref[None, :]
    grid[..., torch.as_tensor(to_bin(TPS_CARRIERS), device=device)] = \
        torch.as_tensor(tps, device=device).to(torch.complex64)
    x = torch.fft.ifft(grid, dim=-1).to(torch.complex64)
    x = torch.cat([x[..., -link.cp_len:], x], -1)
    return x.reshape(B, -1)


# ── receiver ─────────────────────────────────────────────────────────────────


@dataclass
class RxRecord:
    """What the receiver produced at each layer: each frame's TPS fields,
    the chunk lanes as handed to the Viterbi (c0, c1, pm0; ``nchunk`` a
    frame) and the decoded rows (B, info bits) their kept decisions make,
    the RS words' outcome, each frame's RS output row (message bytes, every
    word corrected), each frame's result."""
    tps: list = field(default_factory=list)
    c0: torch.Tensor = None
    c1: torch.Tensor = None
    pm0: torch.Tensor = None
    nchunk: int = 0
    rows: torch.Tensor = None
    rs: RsResult = None
    outer: list = field(default_factory=list)
    frames: list = field(default_factory=list)


def symbols(iq: torch.Tensor, link: Link, rnd=_keep) -> torch.Tensor:
    """(B, ≥ n_symbols·sps) → (B, n_symbols, 2048) spectra."""
    x = iq[:, :link.n_symbols * link.sps].reshape(
        iq.shape[0], link.n_symbols, link.sps)[..., link.cp_len:]
    return rnd(torch.fft.fft(x, dim=-1).to(torch.complex64))


def llrs(freq: torch.Tensor, link: Link, rnd=_keep) -> torch.Tensor:
    """Spectra → (B, capacity) CSI-weighted LLRs of the coded stream."""
    B, n_sym, _ = freq.shape
    dev = freq.device
    out = torch.zeros((B, n_sym, DATA_CARRIERS * link.vbits),
                      dtype=torch.float32, device=dev)
    for p in range(4):
        ph = phase(p)
        s = torch.arange(p, n_sym, 4, device=dev)
        f = freq[:, s]

        def at(bins):
            return f[..., torch.as_tensor(bins, device=dev)]
        ratio = at(ph.pilots) / torch.as_tensor(ph.pilot_vals, device=dev)
        t = torch.as_tensor(ph.t, device=dev)
        h = ratio[..., torch.as_tensor(ph.left, device=dev)] * (1 - t) \
            + ratio[..., torch.as_tensor(ph.right, device=dev)] * t
        csi = (h.abs() ** 2).to(torch.float32)
        eq = at(ph.data) * torch.conj(h) / torch.clamp(csi, min=1e-6)
        w = csi / torch.clamp(csi.mean(-1, keepdim=True), min=1e-9)
        llr = soft_llr(eq.to(torch.complex64), link.vbits)
        out[:, s] = (llr.reshape(w.shape + (link.vbits,))
                     * w[..., None]).reshape(llr.shape)
    return rnd(out.reshape(B, -1))


def receive(link: Link, iq: torch.Tensor, payload_len: int,
            rnd=None) -> RxRecord:
    """Decode aligned frames (B, T) → RxRecord; its ``frames`` hold ("ok",
    frame number, constellation, code rate, guard, cell id, payload bytes)
    or ("err", what failed) a frame."""
    rnd = rnd or _keep
    rec = RxRecord()
    B = iq.shape[0]
    freq = symbols(iq, link, rnd)
    cells = freq[..., torch.as_tensor(to_bin(TPS_CARRIERS),
                                      device=iq.device)].cpu().numpy()
    rec.tps = [tps_decode(c) for c in cells]
    n_ts = max(-(-payload_len // TS_PAYLOAD), 1)
    info = link.info_bits(n_ts)
    llr = llrs(freq, link, rnd)[:, :link.coded_bits(n_ts)]
    rec.c0, rec.c1, rec.pm0, rec.nchunk = chunk_rows(llr, info, link)
    rec.rows = decoded_rows(viterbi_chunks(rec.c0, rec.c1, rec.pm0, link),
                            B, info, link)
    byts = np.packbits(rec.rows.cpu().numpy(), axis=1)
    n_words = n_ts * link.rs_n
    de = forney(byts, link.branches, link.depth, inverse=True)[
        :, link.delay:link.delay + n_words]
    rec.rs = rs_decode(de.reshape(-1, link.rs_n), link.rs_n - link.rs_k)
    msg = rec.rs.msg.reshape(B, -1)
    ok = rec.rs.ok.reshape(B, n_ts).all(1)
    rec.outer = [(m, bool(o)) for m, o in zip(msg, ok)]
    ts = disperse(msg.reshape(B, n_ts, TS_LEN))
    for b in range(B):
        if rec.tps[b] is None:
            rec.frames.append(("err", "tps"))
        elif not ok[b] or not (ts[b, :, 0] == SYNC).all():
            rec.frames.append(("err", "payload"))
        else:
            rec.frames.append(("ok",) + rec.tps[b] + (
                bytes(ts[b, :, 1:].reshape(-1)[:payload_len]),))
    return rec
