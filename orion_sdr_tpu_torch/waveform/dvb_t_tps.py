"""DVB-T Transmission Parameter Signalling (counterpart of
``orion_sdr_tpu/waveform/dvb_t_tps.py``; ETSI EN 300 744 §4.6).

17 TPS carriers each carry the SAME DBPSK-encoded bit per symbol, spelling a
68-bit word per 68-symbol frame: sync word, length, frame number,
constellation, hierarchy, code rates, guard, mode, cell id, protected by a
shortened BCH(67,53) t=2 over GF(2^7) (prim poly x^7+x^3+1, generator
0x4377).

Host numpy: a frame's TPS cells are a cumulative product along the symbol
axis, its decode a (68, 17) correlation against the previous symbol row,
and the BCH runs once per frame.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Optional

import numpy as np

from .dvb_t import wk_prbs, DVB_T_TPS_CARRIERS_2K, DVB_T_ACTIVE_CARRIERS

GF128_PRIM = 0x89          # x^7 + x^3 + 1
GF128_ORDER = 127
TPS_BCH_GEN = 0x4377       # x^14+x^9+x^8+x^6+x^5+x^4+x^2+x+1
TPS_CODEWORD_BITS = 67
TPS_INFO_BITS = 53
TPS_PARITY_BITS = 14

TPS_SYNC_WORD_13 = 0b0011010111101110
TPS_SYNC_WORD_24 = 0b1100101000010001
_TPS_LENGTH_WITH_CELL_ID = 0b011111

TPS_CARRIER_COUNT = len(DVB_T_TPS_CARRIERS_2K)
TPS_SYMBOLS_PER_FRAME = 68


@lru_cache(maxsize=1)
def _gf128():
    exp = np.zeros(2 * GF128_ORDER, np.uint8)
    log = np.zeros(GF128_ORDER + 1, np.uint8)
    x = 1
    for i in range(GF128_ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x80:
            x ^= GF128_PRIM
    exp[GF128_ORDER:] = exp[:GF128_ORDER]
    return exp, log


def _gf_mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    exp, log = _gf128()
    return int(exp[int(log[a]) + int(log[b])])


def tps_bch_parity(info) -> int:
    """14 parity bits of info·x^14 mod h(x) via a shift-register division."""
    reg = 0
    top = 1 << TPS_PARITY_BITS
    for b in list(np.asarray(info, np.uint8)) + [0] * TPS_PARITY_BITS:
        reg = (reg << 1) | (int(b) & 1)
        if reg & top:
            reg ^= TPS_BCH_GEN
    return reg & ((1 << TPS_PARITY_BITS) - 1)


def tps_bch_encode(info) -> np.ndarray:
    """53 info bits → 67-bit systematic codeword [info | parity]."""
    info = np.asarray(info, np.uint8)
    if len(info) != TPS_INFO_BITS:
        raise ValueError(f"expected {TPS_INFO_BITS} info bits, got {len(info)}")
    parity = tps_bch_parity(info)
    pbits = [(parity >> (TPS_PARITY_BITS - 1 - i)) & 1
             for i in range(TPS_PARITY_BITS)]
    return np.concatenate([info, np.asarray(pbits, np.uint8)])


def tps_bch_decode(codeword) -> Optional[np.ndarray]:
    """Correct ≤2 errors; returns the 53 info bits or None."""
    cw = np.asarray(codeword, np.uint8)
    if len(cw) != TPS_CODEWORD_BITS:
        return None
    exp, log = _gf128()
    # codeword index j has locator exponent (66 − j) in the shortened code
    degs = TPS_CODEWORD_BITS - 1 - np.arange(TPS_CODEWORD_BITS)
    ones = np.flatnonzero(cw)
    # syndromes S_i = Σ_{j: r_j=1} α^(i·deg_j), i = 1..4
    S = []
    for i in range(1, 5):
        acc = 0
        for j in ones:
            acc ^= int(exp[(i * int(degs[j])) % GF128_ORDER])
        S.append(acc)
    if not any(S):
        return cw[:TPS_INFO_BITS].copy()

    s1, s2, s3, _s4 = S
    # t=2 direct solution: error locator σ(x) = 1 + σ1 x + σ2 x²
    # σ1 = S1; σ2 = (S3 + S1³)/S1 (binary BCH; S2 = S1²).
    err_pos = []
    if s1 != 0:
        s1_sq = _gf_mul(s1, s1)
        s1_cu = _gf_mul(s1_sq, s1)
        num = s3 ^ s1_cu
        if num == 0:
            # single error at position with α^deg = S1
            d = int(log[s1])
            err_pos = [d]
        else:
            inv_s1 = int(exp[(GF128_ORDER - int(log[s1])) % GF128_ORDER])
            sig2 = _gf_mul(num, inv_s1)
            # Chien: roots of 1 + σ1 x + σ2 x², error degrees d where
            # x = α^{-d} is a root ⇔ σ2·α^{-2d} + σ1·α^{-d} + 1 = 0
            for d in range(GF128_ORDER):
                x = int(exp[(GF128_ORDER - d) % GF128_ORDER])
                v = _gf_mul(sig2, _gf_mul(x, x)) ^ _gf_mul(s1, x) ^ 1
                if v == 0:
                    err_pos.append(d)
            if len(err_pos) != 2:
                return None
    else:
        return None  # S1 = 0 with nonzero syndrome → uncorrectable for t=2

    out = cw.copy()
    for d in err_pos:
        idx = TPS_CODEWORD_BITS - 1 - d
        if not (0 <= idx < TPS_CODEWORD_BITS):
            return None  # error in the implicit shortened prefix
        out[idx] ^= 1
    # verify
    ones = np.flatnonzero(out)
    for i in range(1, 5):
        acc = 0
        for j in ones:
            acc ^= int(exp[(i * int(degs[j])) % GF128_ORDER])
        if acc:
            return None
    return out[:TPS_INFO_BITS].copy()


# ── TpsWord ──────────────────────────────────────────────────────────────────

_CONSTELLATION_CODE = {"qpsk": 0b00, "qam16": 0b01, "qam64": 0b10}
_CONSTELLATION_FROM = {v: k for k, v in _CONSTELLATION_CODE.items()}
_RATE_CODE = {"1/2": 0b000, "2/3": 0b001, "3/4": 0b010, "5/6": 0b011,
              "7/8": 0b100}
_RATE_FROM = {v: k for k, v in _RATE_CODE.items()}
_GUARD_CODE = {"1/32": 0b00, "1/16": 0b01, "1/8": 0b10, "1/4": 0b11}
_GUARD_FROM = {v: k for k, v in _GUARD_CODE.items()}
# s26..s28 hierarchy information (§4.6.2.5): non-hierarchical or α value.
_HIERARCHY_CODE = {0: 0b000, 1: 0b001, 2: 0b010, 4: 0b011}
_HIERARCHY_FROM = {v: k for k, v in _HIERARCHY_CODE.items()}


@dataclass(frozen=True)
class TpsWord:
    """Decoded TPS parameters for one frame (ref TpsWord; ``hierarchy`` /
    ``code_rate_lp`` extend it with §4.6.2.5's hierarchical signalling —
    hierarchy 0 = non-hierarchical, else the α value, with the LP stream's
    code rate in s32..s34)."""
    frame_number: int = 0
    constellation: str = "qpsk"
    code_rate_hp: str = "1/2"
    guard: str = "1/32"
    cell_id: int = 0
    hierarchy: int = 0
    code_rate_lp: Optional[str] = None

    def sync_word(self) -> int:
        return TPS_SYNC_WORD_13 if self.frame_number % 2 == 0 \
            else TPS_SYNC_WORD_24

    def pack(self) -> np.ndarray:
        """→ 68 bits s0..s67 (s0 = DBPSK init slot, 0)."""
        info = np.zeros(TPS_INFO_BITS, np.uint8)

        def put(start, width, value):
            for j in range(width):
                info[start + j] = (value >> (width - 1 - j)) & 1

        put(0, 16, self.sync_word())                       # s1..s16
        put(16, 6, _TPS_LENGTH_WITH_CELL_ID)               # s17..s22
        put(22, 2, self.frame_number & 0b11)               # s23,s24
        put(24, 2, _CONSTELLATION_CODE.get(self.constellation, 0))
        put(26, 3, _HIERARCHY_CODE[self.hierarchy])        # s26..s28
        rate = _RATE_CODE[self.code_rate_hp]
        put(29, 3, rate)                                   # HP rate
        # LP rate; a non-hierarchical word mirrors HP (wire-identical to the
        # reference's packing)
        put(32, 3, _RATE_CODE[self.code_rate_lp]
            if self.code_rate_lp is not None else rate)
        put(35, 2, _GUARD_CODE[self.guard])
        put(37, 2, 0)                                      # 2K mode = 00
        put(39, 8, self.cell_id & 0xFF)
        cw = tps_bch_encode(info)
        return np.concatenate([np.zeros(1, np.uint8), cw])

    @classmethod
    def unpack(cls, bits) -> Optional["TpsWord"]:
        bits = np.asarray(bits, np.uint8)
        if len(bits) != 68:
            return None
        info = tps_bch_decode(bits[1:])
        if info is None:
            return None

        def get(start, width):
            v = 0
            for j in range(width):
                v = (v << 1) | int(info[start + j])
            return v

        # the BCH(67,53) t=2 check alone passes ~14% of random words —
        # the fixed sync word (matched against the frame-number parity) and
        # the constant length field are the real false-accept guards
        frame_number = get(22, 2)
        sync = get(0, 16)
        want = TPS_SYNC_WORD_13 if frame_number % 2 == 0 else TPS_SYNC_WORD_24
        if sync != want or get(16, 6) != _TPS_LENGTH_WITH_CELL_ID:
            return None
        constellation = _CONSTELLATION_FROM.get(get(24, 2))
        rate = _RATE_FROM.get(get(29, 3))
        hierarchy = _HIERARCHY_FROM.get(get(26, 3))
        rate_lp = _RATE_FROM.get(get(32, 3))
        if constellation is None or rate is None or hierarchy is None \
                or rate_lp is None:
            return None
        # a non-hierarchical word whose LP field mirrors HP round-trips to
        # the reference-compatible default (code_rate_lp=None)
        if hierarchy == 0 and rate_lp == rate:
            rate_lp = None
        return cls(frame_number=get(22, 2), constellation=constellation,
                   code_rate_hp=rate, guard=_GUARD_FROM[get(35, 2)],
                   cell_id=get(39, 8), hierarchy=hierarchy,
                   code_rate_lp=rate_lp)


# ── DBPSK along the symbol axis ──────────────────────────────────────────────


def tps_reference_signs() -> np.ndarray:
    """±1 per TPS carrier from w_k at the carriers' absolute indices."""
    wk = wk_prbs(DVB_T_ACTIVE_CARRIERS)
    return (2.0 * (0.5 - wk[DVB_T_TPS_CARRIERS_2K].astype(np.float32)))


def tps_encode_frame(bits) -> np.ndarray:
    """68 TPS bits → (68, 17) complex cell values (±1 real, data power).

    Symbol 0 carries the absolute w_k reference; later symbols flip when
    s_l = 1 — the whole frame is one cumulative product (ref TpsEncoder)."""
    b = np.asarray(bits, np.uint8)[:TPS_SYMBOLS_PER_FRAME]
    flips = np.where(np.arange(len(b)) == 0, 1.0,
                     1.0 - 2.0 * b.astype(np.float32))
    sign_seq = np.cumprod(flips)
    cells = sign_seq[:, None] * tps_reference_signs()[None, :]
    return cells.astype(np.complex64)


def tps_decode_frame(cells) -> np.ndarray:
    """(n_sym, 17) received TPS cells → n_sym bits (s0 recorded as 0).

    Differential: s_l = 1 iff mean Re(c_l · conj(c_{l-1})) < 0."""
    c = np.asarray(cells)
    corr = np.sum((c[1:] * np.conj(c[:-1])).real, axis=-1)
    bits = (corr < 0.0).astype(np.uint8)
    return np.concatenate([np.zeros(1, np.uint8), bits])


class TpsDecoder:
    """Streaming per-symbol decoder (ref TpsDecoder) for the frame RX loop."""

    def __init__(self) -> None:
        self.prev: Optional[np.ndarray] = None
        self.bits: list = []

    def reset(self) -> None:
        self.prev = None
        self.bits = []

    def feed_symbol(self, cells) -> None:
        cells = np.asarray(cells)[:TPS_CARRIER_COUNT]
        if self.prev is None:
            self.bits.append(0)
        else:
            acc = float(np.sum((cells * np.conj(self.prev)).real))
            self.bits.append(int(acc < 0.0))
        self.prev = cells.copy()

    def is_complete(self) -> bool:
        return len(self.bits) >= TPS_SYMBOLS_PER_FRAME

    def word(self) -> Optional[TpsWord]:
        if not self.is_complete():
            return None
        return TpsWord.unpack(np.asarray(self.bits[:TPS_SYMBOLS_PER_FRAME],
                                         np.uint8))
