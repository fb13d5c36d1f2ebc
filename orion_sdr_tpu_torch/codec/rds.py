"""RDS (Radio Data System, IEC 62106) block/group codec — the 57 kHz data
channel of an FM broadcast MPX (the port's own copy of
``orion_sdr_tpu/codec/rds.py``, numpy, bit-exact with it). The physical
layer lives in modulate/fm_stereo.py and demodulate/fm_stereo.py.

Coding layer (host numpy — pure bit domain):
* (26,16) shortened cyclic block code, g(x) = x¹⁰+x⁸+x⁷+x⁵+x⁴+x³+1, with
  the block's role signalled by a 10-bit offset word XOR-ed onto the
  checkword (A/B/C/C'/D).
* Groups of 4 blocks (104 bits): PI | B | C/C' | D. Implemented group
  types: 0A (program service name + TA/MS/DI), 2A (64-char radiotext).
* Decode is detection-based: blocks whose syndrome matches no offset are
  dropped and the group is discarded (single-bit correction is applied
  when exactly one flipped bit restores a valid offset).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

RDS_GEN = 0x5B9              # g(x), degree 10, bit i = coefficient of x^i
RDS_BLOCK_BITS = 26
RDS_INFO_BITS = 16
RDS_CHECK_BITS = 10
RDS_GROUP_BITS = 4 * RDS_BLOCK_BITS

RDS_OFFSETS: Dict[str, int] = {
    "A": 0x0FC, "B": 0x198, "C": 0x168, "C'": 0x350, "D": 0x1B4,
}
_OFFSET_FROM = {v: k for k, v in RDS_OFFSETS.items()}

RDS_SYMBOL_RATE = 1187.5     # bits/s = 57 kHz / 48


def rds_crc10(word16: int) -> int:
    """m(x)·x¹⁰ mod g(x) for a 16-bit info word (MSB = highest degree)."""
    reg = (word16 & 0xFFFF) << RDS_CHECK_BITS
    for i in range(RDS_INFO_BITS - 1, -1, -1):
        if reg & (1 << (i + RDS_CHECK_BITS)):
            reg ^= RDS_GEN << i
    return reg & ((1 << RDS_CHECK_BITS) - 1)


def rds_block_encode(word16: int, offset: str) -> np.ndarray:
    """16-bit info + role offset → 26 transmitted bits (MSB-first)."""
    check = rds_crc10(word16) ^ RDS_OFFSETS[offset]
    v = ((word16 & 0xFFFF) << RDS_CHECK_BITS) | check
    return ((v >> np.arange(RDS_BLOCK_BITS - 1, -1, -1)) & 1).astype(np.uint8)


def rds_block_classify(bits26) -> Tuple[Optional[str], int]:
    """→ (offset name | None, info word), clean blocks only: the syndrome
    crc(info) ⊕ check equals the offset word exactly when error-free. No
    correction here — a 1-bit error pattern can sit within distance 1 of a
    DIFFERENT offset's coset (measured: e₆⊕e₇ maps B→A), so correction is
    only safe when the expected role is known (see _classify_expected)."""
    b = np.asarray(bits26, np.uint8) & 1
    word = int(b[:RDS_INFO_BITS] @ (1 << np.arange(RDS_INFO_BITS - 1, -1, -1)))
    check = int(b[RDS_INFO_BITS:] @ (1 << np.arange(RDS_CHECK_BITS - 1, -1, -1)))
    return _OFFSET_FROM.get(rds_crc10(word) ^ check), word


def _classify_expected(bits26, roles: Tuple[str, ...]
                       ) -> Tuple[Optional[str], int]:
    """Classify against an expected role set; single-bit correction is
    attempted only toward those roles (sync position fixes the role, which
    removes the cross-coset ambiguity)."""
    name, word = rds_block_classify(bits26)
    if name in roles:
        return name, word
    b = np.asarray(bits26, np.uint8) & 1
    for i in range(RDS_BLOCK_BITS):
        bb = b.copy()
        bb[i] ^= 1
        name, word = rds_block_classify(bb)
        if name in roles:
            return name, word
    return None, word


# ── group layer ──────────────────────────────────────────────────────────────


def _block_b(group_type: int, version_b: bool, tp: bool, pty: int,
             app5: int) -> int:
    return ((group_type & 0xF) << 12) | (int(version_b) << 11) \
        | (int(tp) << 10) | ((pty & 0x1F) << 5) | (app5 & 0x1F)


def rds_groups_0a(pi: int, pty: int = 0, tp: bool = False,
                  ps_name: str = "", ta: bool = False, ms: bool = True,
                  af_word: int = 0xE0E0) -> List[Tuple[int, int, int, int]]:
    """Type 0A groups carrying the 8-char program-service name (2 chars per
    group, 4 segments)."""
    ps = (ps_name + " " * 8)[:8]
    out = []
    for seg in range(4):
        di = 0                         # DI bits not modelled
        app = (int(ta) << 4) | (int(ms) << 3) | (di << 2) | seg
        d = (ord(ps[2 * seg]) << 8) | ord(ps[2 * seg + 1])
        out.append((pi & 0xFFFF, _block_b(0, False, tp, pty, app),
                    af_word & 0xFFFF, d))
    return out


def rds_groups_2a(pi: int, pty: int = 0, tp: bool = False,
                  radiotext: str = "", ab_flag: bool = False
                  ) -> List[Tuple[int, int, int, int]]:
    """Type 2A groups carrying radiotext (4 chars per group, ≤16 segments =
    64 chars; a '\\r' terminates short messages per the spec)."""
    rt = radiotext[:64]
    if len(rt) < 64:
        rt += "\r"
    n_seg = -(-len(rt) // 4)
    rt = (rt + " " * (4 * n_seg))[: 4 * n_seg]
    out = []
    for seg in range(n_seg):
        app = (int(ab_flag) << 4) | seg
        cs = rt[4 * seg: 4 * seg + 4]
        c = (ord(cs[0]) << 8) | ord(cs[1])
        d = (ord(cs[2]) << 8) | ord(cs[3])
        out.append((pi & 0xFFFF, _block_b(2, False, tp, pty, app), c, d))
    return out


def rds_encode_groups(groups) -> np.ndarray:
    """[(blockA, blockB, blockC, blockD) words] → transmitted bit stream."""
    bits = []
    for a, b, c, d in groups:
        version_b = (b >> 11) & 1
        bits.append(rds_block_encode(a, "A"))
        bits.append(rds_block_encode(b, "B"))
        bits.append(rds_block_encode(c, "C'" if version_b else "C"))
        bits.append(rds_block_encode(d, "D"))
    return np.concatenate(bits) if bits else np.zeros(0, np.uint8)


@dataclass
class RdsData:
    """Accumulated station data from decoded groups."""
    pi: Optional[int] = None
    pty: Optional[int] = None
    tp: Optional[bool] = None
    ps_name: str = " " * 8
    radiotext: str = ""
    groups: List[Tuple[int, int, int, int]] = field(default_factory=list)

    def _apply(self, a: int, b: int, c: int, d: int) -> None:
        self.groups.append((a, b, c, d))
        self.pi = a
        self.pty = (b >> 5) & 0x1F
        self.tp = bool((b >> 10) & 1)
        gtype, version = (b >> 12) & 0xF, (b >> 11) & 1
        if gtype == 0 and version == 0:
            seg = b & 0x3
            ps = list(self.ps_name)
            ps[2 * seg] = chr((d >> 8) & 0x7F)
            ps[2 * seg + 1] = chr(d & 0x7F)
            self.ps_name = "".join(ps)
        elif gtype == 2 and version == 0:
            seg = b & 0xF
            rt = list((self.radiotext + " " * 64)[:64])
            for j, w in enumerate((c, d)):
                rt[4 * seg + 2 * j] = chr((w >> 8) & 0x7F)
                rt[4 * seg + 2 * j + 1] = chr(w & 0x7F)
            self.radiotext = "".join(rt).split("\r")[0].rstrip()


_ROLES = (("A",), ("B",), ("C", "C'"), ("D",))


def _synd_basis() -> np.ndarray:
    """(26, 10) GF(2) syndrome of each unit-bit error: the code is linear,
    so every window's syndrome is one bit-matrix product — this is what
    lets the sync scan run vectorized over the whole stream."""
    basis = np.zeros((RDS_BLOCK_BITS, RDS_CHECK_BITS), np.uint8)
    for j in range(RDS_INFO_BITS):
        s = rds_crc10(1 << (RDS_INFO_BITS - 1 - j))
        basis[j] = (s >> np.arange(RDS_CHECK_BITS - 1, -1, -1)) & 1
    for j in range(RDS_CHECK_BITS):
        basis[RDS_INFO_BITS + j, j] = 1
    return basis


_BASIS = _synd_basis()
_P10 = (1 << np.arange(RDS_CHECK_BITS - 1, -1, -1)).astype(np.int64)
_P16 = (1 << np.arange(RDS_INFO_BITS - 1, -1, -1)).astype(np.int64)
_ROLE_LUT = np.full(1 << RDS_CHECK_BITS, -1, np.int8)
for _i, _name in enumerate(("A", "B", "C", "C'", "D")):
    _ROLE_LUT[RDS_OFFSETS[_name]] = _i


def rds_decode_bits(bits) -> RdsData:
    """Bit stream (any alignment) → RdsData. Every window's syndrome and
    info word are computed in ONE vectorized pass (windowed bit-matrix
    product — the code is GF(2)-linear), block sync = the first position
    whose four consecutive windows classify clean as A, B, C/C', D; the
    synced walk classifies each block against its expected role with
    single-bit correction, drops groups with an unrecovered block, and
    abandons sync after a fully-dead group."""
    b = np.asarray(bits, np.uint8) & 1
    data = RdsData()
    if len(b) < RDS_GROUP_BITS:
        return data
    win = np.lib.stride_tricks.sliding_window_view(b, RDS_BLOCK_BITS)
    synd = (win @ _BASIS) % 2 @ _P10              # (L−25,) 10-bit syndromes
    roles = _ROLE_LUT[synd]                       # -1 | A..D per position
    words = win[:, :RDS_INFO_BITS] @ _P16
    L = len(roles)

    def next_sync(start: int) -> int:
        lim = L - 3 * 26
        if start >= lim:
            return -1
        r0 = roles[start:lim]
        ok = (r0 == 0) & (roles[start + 26:lim + 26] == 1) \
            & ((roles[start + 52:lim + 52] == 2)
               | (roles[start + 52:lim + 52] == 3)) \
            & (roles[start + 78:lim + 78] == 4)
        hits = np.flatnonzero(ok)
        return start + int(hits[0]) if hits.size else -1

    i = next_sync(0)
    while i >= 0 and i + RDS_GROUP_BITS <= len(b):
        got, ws = [], []
        for k, role_ids in enumerate(((0,), (1,), (2, 3), (4,))):
            r = int(roles[i + 26 * k])
            if r in role_ids:
                got.append(r)
                ws.append(int(words[i + 26 * k]))
            else:                         # role-aware single-bit correction
                name, word = _classify_expected(
                    b[i + 26 * k: i + 26 * (k + 1)], _ROLES[k])
                got.append(None if name is None else k)
                ws.append(word)
        n_ok = sum(g is not None for g in got)
        if n_ok == 4:
            data._apply(*ws)
            i += RDS_GROUP_BITS
        elif n_ok >= 2:
            i += RDS_GROUP_BITS          # hold sync through one damaged group
        else:
            i = next_sync(i + 1)
    return data
