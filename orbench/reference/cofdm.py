"""The benchmark's plain COFDM LDPC+BCH frame link: transmitter and
receiver in plain torch and numpy, written from the link's definition.

Frame body (after the S&C preamble and the training symbol): a header
block (14 field bytes: mcs 1, payload length 4, sequence 4, flags 1,
scrambler seed 4, big-endian; CRC-16/CCITT-FALSE; one N512R12 codeword;
BPSK) and the payload (CRC-32; BCH t=8 on 120-bit blocks; N512R12
codewords; the MCS's constellation), each zero-padded to whole blocks and
whole OFDM symbols. OFDM: unity forward FFT, 1/N inverse, a cyclic prefix,
the data carriers a contiguous span with an edge guard and a null DC.
Constellations: per-axis Gray, unit mean energy, positive LLR ⇒ bit 0,
max-log LLRs. The receiver decodes aligned bodies on a flat channel:
symbol FFT → data bins → LLRs → each LDPC block scaled to RMS 4 →
sum-product BP → BCH → CRC, frames grouped by (mcs, payload length).

``rnd`` rounds the FFT output, the LLRs and every BP message to a lower
precision for the control; None keeps float32.
"""

from __future__ import annotations

import binascii
import zlib
from dataclasses import dataclass, field

import numpy as np
import torch

from . import ldpc
from .bch import Bch

BPS = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}
HEADER_ERR = "header CRC mismatch"
MALFORMED = "malformed frame header"
CRC_ERR = "payload CRC mismatch"


def _keep(x):
    return x


@dataclass(frozen=True)
class Link:
    """The link of a configuration file's ``link`` object."""
    n_fft: int
    cp_len: int
    edge_guard: int
    header_bytes: int
    header_constellation: str
    ldpc: str
    ladder: tuple            # constellation of each MCS index
    bch_t: int
    bch_info_bits: int
    ldpc_max_iter: int
    llr_rms: float

    @classmethod
    def of(cls, cfg: dict) -> "Link":
        k = cfg["link"]
        return cls(k["n_fft"], k["cp_len"], k["edge_guard"],
                   k["header"]["field_bytes"], k["header"]["constellation"],
                   k["ldpc"], tuple(m["constellation"] for m in k["mcs"]),
                   k["bch_t"], k["bch_info_bits"], k["ldpc_max_iter"],
                   k["ldpc_llr_rms"])

    @property
    def sps(self) -> int:
        return self.n_fft + self.cp_len

    @property
    def data_bins(self) -> np.ndarray:
        lo, hi = -(self.n_fft // 2), (self.n_fft - 1) // 2
        g = self.edge_guard
        return np.array([i % self.n_fft for i in range(lo + 1 + g, hi - g + 1)
                         if i != 0], np.int64)

    @property
    def code(self) -> ldpc.Code:
        return ldpc.code(self.ldpc)

    @property
    def bch(self) -> Bch:
        return _bch(self.bch_t, self.bch_info_bits)

    def n_sym(self, constellation: str, bits: int) -> int:
        return -(-bits // (len(self.data_bins) * BPS[constellation]))

    def header_bits(self) -> int:
        """Coded bits of the header block."""
        return -(-(self.header_bytes + 2) * 8 // self.code.k) * self.code.n

    def plan(self, payload_len: int) -> dict:
        framed = payload_len + 4
        outer = -(-framed * 8 // self.bch_info_bits) * self.bch.n
        coded = -(-outer // self.code.k) * self.code.n
        return {"framed": framed, "outer": outer, "coded": coded}

    def body_len(self, mcs: int, payload_len: int) -> int:
        return self.sps * (self.n_sym(self.header_constellation,
                                      self.header_bits())
                           + self.n_sym(self.ladder[mcs],
                                        self.plan(payload_len)["coded"]))


_BCH: dict = {}


def _bch(t, k):
    if (t, k) not in _BCH:
        _BCH[(t, k)] = Bch(t, k)
    return _BCH[(t, k)]


def crc16(data: bytes) -> int:
    return binascii.crc_hqx(bytes(data), 0xFFFF)


def crc32(data: bytes) -> int:
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


# ── constellations ───────────────────────────────────────────────────────────


def _axis(bps: int):
    k = bps // 2
    m = 1 << k
    scale = float(1.0 / np.sqrt(2.0 * (m * m - 1) / 3.0))
    levels = ((2 * np.arange(m) + 1 - m) * scale).astype(np.float32)
    return k, m, scale, levels


def map_bits(bits: torch.Tensor, constellation: str) -> torch.Tensor:
    """(..., n·bps) bits → (..., n) complex64 unit-energy symbols."""
    bps = BPS[constellation]
    b = bits.to(torch.int64) & 1
    if constellation == "bpsk":
        re = (1 - 2 * b).to(torch.float32)
        return torch.complex(re, torch.zeros_like(re))
    b = b.reshape(b.shape[:-1] + (-1, bps))
    if constellation == "qpsk":
        s = float(1.0 / np.sqrt(2.0))
        return torch.complex((1 - 2 * b[..., 0]).to(torch.float32) * s,
                             (1 - 2 * b[..., 1]).to(torch.float32) * s)
    k, m, scale, _ = _axis(bps)
    w = torch.tensor([1 << (k - 1 - i) for i in range(k)], device=b.device)

    def amp(ax):
        gray = (ax * w).sum(-1)
        nat = gray.clone()
        shift = 1
        while shift < k:
            nat = nat ^ (nat >> shift)
            shift *= 2
        return (2 * nat + 1 - m).to(torch.float32) * scale
    return torch.complex(amp(b[..., :k]), amp(b[..., k:]))


def soft_llr(z: torch.Tensor, constellation: str) -> torch.Tensor:
    """(..., n) symbols → (..., n·bps) float32 max-log LLRs."""
    if constellation == "bpsk":
        return 4.0 * z.real.to(torch.float32)
    if constellation == "qpsk":
        s = 4.0 * np.sqrt(2.0)
        llr = torch.stack([s * z.real, s * z.imag], dim=-1)
        return llr.reshape(z.shape[:-1] + (-1,)).to(torch.float32)
    k, m, _, levels = _axis(BPS[constellation])
    gray = np.arange(m) ^ (np.arange(m) >> 1)
    bit = (gray[:, None] >> np.arange(k - 1, -1, -1)[None, :]) & 1
    lv = torch.as_tensor(levels, device=z.device)
    is1 = torch.as_tensor(bit.T.astype(bool), device=z.device)
    big = torch.tensor(1e30, dtype=torch.float32, device=z.device)

    def axis(v):
        d2 = ((v[..., None] - lv) ** 2)[..., None, :]
        return (torch.where(is1, d2, big).amin(-1)
                - torch.where(~is1, d2, big).amin(-1))
    llr = torch.cat([axis(z.real), axis(z.imag)], dim=-1)
    return llr.reshape(z.shape[:-1] + (-1,)).to(torch.float32)


# ── transmitter ──────────────────────────────────────────────────────────────


def _bits_of(data: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.asarray(data, np.uint8))


def _pad(bits: np.ndarray, n: int) -> np.ndarray:
    return np.concatenate([bits, np.zeros(n - bits.shape[-1], np.uint8)])


def header_fields(mcs, length, seq, flags, seed) -> bytes:
    return (bytes([mcs & 0xFF]) + int(length).to_bytes(4, "big")
            + int(seq).to_bytes(4, "big") + bytes([flags & 0xFF])
            + int(seed).to_bytes(4, "big"))


def _ofdm(link: Link, bits: torch.Tensor, constellation: str) -> torch.Tensor:
    """(B, L) coded bits → (B, n_sym·sps) IQ, bits zero-padded to whole
    symbols."""
    per = len(link.data_bins) * BPS[constellation]
    n_sym = -(-bits.shape[-1] // per)
    bits = torch.nn.functional.pad(bits, (0, n_sym * per - bits.shape[-1]))
    syms = map_bits(bits, constellation).reshape(bits.shape[0], n_sym, -1)
    grid = torch.zeros(syms.shape[:-1] + (link.n_fft,), dtype=torch.complex64,
                       device=bits.device)
    grid[..., torch.as_tensor(link.data_bins, device=bits.device)] = syms
    x = torch.fft.ifft(grid, dim=-1).to(torch.complex64)
    x = torch.cat([x[..., -link.cp_len:], x], dim=-1)
    return x.reshape(bits.shape[0], -1)


def transmit(link: Link, frames: list, device) -> list:
    """frames: [(seq, mcs, flags, payload uint8 array, seed)] → one
    complex64 body a frame (header block, then payload), on ``device``."""
    c = link.code
    out = [None] * len(frames)
    hdr = np.stack([_pad(_bits_of(np.frombuffer(
        (f := header_fields(m, len(p), s, fl, sd)) + crc16(f).to_bytes(
            2, "big"), np.uint8)), c.k) for s, m, fl, p, sd in frames])
    hdr = torch.as_tensor(hdr, device=device)
    hdr_iq = _ofdm(link, ldpc.encode(c, hdr), link.header_constellation)
    by_shape: dict = {}
    for i, (_, m, _, p, _) in enumerate(frames):
        by_shape.setdefault((m, len(p)), []).append(i)
    for (m, n), idx in by_shape.items():
        plan = link.plan(n)
        bch = link.bch
        framed = np.stack([np.concatenate([
            frames[i][3], np.frombuffer(crc32(frames[i][3].tobytes()).to_bytes(
                4, "big"), np.uint8)]) for i in idx])
        info = _bits_of(framed).reshape(len(idx), -1)
        nb = plan["outer"] // bch.n
        info = np.concatenate([info, np.zeros(
            (len(idx), nb * bch.k - info.shape[1]), np.uint8)], 1)
        outer = bch.encode(info.reshape(-1, bch.k)).reshape(len(idx), -1)
        nl = plan["coded"] // c.n
        outer = np.concatenate([outer, np.zeros(
            (len(idx), nl * c.k - outer.shape[1]), np.uint8)], 1)
        cw = ldpc.encode(c, torch.as_tensor(outer.reshape(-1, c.k),
                                            device=device))
        iq = _ofdm(link, cw.reshape(len(idx), -1), link.ladder[m])
        for j, i in enumerate(idx):
            out[i] = torch.cat([hdr_iq[i], iq[j]])
    return out


# ── receiver ─────────────────────────────────────────────────────────────────


@dataclass
class Group:
    key: tuple                  # (mcs, payload length)
    frames: list                # frame indices
    outer_msg: np.ndarray = None    # (nb, blocks·k_bch) BCH outputs
    outer_ok: np.ndarray = None     # (nb,) every block corrected
    bch_words: int = 0          # BCH words decoded
    bch_in_error: int = 0       # of them, words with a nonzero syndrome
    bch_fixed: int = 0          # of those, words the BCH corrected


@dataclass
class RxRecord:
    """What the receiver produced at each layer: each frame's header
    fields, each BP call's rows (the LLRs as handed to BP, the decisions,
    the unsatisfied checks; header first) and row-iterations, each (mcs,
    length) group's BCH outputs, each frame's result."""
    headers: list = field(default_factory=list)    # tuple or None a frame
    bp_llr: list = field(default_factory=list)
    bp_bits: list = field(default_factory=list)
    bp_unsat: list = field(default_factory=list)
    row_iters: list = field(default_factory=list)
    groups: list = field(default_factory=list)
    frames: list = field(default_factory=list)     # result a frame


@dataclass
class Layers:
    """A receiver's layer outputs whatever calls made them: each frame's
    header fields, every BP row (LLRs, decisions, unsatisfied checks) in
    any order, and every frame's BCH output row (message bits, flag) in
    any order."""
    headers: list
    llr: torch.Tensor           # (R, n)
    bits: torch.Tensor          # (R, k)
    unsat: torch.Tensor         # (R,)
    outer: list                 # [((blocks·k_bch,) uint8, bool)]


def layers(rec: RxRecord) -> Layers:
    return Layers(rec.headers, torch.cat(rec.bp_llr), torch.cat(rec.bp_bits),
                  torch.cat(rec.bp_unsat),
                  [(m, bool(ok)) for g in rec.groups if g.outer_msg is not None
                   for m, ok in zip(g.outer_msg, g.outer_ok)])


def demap(link: Link, iq: torch.Tensor, constellation: str, n_sym: int,
          rnd=_keep) -> torch.Tensor:
    x = iq[..., :n_sym * link.sps].reshape(iq.shape[:-1] + (n_sym, link.sps))
    freq = rnd(torch.fft.fft(x[..., link.cp_len:], dim=-1).to(
        torch.complex64))
    syms = freq[..., torch.as_tensor(link.data_bins, device=iq.device)]
    return rnd(soft_llr(syms.reshape(syms.shape[:-2] + (-1,)), constellation))


def _ldpc(link: Link, llr: torch.Tensor, rnd, rec: RxRecord):
    c = link.code
    nb = llr.shape[0]
    n_full = llr.shape[1] // c.n
    blocks = llr[:, :n_full * c.n].reshape(nb * n_full, c.n)
    rms = torch.sqrt(torch.mean(blocks ** 2, dim=-1, keepdim=True))
    blocks = rnd(blocks * (link.llr_rms / torch.clamp(rms, min=1e-9)))
    r = ldpc.bp_decode(c, blocks.contiguous(), link.ldpc_max_iter, rnd)
    rec.bp_llr.append(blocks)
    rec.bp_bits.append(r.bits)
    rec.bp_unsat.append(r.unsat)
    rec.row_iters.append(r.row_iters)
    ok = (n_full * c.n == llr.shape[1]) & (
        r.unsat.reshape(nb, n_full) == 0).all(1).cpu().numpy()
    return r, r.bits.reshape(nb, -1), ok


def parse_header(f: bytes):
    return (f[0], int.from_bytes(f[1:5], "big"), int.from_bytes(f[5:9], "big"),
            f[9], int.from_bytes(f[10:14], "big"))


def groups_of(headers: list, n_mcs: int) -> dict:
    """Frames with a valid header and a known MCS, grouped by (mcs, length)
    in order of first appearance."""
    out: dict = {}
    for b, h in enumerate(headers):
        if h is not None and h[0] < n_mcs:
            out.setdefault((h[0], h[1]), []).append(b)
    return out


def receive(link: Link, iq: torch.Tensor, rnd=None) -> RxRecord:
    """Decode aligned bodies (B, T) → RxRecord; its ``frames`` hold
    ("ok", seq, mcs, flags, payload bytes) or ("err", kind) a frame."""
    rnd = rnd or _keep
    rec = RxRecord()
    B = iq.shape[0]
    hbits = link.header_bits()
    n_h = link.n_sym(link.header_constellation, hbits)
    hllr = demap(link, iq, link.header_constellation, n_h, rnd)
    _, bits, inner_ok = _ldpc(link, hllr[:, :hbits], rnd, rec)
    nbytes = link.header_bytes + 2
    hb = np.packbits(bits[:, :nbytes * 8].cpu().numpy(), axis=1)
    frames = [None] * B
    for b in range(B):
        f = bytes(hb[b, :link.header_bytes])
        ok = inner_ok[b] and crc16(f) == int.from_bytes(
            bytes(hb[b, link.header_bytes:nbytes]), "big")
        rec.headers.append(parse_header(f) if ok else None)
        if not ok:
            frames[b] = ("err", HEADER_ERR)
        elif rec.headers[b][0] >= len(link.ladder):
            frames[b] = ("err", MALFORMED)
    cursor = n_h * link.sps
    for (mcs, n), idx in groups_of(rec.headers, len(link.ladder)).items():
        g = Group((mcs, n), idx)
        rec.groups.append(g)
        plan = link.plan(n)
        const = link.ladder[mcs]
        n_sym = link.n_sym(const, plan["coded"])
        rows = iq[torch.as_tensor(idx, device=iq.device), cursor:]
        if rows.shape[1] < n_sym * link.sps:
            for b in idx:
                frames[b] = ("err", MALFORMED)
            continue
        llr = demap(link, rows, const, n_sym, rnd)
        _, bits, inner_ok = _ldpc(link, llr[:, :plan["coded"]], rnd, rec)
        bch = link.bch
        words = bits[:, :plan["outer"]].cpu().numpy()
        nbw = plan["outer"] // bch.n
        msg, ok, in_error = bch.decode_counted(words.reshape(-1, bch.n))
        g.bch_words = int(ok.size)
        g.bch_in_error = int(in_error.sum())
        g.bch_fixed = int((in_error & ok).sum())
        g.outer_msg = msg.reshape(len(idx), -1)
        g.outer_ok = ok.reshape(len(idx), nbw).all(1)
        framed = np.packbits(g.outer_msg[:, :plan["framed"] * 8], axis=1)
        for j, b in enumerate(idx):
            body, tail = framed[j, :-4], framed[j, -4:]
            good = (crc32(body.tobytes()) == int.from_bytes(bytes(tail), "big")
                    and inner_ok[j] and g.outer_ok[j])
            h = rec.headers[b]
            frames[b] = (("ok", h[2], h[0], h[3], bytes(body[:n])) if good
                         else ("err", CRC_ERR))
    rec.frames = frames
    return rec
