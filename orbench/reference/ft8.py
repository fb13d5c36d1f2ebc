"""The benchmark's plain FT8: standard-message packing, CRC-14,
LDPC(174, 91), Gray-coded 8-FSK transmitter and a batch receiver for
frames at the start of 15 s windows, in plain torch and numpy, written
from the public protocol (Franke, Somerville, Taylor, QEX 2020; WSJT-X /
ft8_lib tables).

Receiver: a symbol-rate log-power waterfall (each symbol's 1920 samples
against the tone phasors, one matrix product a window block), the Costas
difference metric and its shifted sum over every frequency start, the k
best starts (ties: the lower index), max-log LLRs from Gray-reordered tone
log-powers normalised to variance 24, sum-product BP (20 iterations), the
CRC; each window keeps its first candidate, in rank order, that decodes to
a CRC-valid non-zero payload. ``tf32`` computes the waterfall's products
in TF32 for the control; otherwise float32 with TF32 off.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import ldpc

FS = 12000.0
SPACING = 6.25
SPS = 1920
N_SYMS = 79
N_TONES = 8
COSTAS = (3, 1, 4, 0, 6, 5, 2)
SYNC_START = (0, 36, 72)
GRAY = (0, 1, 3, 2, 5, 6, 4, 7)            # 3-bit value → tone
CRC_POLY = 0x2757
MAX_ITER = 20
BLOCK = 64                # windows a waterfall product

NTOKENS = 2_063_592
MAX22 = 1 << 22
MAXGRID4 = 32_400
_A37 = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A36 = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A27 = " ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_A10 = "0123456789"


def data_positions() -> np.ndarray:
    sync = np.zeros(N_SYMS, bool)
    for s in SYNC_START:
        sync[s:s + 7] = True
    return np.flatnonzero(~sync)


# ── messages (i3 = 1 standard messages) ──────────────────────────────────────


def _basecall(call: str):
    if len(call) <= 2:
        return None
    if call[2:3].isdigit() and len(call) <= 6:
        c6 = call.ljust(6)
    elif call[1:2].isdigit() and len(call) <= 5:
        c6 = (" " + call).ljust(6)
    else:
        return None
    v = 0
    for ch, alpha in zip(c6, (_A37, _A36, _A10, _A27, _A27, _A27)):
        if ch not in alpha:
            return None
        v = v * len(alpha) + alpha.index(ch)
    return v


def pack28(call: str) -> int:
    tokens = {"DE": 0, "QRZ": 1, "CQ": 2}
    if call in tokens:
        return tokens[call]
    v = _basecall(call)
    if v is None:
        raise ValueError(f"not a standard call: {call!r}")
    return NTOKENS + MAX22 + v


def unpack28(n28: int) -> str:
    if n28 < NTOKENS:
        if n28 <= 2:
            return ("DE", "QRZ", "CQ")[n28]
        if n28 <= 1002:
            return f"CQ {n28 - 3:03d}"
        if n28 <= 532_443:
            n, s = n28 - 1003, ""
            for _ in range(4):
                s = _A27[n % 27] + s
                n //= 27
            return "CQ " + s.strip(" ")
        return None
    n28 -= NTOKENS
    if n28 < MAX22:
        return "<...>"
    n = n28 - MAX22
    chars = []
    for alpha in (_A27, _A27, _A27, _A10, _A36, _A37):
        chars.append(alpha[n % len(alpha)])
        n //= len(alpha)
    s = "".join(reversed(chars)).strip(" ")
    return s if len(s) >= 3 else None


def pack_grid(extra: str):
    """(15-bit field, ir flag)."""
    tokens = {"": 1, "RRR": 2, "RR73": 3, "73": 4}
    if extra in tokens:
        return MAXGRID4 + tokens[extra], 0
    if len(extra) == 4 and extra[:2].isalpha():
        return ((ord(extra[0]) - 65) * 1800 + (ord(extra[1]) - 65) * 100
                + int(extra[2:4])), 0
    ir = extra.startswith("R")
    return MAXGRID4 + 35 + int(extra[1:] if ir else extra), int(ir)


def unpack_grid(g: int, ir: int) -> str:
    if g <= MAXGRID4:
        grid = f"{chr(65 + g // 1800)}{chr(65 + g // 100 % 18)}{g % 100:02d}"
        return f"R {grid}" if ir else grid
    r = g - MAXGRID4
    if r <= 4:
        return ("", "", "RRR", "RR73", "73")[r]
    return f"R{r - 35:+03d}" if ir else f"{r - 35:+03d}"


def pack77(call_to: str, call_de: str, extra: str) -> np.ndarray:
    """A standard message (i3 = 1) → 10 payload bytes (77 bits, MSB
    first)."""
    g, ir = pack_grid(extra)
    v = ((pack28(call_to) << 1) << 48) | ((pack28(call_de) << 1) << 19) \
        | (ir << 18) | (g << 3) | 1
    return np.frombuffer((v << 3).to_bytes(10, "big"), np.uint8).copy()


def text77(payload) -> str:
    """The text of a standard message (i3 = 1, 2); any other type reads
    "<other>"."""
    p = bytes(np.asarray(payload, np.uint8))
    v = int.from_bytes(p, "big") >> 3
    i3 = v & 7
    if i3 not in (1, 2):
        return "<other>"
    a, b = (v >> 48) & ((1 << 29) - 1), (v >> 19) & ((1 << 29) - 1)
    calls = []
    for n29 in (a, b):
        c = unpack28(n29 >> 1)
        if c is None:
            c = "<?>"
        elif n29 & 1 and not c.startswith("<") and n29 >> 1 >= NTOKENS:
            c += "/R" if i3 == 1 else "/P"
        calls.append(c)
    extra = unpack_grid((v >> 3) & 0x7FFF, (v >> 18) & 1)
    return " ".join(s for s in (calls[0], calls[1], extra) if s)


# ── CRC-14 and the codeword ──────────────────────────────────────────────────


def crc14(a: np.ndarray, n_bits: int) -> int:
    rem, byte = 0, 0
    for i in range(n_bits):
        if i % 8 == 0:
            rem ^= int(a[byte]) << 6
            byte += 1
        rem = ((rem << 1) ^ CRC_POLY) & 0x3FFF if rem & 0x2000 else \
            (rem << 1) & 0x3FFF
    return rem


def a91(payload: np.ndarray) -> np.ndarray:
    """Payload (10 bytes) → the 91 message bits: 77 payload bits and the
    CRC-14 of the payload zero-extended to 82 bits."""
    a = np.zeros(12, np.uint8)
    a[:10] = payload
    a[9] &= 0xF8
    c = crc14(a, 82)
    bits = np.unpackbits(a)[:77]
    return np.concatenate([bits, (c >> np.arange(13, -1, -1)) & 1]).astype(
        np.uint8)


def crc_matrix() -> np.ndarray:
    """(91, 14) H: a row of bits passes the CRC iff bits @ H = 0 mod 2."""
    h = np.zeros((91, 14), np.uint8)
    for i in range(77):
        a = np.zeros(12, np.uint8)
        a[i // 8] = 0x80 >> (i % 8)
        c = crc14(a, 82)
        h[i] = (c >> np.arange(13, -1, -1)) & 1
    h[77:] = np.eye(14, dtype=np.uint8)
    return h


def tones(payload: np.ndarray) -> np.ndarray:
    """Payload → the 79 tones of a frame (Costas blocks and 58 data
    tones)."""
    cw = ldpc.encode(ldpc.ft8_code(), torch.as_tensor(a91(payload)[None]))[0]
    v = cw.numpy().reshape(58, 3) @ np.array([4, 2, 1])
    seq = np.zeros(N_SYMS, np.int64)
    for s in SYNC_START:
        seq[s:s + 7] = COSTAS
    seq[data_positions()] = np.asarray(GRAY)[v]
    return seq


# ── transmitter ──────────────────────────────────────────────────────────────


def modulate(seqs: torch.Tensor, carriers: torch.Tensor) -> torch.Tensor:
    """(F, 79) tones and (F,) carriers in Hz → (F, 79·1920) complex64
    continuous-phase frames of unit power, the phase in float64."""
    f = carriers[:, None].to(torch.float64) + seqs.to(torch.float64) * SPACING
    step = 2.0 * np.pi * f / FS                            # rad a sample
    start = torch.cumsum(step * SPS, dim=1) - step * SPS
    n = torch.arange(1, SPS + 1, dtype=torch.float64, device=seqs.device)
    phase = torch.remainder(start, 2 * np.pi)[..., None] + step[..., None] * n
    return torch.polar(torch.ones_like(phase), phase).reshape(
        seqs.shape[0], -1).to(torch.complex64)


# ── receiver ─────────────────────────────────────────────────────────────────


@dataclass
class RxRecord:
    scores: torch.Tensor = None   # (W, k) candidate scores, best first
    bins: torch.Tensor = None     # (W, k) their frequency bins
    llr: torch.Tensor = None      # (W·k, 174) window-major
    bits: torch.Tensor = None     # (W·k, 91) BP decisions
    ok: torch.Tensor = None       # (W·k,) decoded, CRC-valid, non-zero
    row_iters: int = 0
    results: list = field(default_factory=list)   # per window


def waterfall(x: torch.Tensor, base_hz: float, n_bins: int, tf32: bool
              ) -> torch.Tensor:
    """(W, ≥ 79·1920) IQ → (W, 79, n_bins) float32 log-power, the products
    as real matrix products."""
    i = np.arange(SPS, dtype=np.float64)[:, None]
    f = base_hz + np.arange(n_bins, dtype=np.float64)[None, :] * SPACING
    w = np.exp(-2j * np.pi * f * i / FS).astype(np.complex64)
    wr = torch.as_tensor(w.real.copy(), device=x.device)
    wi = torch.as_tensor(w.imag.copy(), device=x.device)
    seg = x[:, :N_SYMS * SPS].reshape(x.shape[0], N_SYMS, SPS)
    xr, xi = seg.real.contiguous(), seg.imag.contiguous()
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        re = xr @ wr - xi @ wi
        im = xr @ wi + xi @ wr
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    return torch.log(re * re + im * im + 1e-12).to(torch.float32)


def score_grid(wf: torch.Tensor) -> torch.Tensor:
    """(W, S, B) → (W, B - 7) Costas scores of frames starting at symbol 0."""
    W, S, B = wf.shape
    ninf = torch.full((W, 1, B), -torch.inf, device=wf.device)
    ninf_c = torch.full((W, S, 1), -torch.inf, device=wf.device)
    up = torch.cat([ninf, wf[:, :-1]], 1)
    down = torch.cat([wf[:, 1:], ninf], 1)
    left = torch.cat([ninf_c, wf[..., :-1]], 2)
    right = torch.cat([wf[..., 1:], ninf_c], 2)
    cell = torch.clamp(wf - torch.maximum(torch.maximum(up, down),
                                          torch.maximum(left, right)), min=0)
    f_count = B - N_TONES + 1
    score = torch.zeros((W, f_count), device=wf.device)
    for s in SYNC_START:
        for ci, tone in enumerate(COSTAS):
            score = score + cell[:, s + ci, tone:tone + f_count]
    return score


def llrs(wf: torch.Tensor, win: torch.Tensor, fbin: torch.Tensor
         ) -> torch.Tensor:
    """Normalised max-log LLRs (R, 174) of frames at symbol 0 and bins
    ``fbin`` of waterfalls ``win``."""
    dp = torch.as_tensor(data_positions(), device=wf.device)
    g = torch.as_tensor(GRAY, device=wf.device)
    e = wf[win[:, None, None], dp[None, :, None], (fbin[:, None] + g)[:, None]]
    vals = np.arange(8)
    out = []
    for b in range(3):
        bit = (vals >> (2 - b)) & 1
        hi = e[..., torch.as_tensor(vals[bit == 1], device=wf.device)].amax(-1)
        lo = e[..., torch.as_tensor(vals[bit == 0], device=wf.device)].amax(-1)
        out.append(-(hi - lo))
    llr = torch.stack(out, -1).reshape(len(win), -1).to(torch.float64)
    var = (llr * llr).mean(-1, keepdim=True)
    scale = torch.where(var > 1e-10, torch.sqrt(24.0 / var), 1.0)
    return (llr * scale).to(torch.float32)


def receive(x: torch.Tensor, base_hz: float, max_hz: float, max_cand: int,
            tf32: bool = False) -> RxRecord:
    """Decode (W, n) windows → RxRecord; ``results`` hold None or
    (bin, payload bytes, text, carrier Hz, score) a window."""
    rec = RxRecord()
    n_bins = int(np.ceil((max_hz + SPACING - base_hz) / SPACING)) \
        + N_TONES + 1
    k = min(max_cand, n_bins - N_TONES + 1)
    scores, bins, rows = [], [], []
    for w0 in range(0, x.shape[0], BLOCK):
        wf = waterfall(x[w0:w0 + BLOCK], base_hz, n_bins, tf32)
        vals, idx = torch.sort(score_grid(wf), dim=-1, descending=True,
                               stable=True)
        vals, idx = vals[:, :k], idx[:, :k]
        win = torch.arange(wf.shape[0], device=x.device).repeat_interleave(k)
        rows.append(llrs(wf, win, idx.reshape(-1)))
        scores.append(vals)
        bins.append(idx)
    rec.scores, rec.bins = torch.cat(scores), torch.cat(bins)
    rec.llr = torch.cat(rows)
    r = ldpc.bp_decode(ldpc.ft8_code(), rec.llr.contiguous(), MAX_ITER)
    rec.bits, rec.row_iters = r.bits, r.row_iters
    h = torch.as_tensor(crc_matrix(), dtype=torch.float64, device=x.device)
    crc_ok = ~(((r.bits.to(torch.float64) @ h).to(torch.int64) & 1).bool()
               .any(-1))
    rec.ok = (r.unsat == 0) & crc_ok & r.bits[:, :80].bool().any(-1)
    ok = rec.ok.reshape(-1, k).cpu().numpy()
    bits = r.bits.cpu().numpy()
    sc, bn = rec.scores.cpu().numpy(), rec.bins.cpu().numpy()
    for w in range(ok.shape[0]):
        hit = np.flatnonzero(ok[w])
        if not hit.size:
            rec.results.append(None)
            continue
        c = hit[0]
        payload = np.packbits(np.concatenate([bits[w * k + c],
                                              np.zeros(5, np.uint8)]))[:10]
        payload[9] &= 0xF8
        rec.results.append((int(bn[w, c]), bytes(payload), text77(payload),
                            base_hz + int(bn[w, c]) * SPACING,
                            float(sc[w, c])))
    return rec
