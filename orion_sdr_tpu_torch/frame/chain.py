"""Shared TX/RX coding chain + BlockPlan (counterpart of
``orion_sdr_tpu/frame/chain.py``).

The byte-domain stages (CRC, byte scramblers, the outer interleavers) run
on the host in numpy; the inner code (LDPC or convolutional), the inner
block interleaver, the bit-domain scrambler and the LLR normalisation run on
the device of the tensors they are given. The BCH and RS outer codes run on
a CUDA device when a call holds enough codewords (``_outer_device_ok``:
the products mod 2 of ``fec/bch_device.py`` and the kernel of
``ops/outer_fec.py``), else on the host through the native coders; both
give the same bits. FEC blocks and frames are stacked on a leading axis, so
each LDPC, Viterbi or outer-code stage is one batched call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..fec.bch_device import (MAX_DEVICE_T, bch_decode_batch_device,
                              bch_encode_batch_device, bits_from_bytes,
                              bytes_from_bits, rs_decode_batch_device,
                              rs_encode_batch_device)
from ..fec.conv import (conv_encode_punctured, punctured_coded_len,
                        viterbi_decode_soft, viterbi_decode_soft_chunked)
from ..fec.crc import crc16, crc32
from ..fec.galois import Bch, ReedSolomon
from ..fec.interleave import (block_deinterleave, block_interleave,
                              conv_roundtrip_delay, forney_deinterleave,
                              forney_flush, forney_interleave)
from ..fec.ldpc import ldpc_decode, ldpc_encode, ldpc_graph
from ..fec.scrambler import pn_sequence
from ..waveform.dvb_t import energy_disperse
from .types import (InnerFec, InterleaverKind, OuterFec, RxError,
                    ScramblerKind, SCRAMBLER_AFTER_INNER,
                    SCRAMBLER_BEFORE_OUTER, crc_len_bytes)

# Fixed info-bit block for the outer BCH (one shortened codeword per block).
BCH_INFO_BITS = 120
# a terminated conv trellis up to this many info bits decodes whole; a longer
# one goes to the overlap-chunked decode
CONV_TERMINATED_MAX_INFO = 4096

_BCH_CACHE: dict = {}
_RS_CACHE: dict = {}


def shortened_bch_for(t: int, msg_bits: int = BCH_INFO_BITS) -> Bch:
    """BCH correcting t errors, shortened to exactly msg_bits info bits."""
    key = (t, msg_bits)
    if key not in _BCH_CACHE:
        _BCH_CACHE[key] = Bch(t, n=msg_bits + Bch(t).parity_bits)
    return _BCH_CACHE[key]


def rs_for(n: int, n_parity: int) -> ReedSolomon:
    key = (n, n_parity)
    if key not in _RS_CACHE:
        _RS_CACHE[key] = ReedSolomon(n, n_parity)
    return _RS_CACHE[key]


def _round_up(n: int, block: int) -> int:
    return n if block == 0 else -(-n // block) * block


# ── bit/byte helpers ─────────────────────────────────────────────────────────


def bytes_to_bits(b) -> np.ndarray:
    return np.unpackbits(np.asarray(b, np.uint8))


def bits_to_bytes(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


# ── CRC ──────────────────────────────────────────────────────────────────────


def append_crc(crc: str, data) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    if crc == "none":
        return data.copy()
    if crc == "crc16":
        v = crc16(data)
        return np.concatenate([data, np.array([v >> 8, v & 0xFF], np.uint8)])
    return np.concatenate([data, np.frombuffer(
        int(crc32(data)).to_bytes(4, "big"), np.uint8)])


def check_and_strip_crc(crc: str, framed):
    """Returns (bytes, crc_ok) or None if too short."""
    framed = np.asarray(framed, np.uint8)
    n = crc_len_bytes(crc)
    if len(framed) < n:
        return None
    if n == 0:
        return framed.copy(), True
    body, tail = framed[:-n], framed[-n:]
    if crc == "crc16":
        return body.copy(), crc16(body) == ((int(tail[0]) << 8) | int(tail[1]))
    return body.copy(), crc32(body) == int.from_bytes(bytes(tail), "big")


# ── scramblers ───────────────────────────────────────────────────────────────


def scramble_bytes(kind: ScramblerKind, per_frame_seed: int, data) -> np.ndarray:
    """Byte-domain whitener (self-inverse)."""
    data = np.asarray(data, np.uint8)
    if kind.kind == "none":
        return data.copy()
    if kind.kind == "dvb":
        return energy_disperse(data)
    raw = per_frame_seed if kind.seed_mode == "per_frame" else kind.seed
    # reduce into the register width; avoid the all-zero fixed point
    seed = raw & ((1 << kind.width) - 1) or 1
    return data ^ pn_sequence(kind.poly, kind.width, seed, len(data))


def _pn_bits(kind: ScramblerKind, per_frame_seed: int, n_bits: int) -> np.ndarray:
    zero = np.zeros(-(-n_bits // 8), np.uint8)
    return np.unpackbits(scramble_bytes(kind, per_frame_seed, zero))[:n_bits]


def scramble_bits(kind: ScramblerKind, per_frame_seed: int,
                  bits: torch.Tensor) -> torch.Tensor:
    """Bit-domain position: XOR the PN bit stream over a 1-D bit tensor."""
    pn = _pn_bits(kind, per_frame_seed, bits.shape[-1])
    return bits ^ torch.as_tensor(pn, device=bits.device)


def apply_pn_to_llrs(kind: ScramblerKind, per_frame_seeds,
                     llrs: torch.Tensor) -> torch.Tensor:
    """Descramble (B, L) LLRs in the LLR domain: negate where the row's PN
    bit is 1 (one seed per row)."""
    pn = np.stack([_pn_bits(kind, int(s), llrs.shape[-1])
                   for s in per_frame_seeds])
    flip = torch.as_tensor(pn, device=llrs.device) != 0
    return torch.where(flip, -llrs, llrs)


# ── interleavers ─────────────────────────────────────────────────────────────


def _conv_il_bits(n_bits: int, branches: int, depth: int) -> int:
    byts = _round_up(-(-n_bits // 8), branches) + \
        conv_roundtrip_delay(branches, depth)
    return byts * 8


def _block_apply(x, rows: int, cols: int, inverse: bool):
    """Block (de)interleave whole blocks along the last axis of a numpy
    array or a tensor (on its device)."""
    if isinstance(x, np.ndarray):
        blocks = x.reshape(x.shape[:-1] + (-1, rows * cols))
        f = block_deinterleave if inverse else block_interleave
        return f(blocks, rows, cols).reshape(x.shape)
    m = x.reshape(x.shape[:-1] + (-1,) + ((cols, rows) if inverse
                                          else (rows, cols)))
    return m.transpose(-1, -2).reshape(x.shape)


def interleave_bits(il: InterleaverKind, bits):
    """1-D bits (numpy, or a tensor kept on its device) → interleaved bits
    of the same kind: a block interleaver zero-pads to whole blocks; a
    Forney one byte-packs, aligns to its branches and feeds and flushes one
    stream (on the host)."""
    is_tensor = isinstance(bits, torch.Tensor)
    if il.kind == "none":
        return bits.clone() if is_tensor else np.array(bits, np.uint8)
    if il.kind == "block":
        n = _round_up(bits.shape[-1], il.rows * il.cols)
        if is_tensor:
            padded = torch.nn.functional.pad(bits.to(torch.uint8),
                                             (0, n - bits.shape[-1]))
        else:
            padded = np.concatenate([np.asarray(bits, np.uint8), np.zeros(
                n - len(bits), np.uint8)])
        return _block_apply(padded, il.rows, il.cols, inverse=False)
    host = bits.cpu().numpy() if is_tensor else np.asarray(bits, np.uint8)
    byts = np.packbits(host.astype(np.uint8))
    n = _round_up(len(byts), il.branches)
    padded = np.concatenate([byts, np.zeros(n - len(byts), np.uint8)])
    body, state = forney_interleave(padded, il.branches, il.depth)
    tail, _ = forney_flush(il.branches, il.depth, state)
    out = np.unpackbits(np.concatenate([body, tail]))
    return torch.as_tensor(out, device=bits.device) if is_tensor else out


def _deinterleave(il: InterleaverKind, x, is_llr: bool):
    """Inverse along the last axis; each row of a 2-D input is its own
    frame (a Forney deinterleaver starts every row from an empty state)."""
    if il.kind == "none":
        return x.clone() if isinstance(x, torch.Tensor) else np.array(x)
    if il.kind == "block":
        block = il.rows * il.cols
        n_full = (x.shape[-1] // block) * block
        out = _block_apply(x[..., :n_full], il.rows, il.cols, inverse=True)
        if isinstance(x, torch.Tensor):
            return torch.cat([out, x[..., n_full:]], dim=-1)
        return np.concatenate([out, x[..., n_full:]], axis=-1)
    if is_llr:
        # a Forney interleaver is never configured as the inner (LLR)
        # interleaver; degrade gracefully, as the reference does
        return x.clone() if isinstance(x, torch.Tensor) else np.array(x)
    x = np.asarray(x, np.uint8)
    d = conv_roundtrip_delay(il.branches, il.depth)
    total = x.shape[-1] // 8
    if total <= d:
        return np.zeros(x.shape[:-1] + (0,), np.uint8)
    n_padded = total - d
    byts = np.packbits(x[..., : total * 8], axis=-1)
    out, _ = forney_deinterleave(byts, il.branches, il.depth)
    return np.unpackbits(out[..., d:d + n_padded], axis=-1)


def deinterleave_bits(il: InterleaverKind, bits) -> np.ndarray:
    """(..., L) numpy bits → deinterleaved bits, one frame per row."""
    return _deinterleave(il, np.asarray(bits, np.uint8), is_llr=False)


def deinterleave_llrs(il: InterleaverKind, llrs):
    """(..., L) LLRs (a tensor stays on its device) → deinterleaved."""
    if not isinstance(llrs, torch.Tensor):
        llrs = np.asarray(llrs, np.float32)
    return _deinterleave(il, llrs, is_llr=True)


# ── BlockPlan ────────────────────────────────────────────────────────────────


@dataclass(frozen=True)
class BlockPlan:
    """Deterministic TX/RX-shared length accounting."""
    info_bytes: int
    framed_bytes: int
    outer_coded_bits: int
    outer_il_bits: int
    inner_coded_bits: int
    coded_bits: int


def block_plan(info_bytes: int, crc: str, outer: OuterFec, inner: InnerFec,
               outer_il: InterleaverKind, inner_il: InterleaverKind
               ) -> BlockPlan:
    framed_bytes = info_bytes + crc_len_bytes(crc)
    framed_bits = framed_bytes * 8
    if outer.kind == "none":
        outer_coded_bits = framed_bits
    elif outer.kind == "bch":
        outer_coded_bits = -(-framed_bits // BCH_INFO_BITS) * \
            shortened_bch_for(outer.t).n
    else:
        rs = rs_for(outer.n, outer.n_parity)
        outer_coded_bits = -(-framed_bytes // rs.k) * rs.n * 8

    def il_bits(il: InterleaverKind, n: int) -> int:
        if il.kind == "none":
            return n
        if il.kind == "block":
            return _round_up(n, il.rows * il.cols)
        return _conv_il_bits(n, il.branches, il.depth)

    outer_il_bits = il_bits(outer_il, outer_coded_bits)
    if inner.kind == "none":
        inner_coded_bits = outer_il_bits
    elif inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        inner_coded_bits = -(-outer_il_bits // g.k) * g.n
    else:
        inner_coded_bits = punctured_coded_len(outer_il_bits, inner.rate,
                                               inner.code)
    return BlockPlan(info_bytes, framed_bytes, outer_coded_bits,
                     outer_il_bits, inner_coded_bits,
                     il_bits(inner_il, inner_coded_bits))


# ── encode side ──────────────────────────────────────────────────────────────


# At or above this many codewords in one call, on a CUDA device, the outer
# code runs on the card; below it the native host coder runs (the outputs
# are the same bits either way). Set from chip_smoke.py's sweep [18] of the
# chain's outer decode on an NVIDIA H100 80GB HBM3 at its 700 W power
# limit: from 64 codewords up the card path was faster in every run (RS
# 3-7x, BCH 6-21x at 1 632-12 928 codewords); below 64 the two paths
# differed by at most 0.15 ms and changed order from run to run, so the
# threshold stays low: the receive paths' decodes of more than a few
# codewords (27 and up in chip_smoke.py) go to the card.
_DEVICE_OUTER_MIN_BLOCKS = 4


def _outer_device(coded, device) -> torch.device:
    """The device an outer coder's call asks for: ``device`` when given, else
    a tensor's own device, else the card ("cuda"), the rule of
    ``dsp/device.py::on_device``; ``device="cpu"`` asks for the native host
    coder."""
    if device is not None:
        return torch.device(device)
    return coded.device if isinstance(coded, torch.Tensor) else \
        torch.device("cuda")


def _outer_device_ok(t: int, n_blocks: int, device) -> bool:
    """Whether ``n_blocks`` codewords of a t-error outer code go to the
    device coders: t <= MAX_DEVICE_T, enough codewords, and a CUDA
    ``device``."""
    return (t <= MAX_DEVICE_T and n_blocks >= _DEVICE_OUTER_MIN_BLOCKS
            and device is not None and torch.device(device).type == "cuda")


def outer_encode(outer: OuterFec, message_bytes, device=None):
    """Bytes → outer-coded bits: BCH in 120-bit blocks, RS in k-byte
    blocks, each zero-padded to whole blocks, coded on the card when
    :func:`_outer_device_ok` says so for :func:`_outer_device`'s device
    (with no ``device``: a tensor's own, host data the card's), else by the
    native host coder. Numpy bits when ``device`` is None (the JAX
    package's signature and return); else a uint8 tensor on ``device``."""
    dev = _outer_device(message_bytes, device)
    if isinstance(message_bytes, torch.Tensor):
        message_bytes = message_bytes.cpu().numpy()
    message_bytes = np.asarray(message_bytes, np.uint8)

    def out(bits):
        if device is None:
            return bits.cpu().numpy() if isinstance(bits, torch.Tensor) \
                else bits
        return torch.as_tensor(bits, device=device)
    if outer.kind == "none":
        return out(bytes_to_bits(message_bytes))
    if outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        bits = bytes_to_bits(message_bytes)
        n_blk = -(-len(bits) // BCH_INFO_BITS)
        blocks = np.concatenate([bits, np.zeros(
            n_blk * BCH_INFO_BITS - len(bits), np.uint8)]).reshape(
                n_blk, BCH_INFO_BITS)
        if _outer_device_ok(outer.t, n_blk, dev):
            return out(bch_encode_batch_device(
                code.n, code.k, code.t,
                torch.as_tensor(blocks, device=dev)).reshape(-1))
        return out(code.encode(blocks).reshape(-1))
    rs = rs_for(outer.n, outer.n_parity)
    n_blk = -(-len(message_bytes) // rs.k)
    blocks = np.concatenate([message_bytes, np.zeros(
        n_blk * rs.k - len(message_bytes), np.uint8)]).reshape(n_blk, rs.k)
    if _outer_device_ok(outer.n_parity // 2, n_blk, dev):
        return out(bits_from_bytes(rs_encode_batch_device(
            rs.n, rs.n_parity, torch.as_tensor(blocks, device=dev))
        ).reshape(-1))
    return out(bytes_to_bits(rs.encode(blocks).reshape(-1)))


def inner_encode(inner: InnerFec, info_bits: torch.Tensor) -> torch.Tensor:
    """1-D bit tensor → inner-coded bits on the same device: LDPC blocks
    zero-padded to whole codewords and encoded in one batch, or the
    zero-tailed punctured convolutional code."""
    info_bits = info_bits.to(torch.uint8)
    if inner.kind == "none":
        return info_bits.clone()
    if inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        n_blk = -(-info_bits.shape[-1] // g.k)
        padded = torch.nn.functional.pad(info_bits, (0, n_blk * g.k
                                                     - info_bits.shape[-1]))
        return ldpc_encode(inner.code, padded.reshape(n_blk, g.k)).reshape(-1)
    return conv_encode_punctured(info_bits, inner.rate, inner.code)


def encode_chain(data_bytes, crc: str, outer: OuterFec, inner: InnerFec,
                 outer_il: InterleaverKind, inner_il: InterleaverKind,
                 scrambler: ScramblerKind, scrambler_pos: str,
                 per_frame_seed: int, *, device) -> torch.Tensor:
    """bytes → CRC → [scramble] → outer → outer-IL → inner → inner-IL →
    [scramble]; returns the coded bits (uint8) on ``device``, ready to map."""
    framed = append_crc(crc, data_bytes)
    if scrambler_pos == SCRAMBLER_BEFORE_OUTER:
        framed = scramble_bytes(scrambler, per_frame_seed, framed)
    outer_bits = interleave_bits(outer_il, outer_encode(outer, framed,
                                                        device=device))
    coded = interleave_bits(inner_il, inner_encode(
        inner, torch.as_tensor(outer_bits, device=device)))
    if scrambler_pos == SCRAMBLER_AFTER_INNER and scrambler.kind != "none":
        coded = scramble_bits(scrambler, per_frame_seed, coded)
    return coded


# ── decode side ──────────────────────────────────────────────────────────────


def inner_decode_batch(inner: InnerFec, coded_llrs: torch.Tensor,
                       info_len: int, ldpc_rule: str = "sum_product"):
    """(B, L) LLR tensor → ((B, info) bit tensor, (B,) numpy ok): all
    frames' FEC blocks decode in one launch. LDPC: each block's LLRs are
    scaled to RMS 4 first (the max-log demapper's outputs are not scaled by
    1/σ², and sum-product stalls on magnitudes ≪ 1; hard decisions are
    unaffected). Convolutional: a trellis of at most
    ``CONV_TERMINATED_MAX_INFO`` info bits decodes whole and terminated, a
    longer one overlap-chunked."""
    nb = coded_llrs.shape[0]
    if inner.kind == "none":
        return (coded_llrs <= 0.0).to(torch.uint8), np.ones(nb, bool)
    if inner.kind == "conv":
        llrs = coded_llrs.to(torch.float32).contiguous()
        if info_len > CONV_TERMINATED_MAX_INFO:
            bits = viterbi_decode_soft_chunked(llrs, info_len, inner.rate,
                                               inner.code)
        else:
            bits = viterbi_decode_soft(llrs, info_len, inner.rate,
                                       inner.code)
        return bits, np.ones(nb, bool)
    g = ldpc_graph(inner.code)
    n_full = coded_llrs.shape[1] // g.n
    blocks = coded_llrs[:, : n_full * g.n].reshape(nb * n_full, g.n)
    rms = torch.sqrt(torch.mean(blocks ** 2, dim=-1, keepdim=True))
    blocks = (blocks * (4.0 / torch.clamp(rms, min=1e-9))).contiguous()
    msg, unsat = ldpc_decode(inner.code, blocks, 50, ldpc_rule)
    ok = (n_full * g.n == coded_llrs.shape[1]) & \
        (unsat.reshape(nb, n_full) == 0).all(dim=1).cpu().numpy()
    return msg.reshape(nb, -1), ok


def outer_decode_batch(outer: OuterFec, coded_bits, device=None):
    """(B, L) bits (numpy, or a uint8 tensor) → ((B, msg) numpy bits, (B,)
    ok): every frame's BCH or RS codewords decode in one batch, on
    :func:`_outer_device`'s device (with no ``device``: a tensor's own, host
    data the card's) when :func:`_outer_device_ok` says so, else through
    the native host decoder (``device="cpu"`` asks for it). A failed
    codeword keeps its systematic prefix, so the CRC still adjudicates."""
    device = _outer_device(coded_bits, device)
    if not isinstance(coded_bits, torch.Tensor):
        coded_bits = np.asarray(coded_bits, np.uint8)
    nb, nbits = coded_bits.shape

    def host(x):
        return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

    def on_device(x):
        return torch.as_tensor(x, device=device).to(torch.uint8).contiguous()
    if outer.kind == "none":
        return np.array(host(coded_bits), np.uint8), np.ones(nb, bool)
    if outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        n_full = nbits // code.n
        if n_full == 0:
            return np.zeros((nb, 0), np.uint8), np.zeros(nb, bool)
        blocks = coded_bits[:, : n_full * code.n].reshape(nb * n_full, code.n)
        if _outer_device_ok(outer.t, nb * n_full, device):
            msg, ok = bch_decode_batch_device(code.n, code.k, code.t,
                                              on_device(blocks))
            msg, ok = msg.cpu().numpy(), ok.cpu().numpy().astype(bool)
        else:
            msg, ok = code.decode_batch(host(blocks))
        ok = ok.reshape(nb, n_full).all(axis=1) & (nbits % code.n == 0)
        return msg.reshape(nb, -1), ok
    rs = rs_for(outer.n, outer.n_parity)
    n_bytes = -(-nbits // 8)
    n_full = n_bytes // rs.n
    if n_full == 0:
        return np.zeros((nb, 0), np.uint8), np.zeros(nb, bool)
    card = _outer_device_ok(outer.n_parity // 2, nb * n_full, device)
    if card and isinstance(coded_bits, torch.Tensor):
        need = n_full * rs.n * 8
        bits = on_device(coded_bits[:, :need])
        if bits.shape[1] < need:               # as np.packbits: zero-fill
            bits = torch.nn.functional.pad(bits, (0, need - bits.shape[1]))
        blocks = bytes_from_bits(bits)
    else:
        blocks = np.packbits(host(coded_bits), axis=1)[:, : n_full * rs.n]
    blocks = blocks.reshape(nb * n_full, rs.n)
    if card:
        # bytes cross to the card and back, a bit a bit only on the host
        msg, ok = rs_decode_batch_device(rs.n, rs.n_parity,
                                         on_device(blocks))
        msg, ok = msg.cpu().numpy(), ok.cpu().numpy().astype(bool)
    else:
        msg, ok = rs.decode_batch(blocks)
    ok = ok.reshape(nb, n_full).all(axis=1) & (n_bytes % rs.n == 0)
    return np.unpackbits(msg.reshape(nb, -1), axis=1), ok


def inner_decode(inner: InnerFec, coded_llrs: torch.Tensor, info_len: int,
                 ldpc_rule: str = "sum_product"):
    """1-D form of :func:`inner_decode_batch`: (info bits, all_ok)."""
    bits, ok = inner_decode_batch(inner, coded_llrs[None], info_len, ldpc_rule)
    return bits[0], bool(ok[0])


def outer_decode(outer: OuterFec, coded_bits, device=None):
    """1-D form of :func:`outer_decode_batch`: (message bits, all_ok), on
    the same device rule."""
    if not isinstance(coded_bits, torch.Tensor):
        coded_bits = np.asarray(coded_bits, np.uint8)
    msg, ok = outer_decode_batch(outer, coded_bits[None], device=device)
    return msg[0], bool(ok[0])


def decode_chain_batch(coded_llrs: torch.Tensor, plan: BlockPlan, crc: str,
                       outer: OuterFec, inner: InnerFec,
                       outer_il: InterleaverKind, inner_il: InterleaverKind,
                       scrambler: ScramblerKind, scrambler_pos: str,
                       per_frame_seeds, ldpc_rule: str = "sum_product"):
    """decode_chain over B same-plan frames: (B, L) LLR tensor → (list of
    byte arrays or None, (B,) ok). The inner code runs batched on the
    device, the outer deinterleaver per frame (each row its own stream) and
    the outer code batched (on the device past the block threshold), CRCs
    per frame."""
    seeds = [int(s) for s in per_frame_seeds]
    llrs = coded_llrs[:, : plan.coded_bits]
    nb = llrs.shape[0]
    if len(seeds) != nb:
        raise ValueError(f"{len(seeds)} seeds for {nb} frames")
    if scrambler_pos == SCRAMBLER_AFTER_INNER and scrambler.kind != "none":
        llrs = apply_pn_to_llrs(scrambler, seeds, llrs)
    inner_de = deinterleave_llrs(inner_il, llrs)[:, : plan.inner_coded_bits]
    inner_bits, inner_ok = inner_decode_batch(inner, inner_de,
                                              plan.outer_il_bits, ldpc_rule)
    inner_bits = inner_bits[:, : plan.outer_il_bits]
    if outer_il.kind == "none":
        # nothing to undo: the bits stay on their device for the outer code
        outer_de = inner_bits[:, : plan.outer_coded_bits]
    else:
        outer_de = deinterleave_bits(outer_il, inner_bits.cpu().numpy())[
            :, : plan.outer_coded_bits]
    framed_bits, outer_ok = outer_decode_batch(outer, outer_de,
                                               device=coded_llrs.device)
    datas, oks = [], np.zeros(nb, bool)
    for b in range(nb):
        fb = framed_bits[b][: plan.framed_bytes * 8]
        if len(fb) < plan.framed_bytes * 8:
            datas.append(None)
            continue
        framed = bits_to_bytes(fb)
        if scrambler_pos == SCRAMBLER_BEFORE_OUTER:
            framed = scramble_bytes(scrambler, seeds[b], framed)
        stripped = check_and_strip_crc(crc, framed)
        if stripped is None:
            datas.append(None)
            continue
        data, crc_ok = stripped
        datas.append(data)
        oks[b] = bool(crc_ok) and bool(inner_ok[b]) and bool(outer_ok[b])
    return datas, oks


def decode_chain(coded_llrs: torch.Tensor, plan: BlockPlan, crc: str,
                 outer: OuterFec, inner: InnerFec, outer_il: InterleaverKind,
                 inner_il: InterleaverKind, scrambler: ScramblerKind,
                 scrambler_pos: str, per_frame_seed: int,
                 ldpc_rule: str = "sum_product"):
    """Inverse of encode_chain for one 1-D LLR tensor: (bytes, all_ok), or
    raises RxError when the decoded frame is too short to hold its CRC."""
    datas, oks = decode_chain_batch(coded_llrs[None], plan, crc, outer, inner,
                                    outer_il, inner_il, scrambler,
                                    scrambler_pos, [per_frame_seed], ldpc_rule)
    if datas[0] is None:
        raise RxError(RxError.MALFORMED_HEADER)
    return datas[0], bool(oks[0])
