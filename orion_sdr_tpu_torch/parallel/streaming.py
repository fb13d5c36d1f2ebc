"""Time-sharding of streaming receiver state (counterpart of
``orion_sdr_tpu/parallel/streaming.py``).

A streaming receiver carries four kinds of sequential state across block
boundaries; each gets a sharded form over a :class:`~.mesh.Mesh`:

* filter tails: ``sharding.fir_overlap_save_sharded``;
* NCO/AFC/PLL phase: :func:`psk31_demod_sharded`. The matched-filter dots
  (one float32 product a symbol block) run on each shard's time block; the
  dots, one complex value a symbol, are gathered on the mesh's first
  device, where the PSK31 PLL kernel (``ops/psk31_pll.py``) runs the
  decision-feedback recurrence once (the JAX package runs it replicated);
* Viterbi trellis state: :func:`viterbi_decode_sharded`. Each shard owns a
  run of trellis chunks; the convergence margins a chunk needs from its
  neighbours arrive as LLR halos (:func:`~.mesh.ppermute`), and each shard
  makes one launch of the chunked Viterbi kernel over its chunks: the
  single-device chunked decode, bit for bit;
* Forney interleaver lines: :func:`forney_deinterleave_sharded`. The delay
  lines are a halo of D = (I−1)·M·I bytes from the left neighbour.

:func:`dvb_t_decode_time_sharded` composes them into one long conformant
DVB-T capture decoded across the mesh (the outer RS code on the card, as
the single-device decode); :func:`ofdm_frame_decode_time_sharded` does the
same for a COFDM frame (LDPC BP on the card).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constellation import bits_per_symbol
from .mesh import Mesh, ppermute, shard, unshard
from .sharding import as_tensor, ofdm_soft_demap_sharded


# ── AFC/PLL phase: PSK31 decision-feedback demod ─────────────────────────────


def psk31_demod_sharded(iq, mesh: Mesh, fs: float, rf_hz: float = 0.0,
                        gain: float = 1.0, qpsk: bool = False):
    """Time-sharded PSK31 decision-feedback demod: the same soft outputs as
    ``bpsk31_demod`` / ``qpsk31_demod`` ((n_syms,) float32, or (n_syms, 2)
    for QPSK), on the mesh's first device."""
    from ..demodulate.psk31 import (BPSK31_LOOP_GAIN, QPSK31_LOOP_GAIN, _hann,
                                    matched_filter_dots, pll_constants)
    from ..dsp.osc import rotate_host
    from ..modulate.psk31 import psk31_sps
    from ..ops.psk31_pll import psk31_pll

    dev0 = mesh.first_device
    sps = psk31_sps(fs)
    z = as_tensor(iq, dev0).to(device=dev0, dtype=torch.complex64)
    if rf_hz != 0.0:
        z, _ = rotate_host(z, np.float32(-rf_hz), fs)
    fm = mesh.flat()
    nd = fm.size
    true_syms = z.shape[-1] // sps
    if true_syms == 0:
        return torch.zeros((0, 2) if qpsk else (0,), dtype=torch.float32,
                           device=dev0)
    # zero symbols pad the run to a whole number a shard; the PLL is causal,
    # so the real symbols' outputs are unchanged and the tail is trimmed
    n_syms = -(-true_syms // nd) * nd
    seg = torch.zeros((n_syms, sps), dtype=torch.complex64, device=dev0)
    seg[:true_syms] = z[: true_syms * sps].reshape(true_syms, sps)
    dots = shard(seg, fm, ("t",)).map(
        lambda b: matched_filter_dots(b, _hann(sps, b.device)))
    dots = unshard(dots, ("t",))
    c_fb, scale = pll_constants(sps, gain)
    soft, _, _ = psk31_pll(
        dots, torch.ones((), dtype=torch.complex64, device=dev0),
        torch.zeros((), dtype=torch.float32, device=dev0), c_fb, scale,
        QPSK31_LOOP_GAIN if qpsk else BPSK31_LOOP_GAIN, qpsk)
    return soft[:true_syms]


def psk31_stream_decode_sharded(iq, mesh: Mesh, fs: float,
                                carrier_hz: float = 0.0,
                                qpsk: bool = False) -> str:
    """Text of one long capture: sharded demod → threshold (BPSK31) or
    Viterbi (QPSK31) decisions → varicode on the host; the single-device
    ``Psk31Stream`` decode of the same capture."""
    from ..codec.psk31 import viterbi_decode
    from ..codec.varicode import VaricodeDecoder
    from ..demodulate.psk31 import bpsk31_decide

    soft = psk31_demod_sharded(iq, mesh, fs, rf_hz=carrier_hz, qpsk=qpsk)
    if qpsk:
        bits = viterbi_decode(soft, device=soft.device).cpu().numpy()
    else:
        bits = bpsk31_decide(soft)
    return VaricodeDecoder().push_bits(bits)


# ── Viterbi trellis state: chunked decode with LLR halo exchange ─────────────


def viterbi_decode_sharded(coded_llrs, info_bits: int, mesh: Mesh,
                           rate: str = "1/2", code: str = "dvb_k7"):
    """Time-sharded overlap-chunked soft Viterbi of one long stream: each
    shard owns ``nchunk/nd`` contiguous chunks and receives ``CHUNK_OVERLAP``
    steps of LLRs from each neighbour (zeros at the two ends); chunk 0 of
    shard 0 starts pinned at state 0, every other chunk uniform; one kernel
    launch a shard. Equals ``fec.conv.viterbi_decode_soft_chunked`` bit for
    bit. Returns (info_bits,) uint8 on the mesh's first device."""
    from ..fec.conv import (CHUNK_OVERLAP as V, CHUNK_STEPS as C, _tables,
                            depuncture_llrs, tail_bits)

    _, S, *_ = _tables(code)
    llrs = as_tensor(coded_llrs, mesh.first_device).to(torch.float32)
    if llrs.dim() != 1:
        raise ValueError("the sharded decode takes one long stream")
    full = depuncture_llrs(llrs, info_bits, rate, code)
    n_steps = info_bits + tail_bits(code)
    fm = mesh.flat()
    nd = fm.size
    nchunk = -(-n_steps // C)
    nchunk = -(-nchunk // nd) * nd          # a whole number a shard
    pad = (0, C * nchunk - n_steps)
    pairs = torch.stack([torch.nn.functional.pad(full[0::2], pad),
                         torch.nn.functional.pad(full[1::2], pad)])
    k = nchunk // nd
    blocks = shard(pairs, fm, (None, "t"))                  # (2, k·C) each
    # shard i sends its last V steps right and its first V steps left
    from_left = ppermute(blocks.map(lambda b: b[:, -V:]), "t",
                         [(i, i + 1) for i in range(nd - 1)])
    from_right = ppermute(blocks.map(lambda b: b[:, :V]), "t",
                          [(i, i - 1) for i in range(1, nd)])
    span = C + 2 * V

    def local(pos, b, lh, rh):
        from ..ops.viterbi import viterbi_chunks_kernel
        # chunk j covers the block's steps [j·C − V, j·C + C + V): k
        # overlapping windows of the halo-extended block
        c = torch.cat([lh, b, rh], dim=1).unfold(1, span, C)   # (2, k, span)
        pm0 = b.new_zeros((k, S))
        if pos["t"] == 0:
            pm0[0] = -1e30
            pm0[0, 0] = 0.0
        bits = viterbi_chunks_kernel(c[0].contiguous(), c[1].contiguous(),
                                     pm0, code)
        return bits[:, V:V + C].reshape(-1)

    out = blocks.map(local, from_left, from_right, indexed=True)
    return unshard(out, ("t",))[:info_bits]


# ── Forney interleaver lines: delay-line halo ────────────────────────────────


def forney_deinterleave_sharded(x, mesh: Mesh, branches: int = 12,
                                depth: int = 17):
    """Time-sharded Forney deinterleave of one long byte stream: output[t]
    reads input[t − (I−1−j)·M·I], j = t mod I, so a shard needs only its
    left neighbour's last D = (I−1)·M·I bytes (the interleaver lines).
    Streams shorter than D take the host path, and each block must cover
    D, so short streams use fewer shards. Bit-exact against
    ``fec.interleave.forney_deinterleave``; returns a uint8 tensor on the
    mesh's first device."""
    I, M = branches, depth
    D = (I - 1) * M * I
    dev0 = mesh.first_device
    x = as_tensor(x, dev0)
    n = x.shape[-1]
    if n < D:
        from ..fec.interleave import forney_deinterleave
        out, _ = forney_deinterleave(x.cpu().numpy(), branches, depth)
        return torch.as_tensor(out, device=dev0)
    all_devs = mesh.devices.reshape(-1)
    nd = int(max(1, min(all_devs.size, n // D)))
    fm = Mesh(all_devs[:nd], ("t",))
    pad = (-n) % nd          # zeros at the tail: the gathers read backward
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
    blk = (n + pad) // nd
    xs = shard(x, fm, ("t",))
    halo = ppermute(xs.map(lambda b: b[-D:]), "t",
                    [(i, i + 1) for i in range(nd - 1)])

    def local(pos, xb, h):
        t_local = torch.arange(blk, device=xb.device)
        j = (pos["t"] * blk + t_local) % I
        src = D + t_local - (I - 1 - j) * M * I
        return torch.cat([h, xb])[src]

    return unshard(xs.map(local, halo, indexed=True), ("t",))[:n]


# ── Capstone: whole DVB-T decode, time-sharded ───────────────────────────────


def dvb_t_receive_time_sharded(iq_aligned, n_symbols: int, cp_len: int,
                               backoff: int, vbits: int, mesh: Mesh):
    """The DVB-T receive (``receive_frame_body``) over one long aligned
    capture in symbol-aligned time shards: every shard takes the same whole
    number of symbols, a multiple of the 4 scattered-pilot phases, so each
    starts at phase 0 (zero symbols pad the run and are trimmed). Returns
    (llrs (n_symbols, 1512·vbits), tps_cells (n_symbols, 17))."""
    from ..demodulate.dvb_t_frame import receive_frame_body
    from ..waveform.dvb_t import DVB_T_N_FFT

    fm = mesh.flat()
    nd = fm.size
    sps = DVB_T_N_FFT + cp_len
    quantum = 4 * nd
    n_pad_syms = -(-n_symbols // quantum) * quantum
    local_syms = n_pad_syms // nd
    iq = as_tensor(iq_aligned, mesh.first_device).to(torch.complex64)
    iq = iq[: n_symbols * sps]
    iq = torch.nn.functional.pad(iq, (0, n_pad_syms * sps - iq.shape[0]))
    out = shard(iq, fm, ("t",)).map(
        lambda z: receive_frame_body(z, local_syms, cp_len, backoff, vbits))
    return (unshard(out.part(0), ("t",))[:n_symbols],
            unshard(out.part(1), ("t",))[:n_symbols])


def dvb_t_decode_time_sharded(iq, n_symbols: int, payload_len: int, params,
                              mesh: Mesh, rx_window_backoff: int = 0):
    """A whole conformant DVB-T frame run decoded across the mesh: GI
    acquisition → symbol-sharded receive → TPS → sharded Viterbi (LLR
    halos) → sharded Forney lines (bytes on the card) → RS(204,188) (the
    card's outer-code kernel past the chain's block threshold) → TS. Equals
    ``DvbTFrameDemod.decode`` on one device."""
    from ..constellation import BITS_PER_SYMBOL
    from ..demodulate.dvb_t_frame import (DvbTRxError, DvbTRxFrame, _as_iq,
                                          _tps_word)
    from ..fec.bch_device import bits_from_bytes, bytes_from_bits
    from ..fec.interleave import conv_roundtrip_delay
    from ..frame import chain
    from ..frame.types import InterleaverKind
    from ..sync.dvb_t_gi_sync import dvb_t_gi_sync
    from ..waveform.dvb_t import (DVB_T_N_FFT, dvb_t_frame_outer,
                                  dvb_t_frame_outer_il,
                                  dvb_t_fs_for_bandwidth, guard_cp_len_2k)
    from ..waveform.dvb_t_ts import (TS_PACKET_LEN, TS_PAYLOAD_LEN,
                                     ts_depacketize, ts_energy_disperse)

    cp_len = guard_cp_len_2k(params.link.guard)
    sps = DVB_T_N_FFT + cp_len
    vbits = BITS_PER_SYMBOL[params.link.constellation]
    fs = dvb_t_fs_for_bandwidth(1_000_000.0)
    iq = _as_iq(iq, mesh.first_device)

    acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fs, sps)
    if acq is None:
        raise DvbTRxError(DvbTRxError.ACQUISITION)
    start = acq.start_sample
    if iq.shape[-1] < start + n_symbols * sps:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)
    llrs, cells = dvb_t_receive_time_sharded(
        iq[start: start + n_symbols * sps], n_symbols, cp_len,
        rx_window_backoff, vbits, mesh)
    tps = _tps_word(cells.cpu().numpy(), n_symbols)
    if tps is None:
        raise DvbTRxError(DvbTRxError.TPS_DECODE)

    # the DVB-T scheme of frame.chain.decode_chain: no CRC, RS(204,188) +
    # Forney(12, 17) outer interleaver + K=7 inner code, no inner
    # interleaver, no scrambler
    inner = params.inner()
    n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
    ts_len = n_ts * TS_PACKET_LEN
    plan = chain.block_plan(ts_len, "none", dvb_t_frame_outer(), inner,
                            dvb_t_frame_outer_il(), InterleaverKind.none())
    llrs = llrs.reshape(-1)[: plan.coded_bits]
    info = viterbi_decode_sharded(llrs, plan.outer_il_bits, mesh,
                                  inner.rate, inner.code)
    # the streaming deinterleaver's first d outputs are line fill (dropped)
    d = conv_roundtrip_delay(12, 17)
    total = info.shape[0] // 8
    byts = bytes_from_bits(info[: total * 8])
    deint = forney_deinterleave_sharded(byts, mesh)[d:total]
    outer_de = bits_from_bytes(deint)[: plan.outer_coded_bits]
    framed, ok = chain.outer_decode_batch(dvb_t_frame_outer(), outer_de[None])
    framed_bits = framed[0][: plan.framed_bytes * 8]
    if not ok[0] or len(framed_bits) < plan.framed_bytes * 8:
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
    ts = ts_energy_disperse(chain.bits_to_bytes(framed_bits)[:ts_len])
    payload = ts_depacketize(ts)
    if payload is None:
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
    return DvbTRxFrame(payload=payload[:payload_len], tps=tps)


# ── COFDM frame capstone: whole-frame decode, time-sharded ───────────────────


def ofdm_frame_decode_time_sharded(cfg, mcs_table, preamble, iq, mesh: Mesh,
                                   score_threshold: float = 0.5):
    """A whole COFDM frame decoded across the mesh: S&C acquisition → CFO
    derotation → training-symbol channel estimate (with its delay-domain
    denoise) → symbol-aligned sharded soft demap of the header, then the
    payload → the decode chains (LDPC BP on the card). Returns the
    ``FramePacket`` ``OfdmFrameStreamDemod`` returns for the same capture:
    like that receiver, it takes the earliest preamble scoring at least
    ``score_threshold`` (the JAX package's capstone takes the best-scoring
    one, which is a later frame's when two share the capture)."""
    from ..dsp.osc import rotate
    from ..frame.chain import block_plan, decode_chain
    from ..frame.demodulator import _as_iq, _parse_header
    from ..frame.modulator import (HEADER_CONSTELLATION, HEADER_LDPC,
                                   header_block_plan, symbols_for_coded_bits)
    from ..frame.types import (FrameMetadata, FramePacket, InnerFec,
                               InterleaverKind, OuterFec, RxError,
                               ScramblerKind, SCRAMBLER_BEFORE_OUTER,
                               header_has_block)
    from ..multicarrier import symbol_fft
    from ..ofdm import channel_estimate_denoise
    from ..sync.ofdm_sync import first_preamble, training_symbol_freq_pattern

    if not header_has_block(cfg.header_format):
        raise RxError(RxError.MALFORMED_HEADER)
    iq = _as_iq(iq, mesh.first_device)
    best = first_preamble(iq, cfg.fs, preamble, score_threshold)
    if best is None:
        raise RxError(RxError.PREAMBLE_TIMEOUT)
    spacing = cfg.fs / cfg.carrier_plan.n_fft
    total_cfo = best.cfo_hz + best.integer_cfo_bins * spacing
    corrected, _ = rotate(iq[best.start_sample:], np.float32(-total_cfo),
                          cfg.fs)
    body = corrected[preamble.total_len():]
    sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len

    # the training-hold estimate: per bin, so every shard's ZF takes it
    # whole and no halo is needed
    est = None
    t = preamble.training_symbol
    if t is not None and cfg.equalizer_method != "pilot_interp":
        start = preamble.num_repeats * preamble.repeat_len
        freq = symbol_fft(corrected[start:start + t.n_fft + t.cp_len],
                          t.n_fft, t.cp_len, backoff=cfg.rx_window_backoff,
                          n_symbols=1)[0]
        known = torch.as_tensor(training_symbol_freq_pattern(t.n_fft)
                                * cfg.gain, device=freq.device)
        est = channel_estimate_denoise((freq / known).to(torch.complex64),
                                       t.cp_len, cfg.rx_window_backoff)

    # one capture: every shard of the mesh on the time axis
    tmesh = Mesh(mesh.devices.reshape(1, -1), ("ch", "t"))
    t_dim = tmesh.shape["t"]

    def demap(seg, constellation, n_sym):
        n_pad = -(-n_sym // t_dim) * t_dim
        z = torch.zeros((1, n_pad * sps), dtype=torch.complex64,
                        device=seg.device)
        z[0, : n_sym * sps] = seg[: n_sym * sps]
        llr = ofdm_soft_demap_sharded(cfg, constellation, z, n_pad, tmesh,
                                      estimate=est)
        per_sym = (cfg.carrier_plan.num_data_carriers()
                   * bits_per_symbol(constellation))
        return llr.reshape(-1)[: n_sym * per_sym]

    hplan = header_block_plan(cfg)
    n_sym_h = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION,
                                     hplan.coded_bits)
    if body.shape[0] < n_sym_h * sps:
        raise RxError(RxError.MALFORMED_HEADER)
    fields, ok = decode_chain(
        demap(body, HEADER_CONSTELLATION, n_sym_h), hplan, cfg.header_crc,
        OuterFec.none(), InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
        InterleaverKind.none(), ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER,
        0, ldpc_rule="sum_product")
    if not ok:
        raise RxError(RxError.HEADER_CRC_MISMATCH)
    header = _parse_header(fields)
    if isinstance(header, RxError):
        raise header
    mcs_index, payload_len, sequence_num, flags, seed = header
    mcs = mcs_table.get(mcs_index)
    if mcs is None:
        raise RxError(RxError.MALFORMED_HEADER)
    pplan = block_plan(payload_len, cfg.payload_crc, mcs.outer_fec,
                       mcs.inner_fec, cfg.outer_interleaver,
                       cfg.inner_interleaver)
    n_sym_p = symbols_for_coded_bits(cfg, mcs.constellation,
                                     pplan.coded_bits)
    if body.shape[0] < (n_sym_h + n_sym_p) * sps:
        raise RxError(RxError.CRC_MISMATCH)
    data, ok = decode_chain(
        demap(body[n_sym_h * sps:], mcs.constellation, n_sym_p), pplan,
        cfg.payload_crc, mcs.outer_fec, mcs.inner_fec, cfg.outer_interleaver,
        cfg.inner_interleaver, cfg.scrambler, cfg.scrambler_pos, seed,
        ldpc_rule=cfg.ldpc_decode_rule)
    if not ok:
        raise RxError(RxError.CRC_MISMATCH)
    meta = FrameMetadata(sequence_num=sequence_num, mcs_index=mcs_index,
                         flags=flags)
    return FramePacket(meta, data[:payload_len])

