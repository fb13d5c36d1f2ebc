"""OFDM frame demodulators (counterpart of
``orion_sdr_tpu/frame/demodulator.py``).

soft_demap runs a whole symbol run as one batched tensor program (symbol
FFT → optional ZF equalize, from a held estimate or per symbol from the
pilots → grid extract → optional DFT despreading and common-phase
correction → max-log LLRs, CSI-weighted) on the IQ's device; the
header/payload decode chains and the streaming feed/flush loop are host
orchestration around it, holding an incomplete frame rather than
mis-reporting it and skipping past a corrupt preamble on failure.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from .. import obs
from ..constellation import BITS_PER_SYMBOL, bits_per_symbol, soft_llr
from ..dsp.device import on_device, sanitize_iq, takes_host_data
from ..dsp.osc import rotate
from ..multicarrier import CarrierGrid, grid_extract, symbol_fft
from ..ofdm import OfdmConfig, OfdmRxFrame, channel_estimate_denoise, \
    channel_estimate_pilots, cpe_correct, dft_deprecode, zf_equalize
from ..sync.ofdm_sync import OfdmPreamble, first_preamble, \
    training_symbol_freq_pattern
from .chain import block_plan, decode_chain, decode_chain_batch
from .modulator import (HEADER_CONSTELLATION, HEADER_FIELD_BYTES, HEADER_LDPC,
                        header_block_plan, symbols_for_coded_bits)
from .types import (FrameMetadata, FramePacket, InnerFec, InterleaverKind,
                    McsTable, OuterFec, RxError, ScramblerKind,
                    SCRAMBLER_BEFORE_OUTER, header_has_block)


class _Incomplete(Exception):
    """Streaming hold: not enough samples yet."""


def soft_demap(cfg: OfdmConfig, constellation: str, iq, n_symbols: int,
               estimate=None, device=None) -> Optional[torch.Tensor]:
    """IQ (..., T) → LLRs (..., n_symbols·n_data·bps) for n_symbols OFDM
    symbols; None if iq is too short.

    ``estimate``: optional (n_fft,) channel for per-bin ZF equalization (the
    streaming training-symbol path); None = flat channel. With
    ``cfg.equalizer_method == 'pilot_interp'`` and pilots in the plan, the
    channel is instead estimated every symbol by linear interpolation
    between the pilot bins. Either way each data bin's LLRs are weighted by
    |h|²/mean_sym(|h|²). Then, in this order: DFT despreading
    (``transform_precoding``; it mixes every bin into every symbol, so no
    CSI weighting follows) and common-phase correction (``phase_tracking
    == 'cpe'``). A tensor stays on its device; host data goes to
    ``device`` (None: the card)."""
    iq = on_device(iq, device, torch.complex64)
    if estimate is not None:
        estimate = on_device(estimate, iq.device, torch.complex64)
    g = CarrierGrid(cfg.carrier_plan)
    sps = g.n_fft + g.cp_len
    if iq.shape[-1] < n_symbols * sps:
        return None
    freq = symbol_fft(iq[..., : n_symbols * sps], g.n_fft, g.cp_len,
                      backoff=cfg.rx_window_backoff, n_symbols=n_symbols)
    csi = None
    if cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size:
        est = channel_estimate_pilots(freq, g.pilot_bins,
                                      g.pilot_values * np.complex64(cfg.gain),
                                      g.n_fft)
        freq = zf_equalize(freq, est)
        csi = (est.abs() ** 2).to(torch.float32)
    elif estimate is not None:
        freq = zf_equalize(freq, estimate)
        csi = (estimate.abs() ** 2).to(torch.float32)
    syms = grid_extract(g, freq)
    if cfg.transform_precoding:
        syms = dft_deprecode(syms)
        csi = None
    if cfg.phase_tracking == "cpe":
        syms, _ = cpe_correct(syms, constellation)
    llr = soft_llr(syms.reshape(syms.shape[:-2] + (-1,)), constellation)
    if csi is not None:
        # CSI weighting (max-ratio): ZF amplifies noise 1/|h| on faded bins
        # while the max-log distances keep full confidence; per-symbol
        # normalisation, so a flat channel weighs 1
        cd = grid_extract(g, csi)
        w = cd / torch.clamp(cd.mean(-1, keepdim=True), min=1e-9)
        bits = bits_per_symbol(constellation)
        llr = (llr.reshape(llr.shape[:-1] + (n_symbols, g.num_data_carriers,
                                             bits))
               * w[..., None]).reshape(llr.shape)
    return llr


@takes_host_data("iq", "channel_estimate")
def decode_frame_body(cfg: OfdmConfig, mcs_table: McsTable, iq: torch.Tensor,
                      channel_estimate: Optional[torch.Tensor] = None,
                      ) -> Tuple[FramePacket, int]:
    """Decode header+payload from iq[0] (first sample after preamble and
    training, CFO-corrected). Returns (packet, samples consumed). Raises
    _Incomplete (too short) or RxError (genuine failure)."""
    sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len
    if not header_has_block(cfg.header_format):
        raise RxError(RxError.MALFORMED_HEADER)
    hplan = header_block_plan(cfg)
    n_sym = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION, hplan.coded_bits)
    llrs = soft_demap(cfg, HEADER_CONSTELLATION, iq, n_sym, channel_estimate)
    if llrs is None:
        raise _Incomplete()
    fields, ok = decode_chain(
        llrs, hplan, cfg.header_crc, OuterFec.none(),
        InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
        InterleaverKind.none(), ScramblerKind.none(),
        SCRAMBLER_BEFORE_OUTER, 0, ldpc_rule="sum_product")
    if not ok:
        raise RxError(RxError.HEADER_CRC_MISMATCH)
    header = _parse_header(fields)
    if isinstance(header, RxError):
        raise header
    mcs_index, payload_len, sequence_num, flags, seed = header
    cursor = n_sym * sps
    mcs = mcs_table.get(mcs_index)
    if mcs is None:
        raise RxError(RxError.MALFORMED_HEADER)
    pplan = block_plan(payload_len, cfg.payload_crc, mcs.outer_fec,
                       mcs.inner_fec, cfg.outer_interleaver,
                       cfg.inner_interleaver)
    n_sym = symbols_for_coded_bits(cfg, mcs.constellation, pplan.coded_bits)
    llrs = soft_demap(cfg, mcs.constellation, iq[cursor:], n_sym,
                      channel_estimate)
    if llrs is None:
        raise _Incomplete()
    data, ok = decode_chain(
        llrs, pplan, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
        cfg.outer_interleaver, cfg.inner_interleaver, cfg.scrambler,
        cfg.scrambler_pos, seed, ldpc_rule=cfg.ldpc_decode_rule)
    if not ok:
        raise RxError(RxError.CRC_MISMATCH)
    meta = FrameMetadata(sequence_num=sequence_num, mcs_index=mcs_index,
                         flags=flags)
    return FramePacket(meta, data[:payload_len]), cursor + n_sym * sps


def _parse_header(fields):
    """Header bytes → (mcs_index, payload_len, seq, flags, seed), or the
    RxError to report."""
    if len(fields) < HEADER_FIELD_BYTES:
        return RxError(RxError.MALFORMED_HEADER)
    return (int(fields[0]), int.from_bytes(bytes(fields[1:5]), "big"),
            int.from_bytes(bytes(fields[5:9]), "big"), int(fields[9]),
            int.from_bytes(bytes(fields[10:14]), "big"))


def _as_iq(iq, device) -> torch.Tensor:
    x = torch.as_tensor(np.asarray(iq, np.complex64) if not isinstance(
        iq, torch.Tensor) else iq, device=device).to(torch.complex64)
    obs.count_h2d(iq, x)
    return x


class OfdmFrameDemod:
    """Demod at a KNOWN start (iq[0] = first post-preamble sample), flat
    channel; decoding runs on ``device``. ``cache`` is accepted for the JAX
    package's signature and does nothing (the port's ``CodecCache`` is
    inert: codes memoize process-wide)."""

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable, cache=None, *,
                 device="cuda") -> None:
        self.cfg = cfg
        self.mcs_table = mcs_table
        self.device = torch.device(device)

    def decode(self, iq) -> FramePacket:
        try:
            packet, _ = decode_frame_body(self.cfg, self.mcs_table,
                                          _as_iq(iq, self.device))
        except _Incomplete:
            raise RxError(RxError.MALFORMED_HEADER) from None
        return packet

    @obs.rooted("orion.frame.decode_batch")
    def decode_batch(self, iq_batch) -> List[Union[FramePacket, RxError]]:
        """Decode B ALIGNED frame captures (iq[b, 0] = first post-preamble
        sample, flat channel) → per-frame FramePacket or RxError, in order.
        One demap and one BP launch decode every header, then frames group
        by (mcs_index, payload_len) and each group's payload demap + FEC
        chain runs batched across the group. Under the profiler each call
        is the root ``orion.frame.decode_batch`` (``obs``)."""
        cfg = self.cfg
        iq = _as_iq(iq_batch, self.device)
        if iq.dim() != 2:
            raise ValueError("iq_batch must be (B, T)")
        n_frames = iq.shape[0]
        obs.count("frames", n_frames)
        sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len
        results: List[Union[FramePacket, RxError, None]] = [None] * n_frames

        hplan = header_block_plan(cfg)
        n_sym_h = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION,
                                         hplan.coded_bits)
        with obs.span("orion.frame.soft_demap"):
            hllrs = soft_demap(cfg, HEADER_CONSTELLATION, iq, n_sym_h)
        if hllrs is None:
            raise RxError(RxError.MALFORMED_HEADER)
        fields, hok = decode_chain_batch(
            hllrs, hplan, cfg.header_crc, OuterFec.none(),
            InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
            InterleaverKind.none(), ScramblerKind.none(),
            SCRAMBLER_BEFORE_OUTER, [0] * n_frames, ldpc_rule="sum_product")

        with obs.span("orion.frame.header_parse"):
            headers = [None] * n_frames
            for b in range(n_frames):
                if not hok[b] or fields[b] is None:
                    results[b] = RxError(RxError.HEADER_CRC_MISMATCH)
                    continue
                h = _parse_header(fields[b])
                if isinstance(h, RxError):
                    results[b] = h
                else:
                    headers[b] = h

            groups: dict = {}
            for b, h in enumerate(headers):
                if h is None:
                    continue
                if self.mcs_table.get(h[0]) is None:
                    results[b] = RxError(RxError.MALFORMED_HEADER)
                    continue
                groups.setdefault((h[0], h[1]), []).append(b)
        obs.count("frames.header_fail", n_frames - sum(
            len(idxs) for idxs in groups.values()))

        cursor = n_sym_h * sps
        decoded = []
        for (mcs_index, payload_len), idxs in groups.items():
            with obs.span("orion.frame.group"):
                obs.count(f"group.mcs{mcs_index}.len{payload_len}",
                          len(idxs))
                mcs = self.mcs_table.get(mcs_index)
                pplan = block_plan(payload_len, cfg.payload_crc,
                                   mcs.outer_fec, mcs.inner_fec,
                                   cfg.outer_interleaver,
                                   cfg.inner_interleaver)
                n_sym = symbols_for_coded_bits(cfg, mcs.constellation,
                                               pplan.coded_bits)
                rows = iq[torch.as_tensor(idxs, device=iq.device), cursor:]
                with obs.span("orion.frame.soft_demap"):
                    llr = soft_demap(cfg, mcs.constellation, rows, n_sym)
                if llr is None:
                    for b in idxs:
                        results[b] = RxError(RxError.MALFORMED_HEADER)
                    continue
                decoded.append((idxs, payload_len, decode_chain_batch(
                    llr, pplan, cfg.payload_crc, mcs.outer_fec,
                    mcs.inner_fec, cfg.outer_interleaver,
                    cfg.inner_interleaver, cfg.scrambler, cfg.scrambler_pos,
                    [headers[b][4] for b in idxs],
                    ldpc_rule=cfg.ldpc_decode_rule)))

        crc_fail = 0
        with obs.span("orion.frame.packets"):
            for idxs, payload_len, (datas, pok) in decoded:
                for j, b in enumerate(idxs):
                    if not pok[j] or datas[j] is None:
                        results[b] = RxError(RxError.CRC_MISMATCH)
                        crc_fail += 1
                        continue
                    h = headers[b]
                    meta = FrameMetadata(sequence_num=h[2], mcs_index=h[0],
                                         flags=h[3])
                    results[b] = FramePacket(meta, datas[j][:payload_len])
        obs.count("frames.crc_fail", crc_fail)
        return results


@dataclass
class RxFrame:
    """Received frame + RX diagnostics."""
    packet: FramePacket
    diagnostics: OfdmRxFrame


class OfdmFrameStreamDemod:
    """Streaming receiver: feed IQ, poll frames/errors. The buffer lives on
    ``device``; ``cache`` is accepted for the JAX package's signature and
    does nothing (the port's ``CodecCache`` is inert).

    Per attempt: the earliest preamble scoring ≥ threshold → total-CFO
    derotate → training-symbol channel estimate → decode → drain; an
    incomplete frame holds the buffer, a failed one is reported and its
    preamble skipped. (The JAX package takes the best-scoring candidate
    instead, which drops an earlier frame still held in the buffer when a
    later preamble scores higher; the port takes frames in order.)
    """

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 preamble: OfdmPreamble, score_threshold: float = 0.5,
                 cache=None, *, device="cuda") -> None:
        self.cfg = cfg
        self.mcs_table = mcs_table
        self.preamble = preamble
        self.score_threshold = score_threshold
        self.device = torch.device(device)
        self._buf = torch.zeros(0, dtype=torch.complex64, device=self.device)

    def __len__(self) -> int:
        return self._buf.shape[0]

    def view_buf(self) -> np.ndarray:
        return self._buf.cpu().numpy()

    def clear(self) -> None:
        self._buf = self._buf[:0]

    def feed(self, iq) -> List[Union[RxFrame, RxError]]:
        self._buf = torch.cat([self._buf, sanitize_iq(_as_iq(iq, self.device))])
        return self._drain()

    def flush(self) -> List[Union[RxFrame, RxError]]:
        return self._drain()

    def _drain(self):
        out = []
        while True:
            step = self._try_one_frame()
            if step is None:
                return out
            result, consume_to = step
            self._buf = self._buf[consume_to:]
            out.append(result)

    def _estimate_channel(self, corrected: torch.Tensor):
        t = self.preamble.training_symbol
        if t is None:
            return None
        start = self.preamble.num_repeats * self.preamble.repeat_len
        end = start + t.n_fft + t.cp_len
        if corrected.shape[0] < end:
            return None
        freq = symbol_fft(corrected[start:end], t.n_fft, t.cp_len,
                          backoff=self.cfg.rx_window_backoff, n_symbols=1)[0]
        known = torch.as_tensor(training_symbol_freq_pattern(t.n_fft)
                                * self.cfg.gain, device=freq.device)
        # delay-domain denoise: any in-guard channel passes unchanged
        return channel_estimate_denoise((freq / known).to(torch.complex64),
                                        t.cp_len, self.cfg.rx_window_backoff)

    def _try_one_frame(self):
        n_fft = self.cfg.carrier_plan.n_fft
        cp_len = self.cfg.carrier_plan.cp_len
        pre_len = self.preamble.total_len()
        n_buf = self._buf.shape[0]
        if n_buf < pre_len + n_fft + cp_len:
            return None
        best = first_preamble(self._buf, self.cfg.fs, self.preamble,
                              self.score_threshold)
        if best is None:
            # keep only a tail that can hold a preamble straddling the feed
            # boundary, so dead air neither grows the buffer nor slows sync
            keep = pre_len + (n_fft + cp_len) * 4
            if n_buf > keep:
                self._buf = self._buf[n_buf - keep:]
            return None
        spacing = self.cfg.fs / n_fft
        total_cfo = best.cfo_hz + best.integer_cfo_bins * spacing
        corrected, _ = rotate(self._buf[best.start_sample:],
                              np.float32(-total_cfo), self.cfg.fs)
        if corrected.shape[0] < pre_len:
            return None
        est = self._estimate_channel(corrected)
        try:
            packet, body_samples = decode_frame_body(
                self.cfg, self.mcs_table, corrected[pre_len:], est)
        except _Incomplete:
            return None
        except RxError as e:
            return e, min(best.start_sample + pre_len, n_buf)
        diagnostics = OfdmRxFrame(
            bits=np.zeros(0, np.uint8), num_symbols=0, evm_db=None,
            cfo_hz=float(total_cfo),
            timing_offset_samples=int(best.start_sample), channel_mse=None)
        consume_to = best.start_sample + pre_len + body_samples
        if consume_to > n_buf:
            return None
        return RxFrame(packet=packet, diagnostics=diagnostics), consume_to
