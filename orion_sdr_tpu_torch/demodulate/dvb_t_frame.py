"""Conformant DVB-T frame demodulator (counterpart of
``orion_sdr_tpu/demodulate/dvb_t_frame.py``). GI acquisition (van de Beek)
→ symbol FFT → TPS from the raw bins → scattered-pilot equalisation with
CSI weighting → Figure-9a soft LLRs → conv (Viterbi) + Forney + RS(204,188)
decode → un-disperse → depacketize.

The receive runs on the demodulator's device over whole frames, and
``decode_batch`` over the whole batch of frames in one call; all frames'
payloads then go through one ``decode_chain_batch``, so one Viterbi launch
covers every frame's chunks. TPS, Forney, RS and the TS layer run on the
host. The hierarchical and blind receivers are not in the port yet.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..constellation import BITS_PER_SYMBOL
from ..dsp.osc import rotate_host
from ..frame.chain import block_plan, decode_chain_batch
from ..frame.types import InterleaverKind, ScramblerKind, SCRAMBLER_BEFORE_OUTER
from ..multicarrier import symbol_fft
from ..ofdm import channel_estimate_pilots, zf_equalize
from ..sync.dvb_t_gi_sync import dvb_t_gi_sync, dvb_t_integer_cfo
from ..unported import (DVB_T_BAND, DVB_T_BLIND, DVB_T_HIER, DVB_T_STREAM,
                        DVB_T_SUPER_FRAME, not_ported)
from ..waveform.dvb_t import (
    DVB_T_N_FFT, DVB_T_SCATTERED_PHASES, DvbTFrameParams, _phase_symbols,
    guard_cp_len_2k, scattered_grid, scattered_extract_frame, dvb_t_soft_llrs,
    tps_carrier_bins, dvb_t_frame_outer, dvb_t_frame_outer_il,
    dvb_t_fs_for_bandwidth,
)
from ..waveform.dvb_t_tps import tps_decode_frame, TpsWord, \
    TPS_SYMBOLS_PER_FRAME
from ..waveform.dvb_t_ts import (
    TS_PACKET_LEN, TS_PAYLOAD_LEN, ts_energy_disperse, ts_depacketize,
)

INTEGER_CFO_ACCUM_SYMBOLS = 8
INTEGER_CFO_MAX_BINS = 32


class DvbTRxError(Exception):
    ACQUISITION = "guard-interval acquisition failed"
    INCOMPLETE = "too few samples for the expected frame"
    TPS_DECODE = "TPS word failed to decode"
    PAYLOAD_DECODE = "payload FEC decode failed"

    def __init__(self, kind: str) -> None:
        super().__init__(kind)
        self.kind = kind


class DvbTRxFrame(NamedTuple):
    payload: np.ndarray
    tps: TpsWord


def scattered_equalize_csi(freq: torch.Tensor, first_phase: int = 0,
                           backoff: int = 0):
    """(..., n_sym, 2048) raw spectra → (ZF-equalised spectra, |ĥ|² CSI),
    each symbol estimated from its own phase's channel-reference pilots.
    (``backoff`` is the receive window's back-off, already applied by the
    symbol FFT.)"""
    g = scattered_grid()
    out = torch.empty_like(freq)
    csi = freq.new_empty(freq.shape, dtype=torch.float32)
    for phase in range(DVB_T_SCATTERED_PHASES):
        syms = _phase_symbols(freq.shape[-2], first_phase, phase)
        if len(syms) == 0:
            continue
        s = torch.as_tensor(syms, device=freq.device)
        sub = freq[..., s, :]
        est = channel_estimate_pilots(sub, np.asarray(g.ref_bins[phase]),
                                      np.asarray(g.ref_vals[phase]),
                                      DVB_T_N_FFT)
        out[..., s, :] = zf_equalize(sub, est)
        csi[..., s, :] = (est.abs() ** 2).to(torch.float32)
    return out, csi


def scattered_equalize(freq: torch.Tensor, first_phase: int = 0,
                       backoff: int = 0) -> torch.Tensor:
    return scattered_equalize_csi(freq, first_phase, backoff)[0]


def receive_frame_body(seg: torch.Tensor, n_symbols: int, cp_len: int,
                       backoff: int, vbits: int, alpha: int = 1):
    """Aligned captures (..., ≥ n_symbols·(2048+cp)) → (CSI-weighted LLRs
    (..., n_symbols, 1512·vbits), raw TPS cells (..., n_symbols, 17)).

    The LLRs of each carrier are scaled by |ĥ|²/mean(|ĥ|²) over its symbol
    (max-ratio weighting: zero forcing lifts the noise on faded carriers
    while the max-log distances keep full confidence); on a flat channel
    the weight is 1."""
    freq = symbol_fft(seg, DVB_T_N_FFT, cp_len, backoff=backoff,
                      n_symbols=n_symbols)
    cells = freq[..., torch.as_tensor(tps_carrier_bins(), device=freq.device)]
    eq, csi_full = scattered_equalize_csi(freq, backoff=backoff)
    llrs = dvb_t_soft_llrs(scattered_extract_frame(eq), vbits, alpha)
    csi = scattered_extract_frame(csi_full)
    w = csi / torch.clamp(csi.mean(dim=-1, keepdim=True), min=1e-9)
    shaped = llrs.reshape(csi.shape + (vbits,)) * w[..., None]
    return shaped.reshape(llrs.shape), cells


def _tps_word(cells: np.ndarray, n_symbols: int) -> Optional[TpsWord]:
    """The first TPS block of the frame that decodes, or None."""
    for blk in range(n_symbols // TPS_SYMBOLS_PER_FRAME):
        word = TpsWord.unpack(tps_decode_frame(
            cells[blk * TPS_SYMBOLS_PER_FRAME:
                  (blk + 1) * TPS_SYMBOLS_PER_FRAME]))
        if word is not None:
            return word
    return None


def _as_iq(iq, device) -> torch.Tensor:
    if not isinstance(iq, torch.Tensor):
        a = np.asarray(iq, np.complex64)
        iq = torch.as_tensor(a if a.flags.writeable else a.copy())
    return iq.to(device=device, dtype=torch.complex64)


class DvbTFrameDemod:
    """Demodulator of conformant frames on ``device``: ``decode`` acquires
    one frame at an unknown offset, ``decode_batch`` takes aligned
    captures."""

    def __init__(self, params: DvbTFrameParams, integer_cfo: bool = False,
                 rx_window_backoff: int = 0, *, device) -> None:
        self.params = params
        self.integer_cfo = integer_cfo
        self.rx_window_backoff = rx_window_backoff
        self.device = torch.device(device)

    def with_integer_cfo_correction(self, on: bool = True) -> "DvbTFrameDemod":
        return DvbTFrameDemod(self.params, on, self.rx_window_backoff,
                              device=self.device)

    def with_rx_window_backoff(self, backoff: int) -> "DvbTFrameDemod":
        return DvbTFrameDemod(self.params, self.integer_cfo, backoff,
                              device=self.device)

    @property
    def fs(self) -> float:
        """Baseband rate the CFO units refer to (1 MHz occupied)."""
        return dvb_t_fs_for_bandwidth(1_000_000.0)

    def _integer_cfo_correct(self, iq: torch.Tensor, cp_len: int):
        if not self.integer_cfo:
            return None
        sps = DVB_T_N_FFT + cp_len
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            return None
        n_acc = min(INTEGER_CFO_ACCUM_SYMBOLS,
                    (iq.shape[-1] - acq.start_sample) // sps)
        if n_acc == 0:
            return None
        seg = iq[acq.start_sample: acq.start_sample + n_acc * sps]
        freq = symbol_fft(seg, DVB_T_N_FFT, cp_len, n_symbols=n_acc)
        accum = (freq.abs() ** 2).sum(dim=0).cpu().numpy()
        est = dvb_t_integer_cfo(accum.astype(np.complex64), DVB_T_N_FFT,
                                INTEGER_CFO_MAX_BINS)
        if est is None or est.bins == 0:
            return None
        z, _ = rotate_host(iq, np.float32(-est.bins * self.fs / DVB_T_N_FFT),
                           self.fs)
        return z

    def decode(self, iq, n_symbols: int, payload_len: int) -> DvbTRxFrame:
        """One frame at an unknown offset in a 1-D capture."""
        cp_len = guard_cp_len_2k(self.params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[self.params.link.constellation]
        iq = _as_iq(iq, self.device)
        corrected = self._integer_cfo_correct(iq, cp_len)
        if corrected is not None:
            iq = corrected
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            raise DvbTRxError(DvbTRxError.ACQUISITION)
        start = acq.start_sample
        if iq.shape[-1] < start + n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)
        llrs, cells = receive_frame_body(iq[start: start + n_symbols * sps],
                                         n_symbols, cp_len,
                                         self.rx_window_backoff, vbits)
        tps = _tps_word(cells.cpu().numpy(), n_symbols)
        if tps is None:
            raise DvbTRxError(DvbTRxError.TPS_DECODE)
        return self._decode_payloads(llrs.reshape(1, -1), payload_len,
                                     [tps])[0]

    def decode_batch(self, iq_batch, n_symbols: int, payload_len: int
                     ) -> List[DvbTRxFrame]:
        """(B, n) aligned frame captures → B DvbTRxFrame, in order: one
        receive over the whole batch and one payload decode chain over all
        frames. Raises DvbTRxError if any frame's TPS or payload fails."""
        cp_len = guard_cp_len_2k(self.params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[self.params.link.constellation]
        iq = _as_iq(iq_batch, self.device)
        if iq.dim() != 2:
            raise ValueError("iq_batch must be (B, n)")
        if iq.shape[1] < n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)
        llrs, cells = receive_frame_body(iq[:, : n_symbols * sps], n_symbols,
                                         cp_len, self.rx_window_backoff,
                                         vbits)
        cells = cells.cpu().numpy()
        words = []
        for b in range(iq.shape[0]):
            tps = _tps_word(cells[b], n_symbols)
            if tps is None:
                raise DvbTRxError(DvbTRxError.TPS_DECODE)
            words.append(tps)
        return self._decode_payloads(llrs.reshape(iq.shape[0], -1),
                                     payload_len, words)

    def _decode_payloads(self, llrs: torch.Tensor, payload_len: int,
                         words) -> List[DvbTRxFrame]:
        inner = self.params.inner()
        n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
        ts_len = n_ts * TS_PACKET_LEN
        plan = block_plan(ts_len, "none", dvb_t_frame_outer(), inner,
                          dvb_t_frame_outer_il(), InterleaverKind.none())
        if llrs.shape[1] < plan.coded_bits:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
        datas, oks = decode_chain_batch(
            llrs, plan, "none", dvb_t_frame_outer(), inner,
            dvb_t_frame_outer_il(), InterleaverKind.none(),
            ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, [0] * len(words))
        out = []
        for ts, ok, tps in zip(datas, oks, words):
            if ts is None or not ok or len(ts) < ts_len:
                raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
            payload = ts_depacketize(ts_energy_disperse(ts[:ts_len]))
            if payload is None:
                raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
            out.append(DvbTRxFrame(payload=payload[:payload_len], tps=tps))
        return out


# ── receivers outside the port so far ────────────────────────────────────────


def dvb_t_blind_decode(iq, max_symbols: int = 272):
    raise not_ported("dvb_t_blind_decode", DVB_T_BLIND)


class DvbTHierFrameDemod:
    def __init__(self, *args, **kwargs) -> None:
        raise not_ported("DvbTHierFrameDemod", DVB_T_HIER)


class DvbTSuperFrameDemod:
    def __init__(self, *args, **kwargs) -> None:
        raise not_ported("DvbTSuperFrameDemod", DVB_T_SUPER_FRAME)


class DvbTFrameStreamDemod:
    def __init__(self, *args, **kwargs) -> None:
        raise not_ported("DvbTFrameStreamDemod", DVB_T_STREAM)


class DvbTBandStreamDemod:
    def __init__(self, *args, **kwargs) -> None:
        raise not_ported("DvbTBandStreamDemod", DVB_T_BAND)
