"""Conformant DVB-T frame demodulator (counterpart of
``orion_sdr_tpu/demodulate/dvb_t_frame.py``). GI acquisition (van de Beek)
→ symbol FFT → TPS from the raw bins → scattered-pilot equalisation with
CSI weighting → Figure-9a soft LLRs → conv (Viterbi) + Forney + RS(204,188)
decode → un-disperse → depacketize.

The receive runs on the demodulator's device over whole frames, and
``decode_batch`` over the whole batch of frames in one call; all frames'
payloads then go through one ``decode_chain_batch``, so one Viterbi launch
covers every frame's chunks. TPS, Forney, RS and the TS layer run on the
host. ``decode_batch`` is the root ``orion.dvbt.decode_batch`` (``obs``):
spans ``orion.dvbt.receive`` (symbol FFT, pilot estimate, LLRs and the TPS
cells' read), ``orion.dvbt.tps`` (the per-frame TPS words) and
``orion.dvbt.ts`` (energy dispersal and depacketizing), counters
``dvbt.frames``, ``dvbt.tps_fail`` and ``dvbt.ts_packets``, and the chain's
own spans inside. ``DvbTHierFrameDemod`` splits each cell's LLRs into the
HP and LP streams on the device and decodes each through its own chain;
``dvb_t_blind_decode`` finds guard, TPS (hierarchy included) and payload
extent from the signal alone.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import obs
from ..dsp.device import takes_host_data
from ..constellation import BITS_PER_SYMBOL
from ..dsp.osc import rotate_host
from ..frame.chain import block_plan, decode_chain_batch
from ..frame.types import (InnerFec, InterleaverKind, ScramblerKind,
                           SCRAMBLER_BEFORE_OUTER)
from ..multicarrier import symbol_fft
from ..ofdm import channel_estimate_pilots, zf_equalize
from ..sync.dvb_t_gi_sync import dvb_t_gi_sync, dvb_t_integer_cfo
from ..waveform.dvb_t import (
    DVB_T_N_FFT, DVB_T_DATA_CARRIERS, DVB_T_SCATTERED_PHASES, DvbTFrameParams,
    DvbTHierFrameParams, DvbTHierLinkParams, GUARD_INTERVALS, _phase_symbols,
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


@takes_host_data("freq")
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


@takes_host_data("freq")
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
                 rx_window_backoff: int = 0, *,
                 device="cuda") -> None:
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
        """The rate the GI acquisition's and the integer CFO correction's
        frequency units assume (that of a 1 MHz occupied band). Only those
        units use it: the receive itself works in samples and FFT bins at
        any capture rate."""
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

    @obs.rooted("orion.dvbt.decode_batch")
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
        obs.count("dvbt.frames", iq.shape[0])
        with obs.span("orion.dvbt.receive"):
            llrs, cells = receive_frame_body(iq[:, : n_symbols * sps],
                                             n_symbols, cp_len,
                                             self.rx_window_backoff, vbits)
            cells = obs.to_host(cells)
        with obs.span("orion.dvbt.tps"):
            words = [_tps_word(c, n_symbols) for c in cells]
        failed = sum(w is None for w in words)
        obs.count("dvbt.tps_fail", failed)
        if failed:
            raise DvbTRxError(DvbTRxError.TPS_DECODE)
        return self._decode_payloads(llrs.reshape(iq.shape[0], -1),
                                     payload_len, words)

    def _decode_payloads(self, llrs: torch.Tensor, payload_len: int,
                         words) -> List[DvbTRxFrame]:
        out = []
        for payload, tps in zip(_decode_ts(llrs, self.params.inner(),
                                           payload_len), words):
            if payload is None:
                raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
            out.append(DvbTRxFrame(payload=payload, tps=tps))
        return out


def _ts_plan(n_ts: int, inner):
    return block_plan(n_ts * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      inner, dvb_t_frame_outer_il(), InterleaverKind.none())


def _decode_ts_chain(llrs: torch.Tensor, inner, n_ts: int):
    """(B, ≥ coded) LLRs of a stream of ``n_ts`` transport packets → B
    energy-undispersed TS byte streams, None where the FEC failed. One
    ``decode_chain_batch``, so one Viterbi launch for all rows."""
    plan = _ts_plan(n_ts, inner)
    ts_len = n_ts * TS_PACKET_LEN
    if llrs.shape[1] < plan.coded_bits:
        return [None] * llrs.shape[0]
    datas, oks = decode_chain_batch(
        llrs, plan, "none", dvb_t_frame_outer(), inner,
        dvb_t_frame_outer_il(), InterleaverKind.none(),
        ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, [0] * llrs.shape[0])
    with obs.span("orion.dvbt.ts"):
        return [ts_energy_disperse(ts[:ts_len])
                if ts is not None and ok and len(ts) >= ts_len else None
                for ts, ok in zip(datas, oks)]


def _decode_ts(llrs: torch.Tensor, inner, payload_len: int
               ) -> List[Optional[np.ndarray]]:
    """(B, L) LLRs → B payloads of ``payload_len`` bytes, None where the
    FEC or the TS layer failed."""
    n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
    streams = _decode_ts_chain(llrs, inner, n_ts)
    with obs.span("orion.dvbt.ts"):
        out = []
        for ts in streams:
            payload = None if ts is None else ts_depacketize(ts)
            out.append(None if payload is None else payload[:payload_len])
    if obs.recording():
        obs.count("dvbt.ts_packets", n_ts * sum(p is not None for p in out))
    return out


def _tps_cells_only(seg: torch.Tensor, n_symbols: int,
                    cp_len: int) -> torch.Tensor:
    """Symbol FFT → raw TPS-carrier cells, for the blind TPS alignment
    before the constellation is known."""
    freq = symbol_fft(seg, DVB_T_N_FFT, cp_len, n_symbols=n_symbols)
    return freq[..., torch.as_tensor(tps_carrier_bins(), device=freq.device)]


class DvbTBlindFrame(NamedTuple):
    """Blind receive result: the transport payload (null stuffing stripped;
    the zero padding of the last real packet kept, since the TS layer
    carries no finer length), the signalled parameters, and the LP payload
    when the TPS announced hierarchy."""
    payload: np.ndarray
    tps: TpsWord
    guard: str
    n_symbols: int
    lp_payload: Optional[np.ndarray] = None


def _strip_null_packets(ts: np.ndarray) -> np.ndarray:
    rows = ts.reshape(-1, TS_PACKET_LEN)
    real = ~((rows[:, 1] == 0x1F) & (rows[:, 2] == 0xFF))
    return rows[real][:, 1:].reshape(-1).copy()


def _blind_coded_bits(n_ts: int, inner) -> int:
    return _ts_plan(n_ts, inner).coded_bits


def _blind_stream(llrs: torch.Tensor, inner, capacity: int):
    """Decode the largest whole-packet TS prefix that fits ``capacity``
    coded bits of a 1-D LLR tensor, un-disperse, check every sync byte and
    strip the null packets; None on failure."""
    n_ts = 1
    while _blind_coded_bits(n_ts + 1, inner) <= capacity:
        n_ts += 1
    if _blind_coded_bits(n_ts, inner) > capacity:
        return None
    ts = _decode_ts_chain(llrs[None], inner, n_ts)[0]
    if ts is None:
        return None
    ts = np.asarray(ts, np.uint8)
    if not np.all(ts.reshape(-1, TS_PACKET_LEN)[:, 0] == 0x47):
        return None
    return _strip_null_packets(ts)


def dvb_t_blind_decode(iq, max_symbols: int = 272, *,
                       device="cuda") -> DvbTBlindFrame:
    """Fully blind DVB-T 2K receive on ``device``: try all four guard
    intervals on the GI metric, align the TPS block by its sync word,
    configure the FEC chain from the decoded TPS (hierarchy included), and
    recover the transport payload, whose extent comes from the TS layer
    itself (null packets stripped). The capture stays on the device."""
    iq = _as_iq(iq, device)
    fs = dvb_t_fs_for_bandwidth(1_000_000.0)
    n = iq.shape[-1]
    best = None
    for guard, cp_len in GUARD_INTERVALS.items():
        sps = DVB_T_N_FFT + cp_len
        if n < sps * 5:
            continue
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fs, sps)
        if acq is not None and (best is None or acq.score > best[2].score):
            best = (guard, cp_len, acq)
    if best is None:
        raise DvbTRxError(DvbTRxError.ACQUISITION)
    guard, cp_len, acq = best
    sps = DVB_T_N_FFT + cp_len
    start = acq.start_sample
    avail = (n - start) // sps
    if avail < TPS_SYMBOLS_PER_FRAME:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)

    # TPS alignment: slide a 68-symbol window until the word decodes
    probe = min(avail, 2 * TPS_SYMBOLS_PER_FRAME + 4)
    cells = _tps_cells_only(iq[start: start + probe * sps], probe,
                            cp_len).cpu().numpy()
    tps, frame_off = None, None
    for off in range(0, probe - TPS_SYMBOLS_PER_FRAME + 1):
        tps = TpsWord.unpack(tps_decode_frame(
            cells[off: off + TPS_SYMBOLS_PER_FRAME]))
        if tps is not None:
            frame_off = off
            break
    if tps is None:
        raise DvbTRxError(DvbTRxError.TPS_DECODE)

    fstart = start + frame_off * sps
    n_symbols = (n - fstart) // sps
    n_symbols = max((n_symbols // 4) * 4, TPS_SYMBOLS_PER_FRAME)
    n_symbols = min(n_symbols, max_symbols)
    if (n - fstart) // sps < n_symbols:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)
    vbits = BITS_PER_SYMBOL[tps.constellation]
    seg = iq[fstart: fstart + n_symbols * sps]
    # capacity candidates: the whole capture (one long frame), else the
    # largest 68-multiple, else one 68-symbol frame: a capture may hold
    # several frames whose coded streams each restart, so a failure retries
    # over a shorter symbol prefix of the same LLR stream
    cands = []
    for c in (n_symbols, (n_symbols // TPS_SYMBOLS_PER_FRAME)
              * TPS_SYMBOLS_PER_FRAME, TPS_SYMBOLS_PER_FRAME):
        if c >= TPS_SYMBOLS_PER_FRAME and c not in cands:
            cands.append(c)

    if tps.hierarchy:
        link = DvbTHierLinkParams(
            guard=guard, constellation=tps.constellation, alpha=tps.hierarchy,
            code_rate_hp=tps.code_rate_hp,
            code_rate_lp=tps.code_rate_lp or tps.code_rate_hp)
        params = DvbTHierFrameParams(link=link)
        llrs, _ = receive_frame_body(seg, n_symbols, cp_len, 0, vbits,
                                     link.alpha)
        per_cell = llrs.reshape(n_symbols, -1, vbits)
        for c in cands:
            hp = _blind_stream(per_cell[:c, :, :2].reshape(-1),
                               params.inner_hp(), c * DVB_T_DATA_CARRIERS * 2)
            if hp is None:
                continue
            lp = _blind_stream(per_cell[:c, :, 2:].reshape(-1),
                               params.inner_lp(),
                               c * DVB_T_DATA_CARRIERS * (vbits - 2))
            return DvbTBlindFrame(payload=hp, tps=tps, guard=guard,
                                  n_symbols=c, lp_payload=lp)
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)

    inner = InnerFec.convolutional(tps.code_rate_hp, "dvb_k7")
    llrs = receive_frame_body(seg, n_symbols, cp_len, 0, vbits)[0]
    for c in cands:
        payload = _blind_stream(llrs[:c].reshape(-1), inner,
                                c * DVB_T_DATA_CARRIERS * vbits)
        if payload is not None:
            return DvbTBlindFrame(payload=payload, tps=tps, guard=guard,
                                  n_symbols=c)
    raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)


# ── hierarchical receive (§4.3.5/§5.1) ───────────────────────────────────────


class DvbTHierRxFrame(NamedTuple):
    """Hierarchical receive result: HP always present (decode raises when
    the HP stream fails: the frame is then useless); LP is None when its
    FEC failed but HP survived, the graceful degradation hierarchy exists
    to provide."""
    hp_payload: np.ndarray
    lp_payload: Optional[np.ndarray]
    tps: TpsWord


class DvbTHierFrameDemod:
    """Hierarchical frame demodulator on ``device``: one receive computes
    the non-uniform-grid LLRs of every cell; the HP (quadrant MSBs) and LP
    (remaining bits) LLR planes are split on the device and decode through
    their own RS + Forney + K=7 chains."""

    def __init__(self, params: DvbTHierFrameParams,
                 rx_window_backoff: int = 0, *,
                 device="cuda") -> None:
        self.params = params
        self.rx_window_backoff = rx_window_backoff
        self.device = torch.device(device)

    def with_rx_window_backoff(self, backoff: int) -> "DvbTHierFrameDemod":
        return DvbTHierFrameDemod(self.params, backoff, device=self.device)

    @property
    def fs(self) -> float:
        return dvb_t_fs_for_bandwidth(1_000_000.0)

    def decode(self, iq, n_symbols: int, hp_payload_len: int,
               lp_payload_len: int) -> DvbTHierRxFrame:
        """One hierarchical frame at an unknown offset in a 1-D capture."""
        params = self.params
        params.link.validate()
        cp_len = guard_cp_len_2k(params.link.guard)
        sps = DVB_T_N_FFT + cp_len
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        iq = _as_iq(iq, self.device)
        acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, self.fs, sps)
        if acq is None:
            raise DvbTRxError(DvbTRxError.ACQUISITION)
        start = acq.start_sample
        if iq.shape[-1] < start + n_symbols * sps:
            raise DvbTRxError(DvbTRxError.INCOMPLETE)
        llrs, cells = receive_frame_body(iq[start: start + n_symbols * sps],
                                         n_symbols, cp_len,
                                         self.rx_window_backoff, vbits,
                                         params.link.alpha)
        tps = _tps_word(cells.cpu().numpy(), n_symbols)
        if tps is None:
            raise DvbTRxError(DvbTRxError.TPS_DECODE)
        # demultiplex each cell's vbits LLRs into the two priority planes
        per_cell = llrs.reshape(-1, vbits)
        hp = _decode_ts(per_cell[:, :2].reshape(1, -1), params.inner_hp(),
                        hp_payload_len)[0]
        if hp is None:
            raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
        lp = _decode_ts(per_cell[:, 2:].reshape(1, -1), params.inner_lp(),
                        lp_payload_len)[0]
        return DvbTHierRxFrame(hp_payload=hp, lp_payload=lp, tps=tps)
