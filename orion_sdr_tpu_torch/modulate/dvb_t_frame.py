"""Conformant DVB-T frame modulator (counterpart of
``orion_sdr_tpu/modulate/dvb_t_frame.py``; ETSI EN 300 744). Preamble-less:
TS packets + energy dispersal → RS(204,188) + Forney I=12 + K=7 conv →
Figure-9a mapping through the four-phase scattered-pilot grid → TPS DBPSK
on the 17 reserved carriers → IFFT + CP.

The byte stages run on the host; the inner code, mapping, grid scatter and
one (n_sym, 2048) IFFT run on the modulator's device, then the optional TX
lowpass over the whole frame. ``DvbTHierFrameMod`` carries two transport
streams per frame (§4.3.5/§5.1).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..constellation import BITS_PER_SYMBOL
from ..frame.chain import block_plan, encode_chain
from ..frame.types import InterleaverKind, ScramblerKind, SCRAMBLER_BEFORE_OUTER
from ..multicarrier import TxLowpass, ofdm_assemble, symbol_taper
from ..waveform.dvb_t import (
    DVB_T_N_FFT, DVB_T_KMAX, DVB_T_DATA_CARRIERS, DvbTFrameParams,
    DvbTHierFrameParams,
    guard_cp_len_2k,
    dvb_t_map_symbols, scattered_map_frame, tps_carrier_bins,
    dvb_t_frame_outer, dvb_t_frame_outer_il,
)
from ..waveform.dvb_t_tps import tps_encode_frame, TPS_SYMBOLS_PER_FRAME
from ..waveform.dvb_t_ts import (
    TS_PACKET_LEN, ts_packetize, ts_stuff_null_packets, ts_energy_disperse,
)


class DvbTFrame(NamedTuple):
    """Modulated frame (numpy complex64 IQ) + the numerology a receiver
    needs."""
    iq: np.ndarray
    n_symbols: int
    samples_per_symbol: int


def tx_lowpass_for_2k(num_taps: int, stopband_db: float) -> TxLowpass:
    """Spectral mask sized for the 2K band edge (active ±852 of 2048)."""
    return TxLowpass.for_null_band(DVB_T_N_FFT, DVB_T_KMAX // 2, num_taps,
                                   stopband_db)


def _coded_bits_for_stream(n_pkt: int, inner) -> int:
    """Coded bits of ``n_pkt`` transport packets through RS(204,188),
    Forney and the inner code ``inner``."""
    return block_plan(n_pkt * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                      inner, dvb_t_frame_outer_il(),
                      InterleaverKind.none()).coded_bits


def _coded_bits_for_packets(n_pkt: int, params: DvbTFrameParams) -> int:
    return _coded_bits_for_stream(n_pkt, params.inner())


def _as_bytes(payload) -> np.ndarray:
    if isinstance(payload, (bytes, bytearray)):
        return np.frombuffer(bytes(payload), np.uint8)
    return np.asarray(payload, np.uint8)


class DvbTFrameMod:
    """One-frame-per-call DVB-T modulator on ``device``; ``window_roll_off``
    tapers each symbol's edges (raised cosine, 0 = off) and ``tx_lowpass``
    masks the whole frame."""

    def __init__(self, params: DvbTFrameParams, window_roll_off: int = 0,
                 tx_lowpass: Optional[TxLowpass] = None, *,
                 device="cuda") -> None:
        self.params = params
        self.window_roll_off = window_roll_off
        self.tx_lowpass = tx_lowpass
        self.device = torch.device(device)

    def with_symbol_window(self, roll_off: int) -> "DvbTFrameMod":
        return DvbTFrameMod(self.params, roll_off, self.tx_lowpass,
                            device=self.device)

    def with_tx_lowpass(self, lowpass: TxLowpass) -> "DvbTFrameMod":
        return DvbTFrameMod(self.params, self.window_roll_off, lowpass,
                            device=self.device)

    def modulate(self, payload) -> DvbTFrame:
        params = self.params
        cp_len = guard_cp_len_2k(params.link.guard)
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        bits_per_sym = DVB_T_DATA_CARRIERS * vbits

        # TS-packetize; the frame spans max(payload symbols, 68) so a whole
        # TPS block is present
        ts = ts_packetize(_as_bytes(payload))
        n_real = len(ts) // TS_PACKET_LEN
        payload_syms = -(-_coded_bits_for_packets(n_real, params)
                         // bits_per_sym)
        n_symbols = max(payload_syms, TPS_SYMBOLS_PER_FRAME)

        # null-packet stuffing until the coded stream fills every data
        # carrier, then energy dispersal over the whole TS stream
        capacity_bits = n_symbols * bits_per_sym
        target = max(n_real, 1)
        while _coded_bits_for_packets(target, params) < capacity_bits:
            target += 1
        ts = ts_energy_disperse(ts_stuff_null_packets(ts, target))

        # payload FEC: no CRC, no extra scrambler (dispersal was TS-keyed)
        coded = encode_chain(ts, "none", dvb_t_frame_outer(), params.inner(),
                             dvb_t_frame_outer_il(), InterleaverKind.none(),
                             ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0,
                             device=self.device)
        cells = tps_encode_frame(params.tps_word().pack())      # (68, 17)
        reps = -(-n_symbols // TPS_SYMBOLS_PER_FRAME)
        cells_all = np.tile(cells, (reps, 1))[:n_symbols]
        iq = assemble_frame(coded[:capacity_bits], cells_all, vbits,
                            n_symbols, cp_len, self.window_roll_off)
        if self.tx_lowpass is not None:
            iq = self.tx_lowpass.apply(iq)
        return DvbTFrame(iq=iq.cpu().numpy(), n_symbols=n_symbols,
                         samples_per_symbol=DVB_T_N_FFT + cp_len)


def assemble_frame(coded_bits: torch.Tensor, tps_cells: np.ndarray,
                   vbits: int, n_symbols: int, cp_len: int,
                   window_roll_off: int, alpha: int = 1) -> torch.Tensor:
    """Map → scatter (rotating grid) → TPS overwrite → IFFT + CP (+ taper),
    on the coded bits' device → (n_symbols·(2048 + cp_len),) complex64."""
    data = dvb_t_map_symbols(coded_bits, vbits, alpha)
    freq = scattered_map_frame(data.reshape(n_symbols, DVB_T_DATA_CARRIERS))
    dev = freq.device
    freq[:, torch.as_tensor(tps_carrier_bins(), device=dev)] = \
        torch.as_tensor(tps_cells, device=dev)
    taper = symbol_taper(DVB_T_N_FFT + cp_len, window_roll_off) \
        if window_roll_off else None
    return ofdm_assemble(freq, cp_len, taper=taper)


# ── hierarchical transmission (§4.3.5/§5.1) ──────────────────────────────────


def _prepare_stream(payload, inner, capacity_bits: int,
                    device) -> torch.Tensor:
    """TS-packetize → null-stuff to the capacity → energy dispersal → RS +
    Forney + conv encode; exactly ``capacity_bits`` coded bits on
    ``device``."""
    ts = ts_packetize(_as_bytes(payload))
    target = max(len(ts) // TS_PACKET_LEN, 1)
    while _coded_bits_for_stream(target, inner) < capacity_bits:
        target += 1
    ts = ts_energy_disperse(ts_stuff_null_packets(ts, target))
    coded = encode_chain(ts, "none", dvb_t_frame_outer(), inner,
                         dvb_t_frame_outer_il(), InterleaverKind.none(),
                         ScramblerKind.none(), SCRAMBLER_BEFORE_OUTER, 0,
                         device=device)
    return coded[:capacity_bits]


class DvbTHierFrameMod:
    """Hierarchical DVB-T modulator on ``device``: the HP stream rides the 2
    quadrant MSBs of a (non-uniform, α) 16-/64-QAM cell, the LP stream the
    other v−2 bits, each with its own RS(204,188) + Forney + K=7 inner
    code."""

    def __init__(self, params: DvbTHierFrameParams, window_roll_off: int = 0,
                 tx_lowpass: Optional[TxLowpass] = None, *,
                 device="cuda") -> None:
        self.params = params
        self.window_roll_off = window_roll_off
        self.tx_lowpass = tx_lowpass
        self.device = torch.device(device)

    def with_symbol_window(self, roll_off: int) -> "DvbTHierFrameMod":
        return DvbTHierFrameMod(self.params, roll_off, self.tx_lowpass,
                                device=self.device)

    def with_tx_lowpass(self, lowpass: TxLowpass) -> "DvbTHierFrameMod":
        return DvbTHierFrameMod(self.params, self.window_roll_off, lowpass,
                                device=self.device)

    def modulate(self, hp_payload, lp_payload) -> DvbTFrame:
        params = self.params
        params.link.validate()
        cp_len = guard_cp_len_2k(params.link.guard)
        vbits = BITS_PER_SYMBOL[params.link.constellation]
        hp_per_sym = DVB_T_DATA_CARRIERS * 2
        lp_per_sym = DVB_T_DATA_CARRIERS * (vbits - 2)

        def syms_for(payload, inner, per_sym):
            n_pkt = len(ts_packetize(_as_bytes(payload))) // TS_PACKET_LEN
            return -(-_coded_bits_for_stream(n_pkt, inner) // per_sym)

        n_symbols = max(syms_for(hp_payload, params.inner_hp(), hp_per_sym),
                        syms_for(lp_payload, params.inner_lp(), lp_per_sym),
                        TPS_SYMBOLS_PER_FRAME)
        hp = _prepare_stream(hp_payload, params.inner_hp(),
                             n_symbols * hp_per_sym, self.device)
        lp = _prepare_stream(lp_payload, params.inner_lp(),
                             n_symbols * lp_per_sym, self.device)
        # multiplex: per cell [hp0, hp1, lp0..lp(v−3)] = y0..y(v−1)
        n_cells = n_symbols * DVB_T_DATA_CARRIERS
        bits = torch.cat([hp.reshape(n_cells, 2),
                          lp.reshape(n_cells, vbits - 2)], dim=-1).reshape(-1)
        cells = tps_encode_frame(params.tps_word().pack())
        reps = -(-n_symbols // TPS_SYMBOLS_PER_FRAME)
        cells_all = np.tile(cells, (reps, 1))[:n_symbols]
        iq = assemble_frame(bits, cells_all, vbits, n_symbols, cp_len,
                            self.window_roll_off, params.link.alpha)
        if self.tx_lowpass is not None:
            iq = self.tx_lowpass.apply(iq)
        return DvbTFrame(iq=iq.cpu().numpy(), n_symbols=n_symbols,
                         samples_per_symbol=DVB_T_N_FFT + cp_len)
