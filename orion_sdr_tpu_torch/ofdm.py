"""OFDM waveform: config, whole-frame modulation, ZF equalization, channel
estimate denoising and pilot interpolation (counterpart of the parts of
``orion_sdr_tpu/ofdm.py`` that the coded frame link and the DVB-T frame
link use).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .constellation import bits_per_symbol
from .multicarrier import CarrierPlan, CarrierGrid, map_bits_grid, \
    ofdm_assemble, symbol_taper
from .dsp.osc import rotate
from .unported import RX_EXTRAS, TX_LOWPASS, not_ported

EQUALIZER_FLOOR = 1e-6  # |h|² floor in ZF division


@dataclass(frozen=True)
class OfdmConfig:
    """OFDM waveform config including the frame-layer fields, all defaulted
    off (same fields as the JAX package's ``OfdmConfig``)."""

    carrier_plan: CarrierPlan
    fs: float
    rf_hz: float = 0.0
    gain: float = 1.0
    constellation: str = "qpsk"
    equalizer_method: str = "training_symbol"
    phase_tracking: str = "off"
    rx_window_backoff: int = 0
    tx_lowpass: Optional[object] = None
    outer_fec: object = None             # frame.types.OuterFec
    inner_fec: object = None             # frame.types.InnerFec
    outer_interleaver: object = None     # frame.types.InterleaverKind
    inner_interleaver: object = None
    header_format: str = "orion_sdr"
    payload_crc: str = "crc32"
    header_crc: str = "crc16"
    scrambler: object = None             # frame.types.ScramblerKind
    scrambler_pos: str = "before_outer_fec"
    ldpc_decode_rule: str = "sum_product"
    dvb_t_scattered: bool = False
    transform_precoding: bool = False

    def __post_init__(self):
        from .frame.types import (InterleaverKind, ScramblerKind, OuterFec,
                                  InnerFec)
        for name, default in (("outer_fec", OuterFec.none()),
                              ("inner_fec", InnerFec.none()),
                              ("outer_interleaver", InterleaverKind.none()),
                              ("inner_interleaver", InterleaverKind.none()),
                              ("scrambler", ScramblerKind.none())):
            if getattr(self, name) is None:
                object.__setattr__(self, name, default)

    def with_fs(self, fs: float):
        return replace(self, fs=fs)

    def with_outer_fec(self, outer_fec):
        return replace(self, outer_fec=outer_fec)

    def with_inner_fec(self, inner_fec):
        return replace(self, inner_fec=inner_fec)

    def with_outer_interleaver(self, il):
        return replace(self, outer_interleaver=il)

    def with_inner_interleaver(self, il):
        return replace(self, inner_interleaver=il)

    def with_header_format(self, fmt: str):
        return replace(self, header_format=fmt)

    def with_payload_crc(self, crc: str):
        return replace(self, payload_crc=crc)

    def with_header_crc(self, crc: str):
        return replace(self, header_crc=crc)

    def with_scrambler(self, s):
        return replace(self, scrambler=s)

    def with_scrambler_pos(self, pos: str):
        return replace(self, scrambler_pos=pos)

    def with_ldpc_decode_rule(self, rule: str):
        return replace(self, ldpc_decode_rule=rule)

    def with_dvb_t_scattered(self, scattered: bool = True):
        return replace(self, dvb_t_scattered=scattered)

    def with_transform_precoding(self, enable: bool = True):
        return replace(self, transform_precoding=enable)

    def with_rx_window_backoff(self, backoff: int):
        return replace(self, rx_window_backoff=backoff)

    def with_equalizer_method(self, method: str):
        return replace(self, equalizer_method=method)

    def with_phase_tracking(self, method: str):
        return replace(self, phase_tracking=method)

    def with_tx_lowpass(self, lowpass):
        return replace(self, tx_lowpass=lowpass)

    def with_tx_lowpass_null_band(self, num_taps: int, stopband_db: float):
        raise not_ported("the TX lowpass", TX_LOWPASS)

    def with_symbol_window(self, roll_off: int):
        """TX symbol windowing: ``roll_off``-sample raised-cosine taper per
        symbol edge; 0 disables."""
        return replace(self, carrier_plan=self.carrier_plan
                       .with_window_roll_off(roll_off))

    def with_symbol_window_beta_guard(self, beta: float):
        cp_len = self.carrier_plan.cp_len
        return self.with_symbol_window(
            int(round(min(max(beta, 0.0), 0.5) * cp_len)))

    def with_symbol_window_beta_tu(self, beta: float):
        n_fft = self.carrier_plan.n_fft
        roll_off = int(round(max(beta, 0.0) * n_fft))
        sym = n_fft + self.carrier_plan.cp_len
        return self.with_symbol_window(min(roll_off, sym // 2))

    def bits_per_ofdm_symbol(self) -> int:
        return self.carrier_plan.num_data_carriers() * \
            bits_per_symbol(self.constellation)

    def samples_per_ofdm_symbol(self) -> int:
        return self.carrier_plan.n_fft + self.carrier_plan.cp_len

    def grid(self) -> CarrierGrid:
        return CarrierGrid(self.carrier_plan)


def ofdm_mod(cfg: OfdmConfig, bits: torch.Tensor, phase0: float = 0.0):
    """bits (..., n_bits) → IQ for whole frames on the bits' device. The
    bit count is zero-padded up to a whole number of OFDM symbols; the
    plan's symbol-window taper applies. Returns (iq complex64, phase)."""
    if cfg.tx_lowpass is not None:
        raise not_ported("the TX lowpass", TX_LOWPASS)
    if cfg.transform_precoding:
        raise not_ported("DFT precoding", RX_EXTRAS)
    g = cfg.grid()
    bps = cfg.bits_per_ofdm_symbol()
    n_sym = -(-bits.shape[-1] // bps)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    freq = map_bits_grid(g, bits, cfg.constellation)
    taper = symbol_taper(cfg.samples_per_ofdm_symbol(),
                         cfg.carrier_plan.window_roll_off)
    t = ofdm_assemble(freq, cfg.carrier_plan.cp_len, taper=taper) * cfg.gain
    if cfg.rf_hz != 0.0:
        t, phase0 = rotate(t, cfg.rf_hz, cfg.fs, phase0)
    return t.to(torch.complex64), phase0


def zf_equalize(freq_syms: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Per-bin zero-forcing: x·conj(h)/max(|h|², 1e−6)."""
    mag2 = torch.clamp(estimate.abs() ** 2, min=EQUALIZER_FLOOR)
    return (freq_syms * torch.conj(estimate) / mag2).to(torch.complex64)


def channel_estimate_denoise(estimate: torch.Tensor, cp_len: int,
                             backoff: int = 0, timing_slop: int = 4
                             ) -> torch.Tensor:
    """Delay-domain denoising of a per-bin channel estimate: IFFT, keep taps
    [0, cp_len + backoff] plus ``timing_slop`` wraparound taps, FFT back.
    Exactly transparent for any channel whose response fits the guard."""
    h = torch.fft.ifft(estimate.to(torch.complex128), dim=-1)
    n_fft = h.shape[-1]
    keep_hi = min(int(cp_len) + int(backoff) + 1, n_fft)
    idx = torch.arange(n_fft, device=h.device)
    keep = (idx < keep_hi) | (idx >= n_fft - int(timing_slop))
    h = torch.where(keep, h, torch.zeros_like(h))
    return torch.fft.fft(h, dim=-1).to(torch.complex64)


@lru_cache(maxsize=64)
def _pilot_interp_matrix(pb_key: tuple, n_fft: int,
                         device: str) -> torch.Tensor:
    """(n_pilots, n_fft) linear-interpolation weights for sorted constant
    pilot bins, holding the edge values outside them, on ``device``."""
    pb = np.asarray(pb_key, np.float64)
    W = np.zeros((len(pb), n_fft), np.float32)
    for b in range(n_fft):
        r = int(np.searchsorted(pb, b, side="left"))
        if r == 0:
            W[0, b] = 1.0
        elif r >= len(pb):
            W[-1, b] = 1.0
        elif pb[r] == b:
            W[r, b] = 1.0
        else:
            t = (b - pb[r - 1]) / (pb[r] - pb[r - 1])
            W[r - 1, b] = 1.0 - t
            W[r, b] = t
    return torch.as_tensor(W, device=device)


def channel_estimate_pilots(freq_syms: torch.Tensor, pilot_bins, pilot_values,
                            n_fft: int) -> torch.Tensor:
    """Per-symbol pilot interpolation: linear complex interpolation between
    the bin-sorted known-vs-received pilot ratios, edge hold. ``freq_syms``:
    (..., n_sym, n_fft); ``pilot_bins``/``pilot_values``: constant 1-D numpy
    arrays. Returns the (..., n_sym, n_fft) complex64 channel estimate as
    two float32 products with an interpolation matrix, TF32 off (full
    float32, as the JAX package's ``Precision.HIGHEST``)."""
    if not (isinstance(pilot_bins, np.ndarray) and pilot_bins.ndim == 1):
        raise not_ported("per-symbol pilot layouts in channel_estimate_pilots",
                         RX_EXTRAS)
    dev = freq_syms.device
    order = np.argsort(pilot_bins, kind="stable")
    pb_s = pilot_bins[order]
    W = _pilot_interp_matrix(tuple(int(b) for b in pb_s), int(n_fft),
                             str(dev))
    pv_s = torch.as_tensor(np.asarray(pilot_values)[order].astype(np.complex64),
                           device=dev)
    ratio = freq_syms[..., torch.as_tensor(pb_s, device=dev)] / pv_s
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        est = torch.complex(torch.matmul(ratio.real.contiguous(), W),
                            torch.matmul(ratio.imag.contiguous(), W))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return est.to(torch.complex64)


class OfdmRxFrame(NamedTuple):
    """Per-packet diagnostics."""
    bits: np.ndarray
    num_symbols: int
    evm_db: Optional[float]
    cfo_hz: Optional[float] = None
    timing_offset_samples: Optional[int] = None
    channel_mse: Optional[float] = None
