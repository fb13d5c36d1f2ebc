"""OFDM waveform: config, whole-frame modulation (TX lowpass, DFT-s-OFDM
transform precoding and caller pilots included), the generic receive
(symbol FFT, ZF or LMMSE one-tap equalization, grid extraction, hard and
soft decisions, EVM), training-symbol and pilot channel estimates,
estimate denoising and common-phase-error tracking (counterpart of
``orion_sdr_tpu/ofdm.py``).

Every entry point takes host data or tensors; ``device`` None keeps a
tensor where it is and sends host data to the card ("cuda"). A frame is
one batched op over (..., n_symbols, n_fft).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import lru_cache
from typing import NamedTuple, Optional

import numpy as np
import torch

from .constellation import BITS_PER_SYMBOL, bits_per_symbol, decide, \
    map_bits, soft_llr
from .multicarrier import CarrierPlan, CarrierGrid, TxLowpass, grid_extract, \
    grid_map, map_bits_grid, ofdm_assemble, symbol_fft, symbol_taper
from .dsp.device import full_f32, on_device, takes_host_data
from .dsp.osc import rotate

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
    tx_lowpass: Optional[TxLowpass] = None
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
        """TX mask centred in the unoccupied band above the plan's edge."""
        return self.with_tx_lowpass(TxLowpass.for_null_band(
            self.carrier_plan.n_fft,
            self.carrier_plan.occupied_half_carriers(), num_taps,
            stopband_db))

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

    def validate(self) -> None:
        """Raise ValueError (CarrierPlanError for the plan) on an invalid
        config: the plan, the rate, the constellation, the equalizer and
        phase tracking names, the window backoff, precoding against the
        DVB-T mapping, the TX lowpass's transition, and the frame-layer
        fields (a per-frame scrambler seed needs a header block;
        interleaver dimensions; BCH t; RS (n, n_parity))."""
        plan = self.carrier_plan
        plan.validate()
        if self.fs <= 0.0:
            raise ValueError("fs must be positive")
        if self.constellation not in BITS_PER_SYMBOL:
            raise ValueError(f"unknown constellation {self.constellation!r}")
        if self.equalizer_method not in ("training_symbol", "pilot_interp"):
            raise ValueError(
                f"unknown equalizer {self.equalizer_method!r} "
                "(expected 'training_symbol' or 'pilot_interp')")
        if self.phase_tracking not in ("off", "cpe"):
            raise ValueError(
                f"unknown phase_tracking {self.phase_tracking!r} "
                "(expected 'off' or 'cpe')")
        if not 0 <= self.rx_window_backoff <= plan.cp_len:
            raise ValueError(
                "rx_window_backoff must be within the cyclic prefix")
        if self.transform_precoding and self.dvb_t_scattered:
            raise ValueError(
                "transform_precoding is not a DVB-T mechanism (EN 300 744 "
                "fixes the carrier mapping); disable one of the two")
        if self.transform_precoding and plan.num_data_carriers() < 2:
            raise ValueError("transform_precoding needs ≥2 data carriers")
        if self.tx_lowpass is not None and not self.tx_lowpass \
                .transition_fits(plan.n_fft, plan.occupied_half_carriers()):
            raise ValueError("tx_lowpass transition does not fit the null "
                             "band")
        from .frame.types import header_has_block
        if (getattr(self.scrambler, "kind", "none") == "additive"
                and getattr(self.scrambler, "seed_mode", "fixed")
                == "per_frame"
                and not header_has_block(self.header_format)):
            raise ValueError(
                "per-frame-random scrambler seed needs a header block to "
                "carry it to the receiver")
        for il in (self.outer_interleaver, self.inner_interleaver):
            kind = getattr(il, "kind", "none")
            if kind == "block" and (il.rows == 0 or il.cols == 0):
                raise ValueError("interleaver dimensions must be nonzero")
            if kind == "conv" and (il.branches == 0 or il.depth == 0):
                raise ValueError("interleaver dimensions must be nonzero")
        ofec = self.outer_fec
        okind = getattr(ofec, "kind", "none")
        if okind == "bch" and ofec.t == 0:
            raise ValueError("BCH t must be nonzero")
        if okind == "rs" and (ofec.n == 0 or ofec.n > 255
                              or ofec.n_parity == 0
                              or ofec.n_parity >= ofec.n
                              or ofec.n_parity % 2 != 0):
            raise ValueError("invalid Reed-Solomon (n, n_parity) config")


def carried_phase(phase0, device) -> torch.Tensor:
    """``phase0`` as the float32 tensor a rotation carries: the JAX
    package's jitted OFDM programs trace their phase argument, so XLA
    fuses p0 + w·k into one rounding, which :func:`~orion_sdr_tpu_torch.
    dsp.osc.rotate` reproduces for a tensor phase."""
    if isinstance(phase0, torch.Tensor):
        return phase0.to(device=device, dtype=torch.float32)
    return torch.tensor(np.float32(phase0), device=device)


@takes_host_data("syms")
def dft_precode(syms: torch.Tensor) -> torch.Tensor:
    """Unitary M-point DFT across the data-carrier axis (SC-FDMA TX
    spreading): X[k] = (1/√M)·Σₘ x[m]·e^(−2πi·mk/M)."""
    m = syms.shape[-1]
    return (torch.fft.fft(syms.to(torch.complex64), dim=-1)
            * np.float32(1.0 / np.sqrt(m))).to(torch.complex64)


@takes_host_data("syms")
def dft_deprecode(syms: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dft_precode` (RX despreading after the
    frequency-domain equalizer)."""
    m = syms.shape[-1]
    return (torch.fft.ifft(syms.to(torch.complex64), dim=-1)
            * np.float32(np.sqrt(m))).to(torch.complex64)


def ofdm_mod(cfg: OfdmConfig, bits, phase0: float = 0.0, pilot_bins=None,
             pilot_values=None, device=None):
    """bits (..., n_bits) → IQ for whole frames. The bit count is
    zero-padded up to a whole number of OFDM symbols; the plan's
    symbol-window taper and the config's TX lowpass apply, and with
    ``transform_precoding`` each symbol's data cells are DFT-spread before
    grid mapping. ``pilot_bins``/``pilot_values`` (numpy, (n_pilots,) or
    per symbol (n_sym, n_pilots)) replace the plan's own pilots; without
    them (and without precoding) mapping and placement are one fused
    gather. Returns (iq complex64 on the bits' device, phase)."""
    bits = on_device(bits, device)
    g = cfg.grid()
    bps = cfg.bits_per_ofdm_symbol()
    n_sym = -(-bits.shape[-1] // bps)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    if pilot_bins is None and pilot_values is None \
            and not cfg.transform_precoding:
        freq = map_bits_grid(g, bits, cfg.constellation)
    else:
        syms = map_bits(bits, cfg.constellation)
        syms = syms.reshape(syms.shape[:-1] + (n_sym, g.num_data_carriers))
        if cfg.transform_precoding:
            syms = dft_precode(syms)
        freq = grid_map(g, syms, pilot_bins=pilot_bins,
                        pilot_values=pilot_values)
    taper = symbol_taper(cfg.samples_per_ofdm_symbol(),
                         cfg.carrier_plan.window_roll_off)
    t = ofdm_assemble(freq, cfg.carrier_plan.cp_len, taper=taper) * cfg.gain
    if cfg.rf_hz != 0.0:
        t, phase0 = rotate(t, cfg.rf_hz, cfg.fs,
                           carried_phase(phase0, t.device))
    if cfg.tx_lowpass is not None:
        t = cfg.tx_lowpass.apply(t)
    return t.to(torch.complex64), phase0


@takes_host_data("freq_syms", "estimate")
def zf_equalize(freq_syms: torch.Tensor, estimate: torch.Tensor) -> torch.Tensor:
    """Per-bin zero-forcing: x·conj(h)/max(|h|², 1e−6)."""
    mag2 = torch.clamp(estimate.abs() ** 2, min=EQUALIZER_FLOOR)
    return (freq_syms * torch.conj(estimate) / mag2).to(torch.complex64)


@takes_host_data("freq_syms", "estimate")
def mmse_equalize(freq_syms: torch.Tensor, estimate: torch.Tensor,
                  noise_var: float) -> torch.Tensor:
    """Per-bin LMMSE: x·conj(h)/(|h|² + σ²), σ² the complex noise variance
    per frequency bin relative to unit-amplitude cells (``n_fft·σ²ₜ`` for
    time-domain AWGN of variance σ²ₜ through the unity-gain symbol FFT).
    Shrinks deep fades toward zero instead of amplifying their noise: the
    front end for waveforms whose later transform averages over bins
    (DFT-s-OFDM, OTFS)."""
    denom = estimate.abs() ** 2 + np.float32(max(noise_var,
                                                 EQUALIZER_FLOOR))
    return (freq_syms * torch.conj(estimate) / denom).to(torch.complex64)


def channel_estimate_training(rx_training_freq, known_freq,
                              device=None) -> torch.Tensor:
    """Training-symbol hold: h[bin] = rx[bin]/known[bin], on the received
    symbol's device."""
    rx = on_device(rx_training_freq, device, torch.complex64)
    known = on_device(known_freq, rx.device, torch.complex64)
    return (rx / known).to(torch.complex64)


@takes_host_data("estimate")
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


@takes_host_data("syms")
def cpe_raw_phases(syms: torch.Tensor, constellation: str) -> torch.Tensor:
    """Per-OFDM-symbol common-phase estimates, Viterbi & Viterbi style:
    ``syms`` (..., n_sym, n_data) equalized data cells → (..., n_sym)
    wrapped phases. BPSK: ∠(Σz²)/2 mod π; QPSK/QAM: ∠(−Σz⁴)/4 mod π/2."""
    z2 = syms * syms
    if constellation == "bpsk":
        return torch.angle(z2.sum(-1)) / 2.0
    return torch.angle(-(z2 * z2).sum(-1)) / 4.0


@takes_host_data("raw")
def cpe_unwrap(raw: torch.Tensor, constellation: str) -> torch.Tensor:
    """Cumulatively unwrap the modulus-π/2 (π for BPSK) phases along the
    symbol axis: each step takes the branch nearest the previous symbol's
    phase."""
    per = np.pi if constellation == "bpsk" else np.pi / 2.0
    d = torch.diff(raw, dim=-1)
    d = torch.remainder(d + per / 2.0, per) - per / 2.0
    return torch.cat([raw[..., :1], raw[..., :1] + torch.cumsum(d, dim=-1)],
                     dim=-1)


@takes_host_data("syms")
def cpe_correct(syms: torch.Tensor, constellation: str):
    """Estimate and remove per-symbol common phase error from equalized
    data cells (the ``phase_tracking='cpe'`` RX stage): raw phases →
    cumulative unwrap → derotate. Returns (corrected, phases)."""
    phases = cpe_unwrap(cpe_raw_phases(syms, constellation), constellation)
    rot = torch.polar(torch.ones_like(phases, dtype=torch.float32),
                      -phases.to(torch.float32))
    return syms * rot[..., None], phases


def _interp_per_symbol(pb: torch.Tensor, ratio: torch.Tensor,
                       n_fft: int) -> torch.Tensor:
    """Linear interpolation of ``ratio`` (..., n_sym, P), known at the
    bin-sorted ``pb`` (n_sym, P), onto bins 0..n_fft−1, holding the edge
    values outside them, every symbol at once (the arithmetic of
    ``jnp.interp``: the segment right of the last pilot ≤ bin, weight
    (bin − x₀)/(x₁ − x₀), a zero-width segment taking its left value)."""
    xp = pb.to(torch.float32)
    n_sym, P = xp.shape
    x = torch.arange(n_fft, dtype=torch.float32,
                     device=xp.device).expand(n_sym, n_fft).contiguous()
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, P - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    lead = ratio.shape[:-2]
    idx = (i - 1).expand(lead + (n_sym, n_fft))
    f0 = ratio.gather(-1, idx)
    f1 = ratio.gather(-1, idx + 1)
    dx = x1 - x0
    zero = dx.abs() <= np.spacing(np.finfo(np.float32).eps)
    f = torch.where(zero, f0, f0 + ((x - x0) / torch.where(zero, 1.0, dx))
                    * (f1 - f0))
    f = torch.where(x < xp[:, :1], ratio[..., :1], f)
    return torch.where(x > xp[:, -1:], ratio[..., -1:], f)


@takes_host_data("freq_syms")
def channel_estimate_pilots(freq_syms: torch.Tensor, pilot_bins, pilot_values,
                            n_fft: int) -> torch.Tensor:
    """Per-symbol pilot interpolation: linear complex interpolation between
    the bin-sorted known-vs-received pilot ratios, edge hold.
    ``freq_syms``: (..., n_sym, n_fft); ``pilot_bins``/``pilot_values``:
    (n_pilots,) or per symbol (n_sym, n_pilots). Returns the (..., n_sym,
    n_fft) complex64 channel estimate. Constant 1-D numpy pilot bins take
    two float32 products with an interpolation matrix, TF32 off (full
    float32, as the JAX package's ``Precision.HIGHEST``); other layouts a
    batched interpolation over every symbol."""
    dev = freq_syms.device
    if isinstance(pilot_bins, np.ndarray) and pilot_bins.ndim == 1:
        order = np.argsort(pilot_bins, kind="stable")
        pb_s = pilot_bins[order]
        W = _pilot_interp_matrix(tuple(int(b) for b in pb_s), int(n_fft),
                                 str(dev))
        pv_s = torch.as_tensor(np.asarray(pilot_values)[order].astype(
            np.complex64), device=dev)
        ratio = freq_syms[..., torch.as_tensor(pb_s, device=dev)] / pv_s
        with full_f32():
            est = torch.complex(torch.matmul(ratio.real.contiguous(), W),
                                torch.matmul(ratio.imag.contiguous(), W))
        return est.to(torch.complex64)
    n_sym = freq_syms.shape[-2]
    pb = torch.as_tensor(np.asarray(pilot_bins), device=dev).to(torch.int64)
    pv = torch.as_tensor(np.asarray(pilot_values, np.complex64), device=dev)
    pb = pb.expand(n_sym, pb.shape[-1])
    pv = pv.expand(n_sym, pv.shape[-1])
    order = torch.argsort(pb, dim=-1, stable=True)
    pb = pb.gather(-1, order)
    pv = pv.gather(-1, order)
    lead = freq_syms.shape[:-2]
    rx = freq_syms.gather(-1, pb.expand(lead + pb.shape))
    ratio = (rx / pv).to(torch.complex64)
    re = _interp_per_symbol(pb, ratio.real.contiguous(), n_fft)
    im = _interp_per_symbol(pb, ratio.imag.contiguous(), n_fft)
    return torch.complex(re, im)


def ofdm_demod(cfg: OfdmConfig, iq, n_symbols: Optional[int] = None,
               estimate=None, gain: float = 1.0, phase0=0.0, device=None):
    """IQ (..., n) → soft data symbols (..., n_sym, n_data): down-mix by
    ``cfg.rf_hz`` from ``phase0``, window and FFT every symbol, ZF-equalize
    by ``estimate`` ((n_fft,) held or (..., n_sym, n_fft) per symbol) when
    given, extract the data bins, scale by ``gain``, and despread with
    ``transform_precoding``. Returns (soft complex64, phase)."""
    g = cfg.grid()
    z = on_device(iq, device, torch.complex64)
    if cfg.rf_hz != 0.0:
        z, phase0 = rotate(z, -cfg.rf_hz, cfg.fs,
                           carried_phase(phase0, z.device))
    freq = symbol_fft(z, g.n_fft, g.cp_len, backoff=cfg.rx_window_backoff,
                      n_symbols=n_symbols)
    if estimate is not None:
        freq = zf_equalize(freq, on_device(estimate, freq.device,
                                           torch.complex64))
    soft = grid_extract(g, freq) * gain
    if cfg.transform_precoding:
        soft = dft_deprecode(soft)
    return soft.to(torch.complex64), phase0


def _flat_symbols(soft_symbols, device) -> torch.Tensor:
    s = on_device(soft_symbols, device, torch.complex64)
    return s.reshape(s.shape[:-2] + (-1,))


def ofdm_decide(cfg: OfdmConfig, soft_symbols, device=None) -> torch.Tensor:
    """Hard bits (..., n_sym·bps) uint8 from soft symbols (..., n_sym,
    n_data)."""
    return decide(_flat_symbols(soft_symbols, device), cfg.constellation)


def ofdm_soft_demod(cfg: OfdmConfig, soft_symbols,
                    device=None) -> torch.Tensor:
    """Max-log LLRs (..., n_sym·bps) float32, positive ⇒ bit 0."""
    return soft_llr(_flat_symbols(soft_symbols, device), cfg.constellation)


class OfdmRxFrame(NamedTuple):
    """Per-packet diagnostics."""
    bits: np.ndarray
    num_symbols: int
    evm_db: Optional[float]
    cfo_hz: Optional[float] = None
    timing_offset_samples: Optional[int] = None
    channel_mse: Optional[float] = None


def build_ofdm_rx_frame(cfg: OfdmConfig, soft_symbols, bits) -> OfdmRxFrame:
    """Per-packet diagnostics on the host: EVM of the soft symbols against
    the ideal points the hard ``bits`` map to (None when the counts do not
    line up or there is nothing to measure)."""
    from .util import _np
    s = _np(soft_symbols).reshape(-1)
    b = _np(bits)
    n_data = cfg.carrier_plan.num_data_carriers()
    num_symbols = len(s) // max(n_data, 1)
    evm = None
    if num_symbols and len(s):
        ideal = map_bits(torch.as_tensor(np.ascontiguousarray(b)),
                         cfg.constellation).numpy()
        if len(ideal) == len(s):
            err = float(np.sum(np.abs(s - ideal) ** 2))
            ref = float(np.sum(np.abs(ideal) ** 2))
            if ref > 0:
                evm = 10.0 * np.log10(err / ref) if err > 0 else -np.inf
    return OfdmRxFrame(bits=b, num_symbols=num_symbols, evm_db=evm)
