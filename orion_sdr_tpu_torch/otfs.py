"""OTFS (orthogonal time frequency space) modulation over the OFDM grid
(counterpart of ``orion_sdr_tpu/otfs.py``).

Data symbols sit on a delay-Doppler grid x[k, l] (k the Doppler bin
0..N−1, l the delay bin 0..M−1); the inverse symplectic finite Fourier
transform spreads each over the whole time-frequency frame, which goes out
as N ordinary CP-OFDM symbols. Every symbol rides all N × M cells, so
under a doubly selective channel each sees the frame's average SNR.

The ISFFT/SFFT are one batched pair of ``torch.fft`` calls over the
(..., N, M) grids; the TF frame reuses the whole-frame grid map, IFFT/CP
and symbol FFT. With ``noise_var`` > 0 the one-tap equalizer is per-cell
LMMSE, which followed by the (unitary) SFFT is the linear-MMSE estimate of
the delay-Doppler symbols.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .constellation import BITS_PER_SYMBOL, map_bits
from .dsp.device import on_device
from .dsp.osc import rotate
from .multicarrier import grid_extract, grid_map, ofdm_assemble, \
    symbol_fft, symbol_taper
from .ofdm import OfdmConfig, carried_phase, channel_estimate_pilots, \
    mmse_equalize, zf_equalize


def isfft(dd) -> torch.Tensor:
    """Inverse symplectic finite Fourier transform, delay-Doppler → time-
    frequency (unitary): an inverse DFT along the Doppler axis (−2) and a
    forward DFT along the delay axis (−1) of the (..., N, M) grid, scaled
    by √(N/M) in float32."""
    z = on_device(dd, None, torch.complex64)
    n, m = z.shape[-2], z.shape[-1]
    out = torch.fft.fft(torch.fft.ifft(z, dim=-2), dim=-1)
    return (out * np.float32(np.sqrt(n / m))).to(torch.complex64)


def sfft(tf) -> torch.Tensor:
    """Symplectic finite Fourier transform, time-frequency → delay-Doppler
    (the inverse of :func:`isfft`)."""
    z = on_device(tf, None, torch.complex64)
    n, m = z.shape[-2], z.shape[-1]
    out = torch.fft.fft(torch.fft.ifft(z, dim=-1), dim=-2)
    return (out * np.float32(np.sqrt(m / n))).to(torch.complex64)


def otfs_num_symbols(cfg: OfdmConfig, n_bits: int, n_doppler: int) -> int:
    """OFDM symbols an ``n_bits`` transmission occupies: bits are
    zero-padded up to whole N-symbol OTFS frames."""
    per_frame = n_doppler * cfg.bits_per_ofdm_symbol()
    return n_doppler * (-(-n_bits // per_frame))


def otfs_mod(cfg: OfdmConfig, bits, n_doppler: int, phase0=0.0,
             device=None):
    """bits (..., n_bits) → IQ through the delay-Doppler grid: map row-major
    onto (n_doppler × data carriers) grids, one an OTFS frame (zero-padded
    to whole frames), ISFFT, then the config's ordinary TX chain (grid map,
    IFFT/CP, taper, gain, RF rotator, TX lowpass). Returns (iq complex64,
    phase)."""
    g = cfg.grid()
    bits = on_device(bits, device)
    m_d = g.num_data_carriers
    bps = cfg.bits_per_ofdm_symbol()
    n_sym = otfs_num_symbols(cfg, bits.shape[-1], n_doppler)
    pad = n_sym * bps - bits.shape[-1]
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    syms = map_bits(bits, cfg.constellation)
    dd = syms.reshape(syms.shape[:-1] + (n_sym // n_doppler, n_doppler, m_d))
    tf = isfft(dd)
    freq = grid_map(g, tf.reshape(tf.shape[:-3] + (n_sym, m_d)))
    taper = symbol_taper(cfg.samples_per_ofdm_symbol(),
                         cfg.carrier_plan.window_roll_off)
    t = ofdm_assemble(freq, cfg.carrier_plan.cp_len, taper=taper) * cfg.gain
    if cfg.rf_hz != 0.0:
        t, phase0 = rotate(t, cfg.rf_hz, cfg.fs,
                           carried_phase(phase0, t.device))
    if cfg.tx_lowpass is not None:
        t = cfg.tx_lowpass.apply(t)
    return t.to(torch.complex64), phase0


def otfs_demod(cfg: OfdmConfig, iq, n_doppler: int,
               n_symbols: Optional[int] = None, estimate=None,
               noise_var: float = 0.0, phase0=0.0, device=None):
    """IQ → soft delay-Doppler symbols (..., n_sym, data carriers): symbol
    FFT, one-tap equalization, SFFT. The channel is re-estimated every
    symbol from the plan's pilots when ``cfg.equalizer_method`` is
    'pilot_interp' and the plan has pilots, else ``estimate`` ((n_fft,)
    held or (n_sym, n_fft) per symbol) is used when given. ``noise_var``
    > 0 selects LMMSE over ZF. ``n_symbols`` must cover whole OTFS frames;
    the per-frame (N, M) grids come back flattened to (n_sym, M) rows, so
    :func:`~orion_sdr_tpu_torch.ofdm.ofdm_decide` and ``ofdm_soft_demod``
    apply unchanged. Returns (soft complex64, phase)."""
    g = cfg.grid()
    z = on_device(iq, device, torch.complex64)
    if cfg.rf_hz != 0.0:
        z, phase0 = rotate(z, -cfg.rf_hz, cfg.fs,
                           carried_phase(phase0, z.device))
    freq = symbol_fft(z, g.n_fft, g.cp_len, backoff=cfg.rx_window_backoff,
                      n_symbols=n_symbols)

    def eq(x, h):
        return mmse_equalize(x, h, noise_var) if noise_var > 0.0 \
            else zf_equalize(x, h)
    if cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size:
        known = g.pilot_values * np.complex64(cfg.gain)
        freq = eq(freq, channel_estimate_pilots(freq, g.pilot_bins, known,
                                                g.n_fft))
    elif estimate is not None:
        freq = eq(freq, on_device(estimate, freq.device, torch.complex64))
    tf = grid_extract(g, freq) / cfg.gain
    n_sym, m_d = tf.shape[-2], tf.shape[-1]
    dd = sfft(tf.reshape(tf.shape[:-2] + (n_sym // n_doppler, n_doppler,
                                          m_d)))
    return dd.reshape(dd.shape[:-3] + (n_sym, m_d)).to(torch.complex64), \
        phase0
