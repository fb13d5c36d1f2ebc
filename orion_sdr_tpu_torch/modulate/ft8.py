"""FT8/FT4 CPFSK modulators (counterpart of ``orion_sdr_tpu/modulate/ft8.py``;
behavioral spec: modulate/ft8.rs, modulate/ft4.rs).

FT8: 8-FSK, 6.25 baud, 1920 samples/symbol @ 12 kHz, 79 symbols
(3×7 Costas + 58 data) = 151 680 samples. FT4: 4-FSK, 576 samples/symbol,
105 symbols (2 ramps + 4×4 Costas + 87 data) = 60 480 samples.

The per-sample phasor recurrence of the reference is a closed form: within
symbol k the phase is θ_k + (n+1)·φ_k, φ_k the tone's per-sample increment.
Two recipes, each with its own rounding, as in the JAX package:
:func:`cpfsk_mod` takes the phase origins θ_k as a float64 cumsum (mod 2π)
and the sample grid as one float32 broadcast + exp; :func:`cpfsk_mod_batch`
accumulates each symbol's fractional cycle count in float32, mod 1. Both run
on the device of their tone tensor; the ``ft8_*``/``ft4_*`` entry points
take host tones and a ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.device import takes_host_data
from ..dsp.osc import rotate

# FT8 protocol constants (public WSJT-X definition)
FT8_TONE_SPACING_HZ = 6.25
FT8_BAUD = 6.25
FT8_SAMPLES_PER_SYM = 1920          # 12000 / 6.25
FT8_TOTAL_SYMS = 79
FT8_DATA_SYMS = 58
FT8_TONES = 8
FT8_FRAME_LEN = FT8_TOTAL_SYMS * FT8_SAMPLES_PER_SYM   # 151_680

FT8_COSTAS = np.array([3, 1, 4, 0, 6, 5, 2], np.uint8)
FT8_SYNC_POS = ((0, 7), (36, 43), (72, 79))

# FT4 protocol constants
FT4_TONE_SPACING_HZ = 20.833334     # 12000 / 576
FT4_BAUD = FT4_TONE_SPACING_HZ
FT4_SAMPLES_PER_SYM = 576
FT4_TOTAL_SYMS = 105                # R S4 D29 S4 D29 S4 D29 S4 R
FT4_DATA_SYMS = 87
FT4_TONES = 4
FT4_FRAME_LEN = FT4_TOTAL_SYMS * FT4_SAMPLES_PER_SYM   # 60_480

FT4_COSTAS = np.array([[0, 1, 3, 2], [1, 0, 2, 3],
                       [2, 3, 1, 0], [3, 2, 0, 1]], np.uint8)
FT4_SYNC_POS = ((1, 5), (34, 38), (67, 71), (100, 104))


def _ft8_template_and_positions():
    syms = np.zeros(FT8_TOTAL_SYMS, np.uint8)
    for s, e in FT8_SYNC_POS:
        syms[s:e] = FT8_COSTAS
    return syms, ft8_data_positions()


def _ft4_template_and_positions():
    syms = np.zeros(FT4_TOTAL_SYMS, np.uint8)
    for blk, (s, e) in enumerate(FT4_SYNC_POS):
        syms[s:e] = FT4_COSTAS[blk]
    return syms, ft4_data_positions()


def ft8_symbol_sequence(data_tones) -> np.ndarray:
    """58 data tones → 79-symbol sequence with Costas blocks inserted."""
    syms, pos = _ft8_template_and_positions()
    syms[pos] = np.asarray(data_tones, np.uint8)
    return syms


def ft8_data_positions() -> np.ndarray:
    """Frame positions of the 58 data symbols: [7,36) ∪ [43,72)."""
    is_sync = np.zeros(FT8_TOTAL_SYMS, bool)
    for s, e in FT8_SYNC_POS:
        is_sync[s:e] = True
    return np.flatnonzero(~is_sync)


def ft4_symbol_sequence(data_tones) -> np.ndarray:
    """87 data tones → 105-symbol sequence with ramps + Costas blocks."""
    syms, pos = _ft4_template_and_positions()
    syms[pos] = np.asarray(data_tones, np.uint8)
    return syms


def ft4_data_positions() -> np.ndarray:
    reserved = np.zeros(FT4_TOTAL_SYMS, bool)
    reserved[0] = reserved[104] = True
    for s, e in FT4_SYNC_POS:
        reserved[s:e] = True
    return np.flatnonzero(~reserved)


@takes_host_data("symbols")
def cpfsk_mod(symbols: torch.Tensor, sps: int, fs: float, base_hz: float,
              spacing_hz: float, gain: float = 1.0, rf_hz: float = 0.0):
    """Phase-continuous rectangular FSK over a (n_syms,) tone-index tensor,
    on its device.

    Matches the reference's running-phasor synthesis (sample n of symbol k
    carries phase θ_k + (n+1)·φ_k — the phasor advances before each output).
    φ and θ in float64 (θ as a cumsum folded mod 2π), then rounded to
    float32; each sample phase θ_k + (n+1)·φ_k of those float32 values is
    rounded to float32 once, as the fused multiply-add that XLA compiles
    the JAX expression to (at ~1000 rad a float32 ulp is 1.2e-4 rad, so a
    second rounding would show). Returns (n_syms·sps,) complex64.
    """
    dev = symbols.device
    tones = symbols.to(torch.float64)
    phi = 2.0 * np.pi * (base_hz + tones * spacing_hz) / fs   # float64/sym
    theta = torch.cat([phi.new_zeros(1), torch.cumsum(phi * sps, 0)])[:-1]
    theta = torch.remainder(theta, 2.0 * np.pi)
    n = torch.arange(1, sps + 1, dtype=torch.float64, device=dev)
    # float32 operands, their product exact in float64, one rounding
    phase = (theta.to(torch.float32).to(torch.float64)[:, None]
             + phi.to(torch.float32).to(torch.float64)[:, None] * n
             ).to(torch.float32)
    out = (gain * torch.exp(1j * phase)).reshape(-1).to(torch.complex64)
    if rf_hz != 0.0:
        out, _ = rotate(out, rf_hz, fs)
    return out


@takes_host_data("tones")
def cpfsk_mod_batch(tones: torch.Tensor, sps: int, fs: float, base_hz,
                    spacing_hz: float, gain: float = 1.0):
    """Batched phase-continuous FSK: (..., n_sym) tone tensor → (...,
    n_sym·sps) complex64 on its device. Per-symbol fractional cycle counts
    accumulate in a float32 cumsum (mod 1, so f32 stays exact at the
    standard rates where each tone spans an integer number of cycles) and
    the per-sample phase is one broadcast. Matches cpfsk_mod to ~1e-3 rad
    at the FT8/FT4 operating points. ``base_hz`` is a float (rounded to
    float32 where it meets the tones, as the JAX package's weak-typed
    scalar is)."""
    t = tones.to(torch.float32)
    # cycles per symbol, folded mod 1 (phase mod 2π) before accumulating
    cyc = (base_hz + t * spacing_hz) * (sps / fs)
    cyc_frac = cyc - torch.floor(cyc)
    start = torch.cat([t.new_zeros(t.shape[:-1] + (1,)),
                       torch.cumsum(cyc_frac[..., :-1], dim=-1)], dim=-1)
    start = start - torch.floor(start)
    phi = 2.0 * np.pi * (base_hz + t * spacing_hz) / fs    # rad/sample
    n = torch.arange(1, sps + 1, dtype=torch.float32, device=t.device)
    phase = 2.0 * np.pi * start[..., None] + phi[..., None] * n
    out = gain * torch.exp(1j * phase)
    return out.reshape(out.shape[:-2] + (-1,)).to(torch.complex64)


def _mod_batch(data_tones, template, pos, n_syms, sps, fs, base_hz, spacing,
               gain, device):
    t = torch.as_tensor(np.asarray(data_tones), device=device)
    syms = torch.as_tensor(template, device=t.device).expand(
        t.shape[:-1] + (n_syms,)).clone()
    syms[..., torch.as_tensor(pos, device=t.device)] = t.to(torch.uint8)
    return cpfsk_mod_batch(syms, sps, fs, base_hz, spacing, gain)


def ft8_mod_batch(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
                  gain: float = 1.0, *, device="cuda"):
    """Batched FT8 TX: (..., 58) data tones (host or tensor) → (..., 151680)
    complex64 IQ on ``device``. Same waveform as ft8_mod (ref
    Ft8Mod::modulate) up to the batch recipe's rounding."""
    template, pos = _ft8_template_and_positions()
    return _mod_batch(data_tones, template, pos, FT8_TOTAL_SYMS,
                      FT8_SAMPLES_PER_SYM, fs, base_hz, FT8_TONE_SPACING_HZ,
                      gain, device)


def ft4_mod_batch(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
                  gain: float = 1.0, *, device="cuda"):
    """Batched FT4 TX: (..., 87) data tones → (..., 60480) IQ on
    ``device``."""
    template, pos = _ft4_template_and_positions()
    return _mod_batch(data_tones, template, pos, FT4_TOTAL_SYMS,
                      FT4_SAMPLES_PER_SYM, fs, base_hz, FT4_TONE_SPACING_HZ,
                      gain, device)


def ft8_mod(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
            rf_hz: float = 0.0, gain: float = 1.0, *, device="cuda"):
    """58 data tones → 151 680-sample complex64 IQ frame on ``device`` (ref
    Ft8Mod::modulate)."""
    syms = torch.as_tensor(ft8_symbol_sequence(data_tones), device=device)
    return cpfsk_mod(syms, FT8_SAMPLES_PER_SYM, fs, base_hz,
                     FT8_TONE_SPACING_HZ, gain, rf_hz)


def ft4_mod(data_tones, fs: float = 12000.0, base_hz: float = 1000.0,
            rf_hz: float = 0.0, gain: float = 1.0, *, device="cuda"):
    """87 data tones → 60 480-sample complex64 IQ frame on ``device`` (ref
    Ft4Mod::modulate)."""
    syms = torch.as_tensor(ft4_symbol_sequence(data_tones), device=device)
    return cpfsk_mod(syms, FT4_SAMPLES_PER_SYM, fs, base_hz,
                     FT4_TONE_SPACING_HZ, gain, rf_hz)
