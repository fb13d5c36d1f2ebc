"""WSPR beacon transmitter, wire-compatible with the published protocol
(counterpart of ``orion_sdr_tpu/modulate/wspr.py``; codec/wspr.py carries
the coding process): 162 × 4-FSK continuous-phase tones, fs/8192
spacing, 8192 samples a symbol."""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.osc import TAU
from ..codec.wspr import WSPR_FS, WSPR_SPS, wspr_symbols
from .css import freq_to_iq


def wspr_mod(callsign: str, grid: str, dbm: int, fs: float = WSPR_FS,
             base_hz: float = 1500.0, amplitude: float = 1.0,
             device="cuda") -> torch.Tensor:
    """Message → ≈110.6 s complex beacon at ``fs`` (12 kHz: the numerology
    is fixed like FT8's) on ``device``. The phase is the cumulative sum of
    the float32 steps in float64, rounded once (the JAX package's float32
    tree sum strays up to ~0.2 rad from it over the 1.33 M samples)."""
    if fs != WSPR_FS:
        raise ValueError("the WSPR-style numerology is fixed at 12 kHz")
    tones = torch.as_tensor(wspr_symbols(callsign, grid, dbm).astype(
        np.float32), device=device)
    sym = torch.repeat_interleave(tones, WSPR_SPS)
    freq = np.float32(base_hz) + sym * np.float32(fs / WSPR_SPS)
    return freq_to_iq(freq, float(fs), float(amplitude), device=device)
