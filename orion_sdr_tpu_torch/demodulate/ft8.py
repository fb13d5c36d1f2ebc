"""FT8/FT4 tone demodulators (counterpart of
``orion_sdr_tpu/demodulate/ft8.py``; behavioral spec: demodulate/ft8.rs,
ft4.rs).

The reference runs a Goertzel correlator per (symbol, tone) and argmaxes.
Here the whole frame is one product on the device: reshape to (n_syms,
sps), multiply by the (sps, n_tones) tone-phasor matrix, |·|², argmax,
batchable over frames via leading dims.
"""

from __future__ import annotations

import torch

from ..dsp.device import full_f32
from ..sync.waterfall import tone_matrix
from ..modulate.ft8 import (
    FT8_SAMPLES_PER_SYM, FT8_TOTAL_SYMS, FT8_TONE_SPACING_HZ, FT8_TONES,
    FT8_FRAME_LEN, ft8_data_positions,
    FT4_SAMPLES_PER_SYM, FT4_TOTAL_SYMS, FT4_TONE_SPACING_HZ, FT4_TONES,
    FT4_FRAME_LEN, ft4_data_positions,
)


def _detect_tones(iq: torch.Tensor, fs, base_hz, spacing, sps, n_syms,
                  n_tones) -> torch.Tensor:
    """(..., n) IQ tensor → (..., n_syms) uint8 strongest tone a symbol."""
    z = iq.to(torch.complex64)[..., : n_syms * sps]
    seg = z.reshape(z.shape[:-1] + (n_syms, sps))
    w = tone_matrix(fs, base_hz, spacing, sps, n_tones, z.device)
    with full_f32():
        energy = (seg @ w).abs() ** 2
    return torch.argmax(energy, dim=-1).to(torch.uint8)


def _demod(iq, fs, base_hz, spacing, sps, n_syms, n_tones, frame_len, pos,
           device):
    x = torch.as_tensor(iq, device=device)
    if x.shape[-1] < frame_len:
        return None
    tones = _detect_tones(x, fs, base_hz, spacing, sps, n_syms, n_tones)
    return tones.cpu().numpy()[..., pos]


def ft8_demod(iq, fs: float = 12000.0, base_hz: float = 1000.0, *,
              device="cuda"):
    """(..., 151 680)-sample frame(s) → (..., 58) uint8 data tone indices
    (sync stripped) as numpy, detected on ``device``; None if the input is
    too short (ref Ft8Demod::demodulate)."""
    return _demod(iq, fs, base_hz, FT8_TONE_SPACING_HZ, FT8_SAMPLES_PER_SYM,
                  FT8_TOTAL_SYMS, FT8_TONES, FT8_FRAME_LEN,
                  ft8_data_positions(), device)


def ft4_demod(iq, fs: float = 12000.0, base_hz: float = 1000.0, *,
              device="cuda"):
    """(..., 60 480)-sample frame(s) → (..., 87) data tone indices, or
    None."""
    return _demod(iq, fs, base_hz, FT4_TONE_SPACING_HZ, FT4_SAMPLES_PER_SYM,
                  FT4_TOTAL_SYMS, FT4_TONES, FT4_FRAME_LEN,
                  ft4_data_positions(), device)
