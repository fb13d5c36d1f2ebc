"""Polyphase filter-bank (PFB) channelizer (counterpart of
``orion_sdr_tpu/dsp/pfb.py``): every one of C uniformly spaced channels
from one prototype filter and one batched FFT a step, at a cost that does
not grow with C.

Critically sampled analysis bank: channel c is centered at c·fs/C (c
signed around DC, fftfreq order), output rate fs/C. The polyphase sum runs
on the capture's device as P shifted row slices accumulated in complex64
in the fixed order j = 0…P−1, then one FFT across the C phases.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import to_device
from .fir import kaiser_lowpass_taps


def pfb_prototype(n_channels: int, taps_per_phase: int = 12,
                  stopband_db: float = 70.0,
                  cutoff_scale: float = 0.5) -> np.ndarray:
    """Prototype lowpass for a C-channel bank: cutoff at
    ``cutoff_scale``·(fs/2C), length C·taps_per_phase."""
    c = int(n_channels)
    taps = kaiser_lowpass_taps(c * taps_per_phase - 1,
                               cutoff_scale * 0.5 / c, stopband_db)
    out = np.zeros(c * taps_per_phase, np.float32)
    out[:len(taps)] = taps
    return out                           # unity gain after the C-point FFT


def _pfb_run(x: torch.Tensor, proto, n_channels: int) -> torch.Tensor:
    """(n,) complex64 → (C, n//C − P + 1) complex64 channels."""
    c = n_channels
    h = torch.as_tensor(np.asarray(proto, np.float32).reshape(-1, c),
                        device=x.device)                  # (P, C) phases
    p = h.shape[0]
    n_out = x.shape[-1] // c - (p - 1)
    # P shifted row slices of the (rows, C) reshaped capture: no gathered
    # (n_out, P·C) frame tensor holding P copies of the capture
    xb = x[: (n_out + p - 1) * c].reshape(n_out + p - 1, c)
    acc = torch.zeros((n_out, c), dtype=x.dtype, device=x.device)
    for j in range(p):
        acc = acc + xb[j: j + n_out] * h[j][None, :]
    # the forward FFT across the phases puts the tone at +c·fs/C into row c
    # (fftfreq order); the C-point coherent sum restores unity gain
    return torch.fft.fft(acc, dim=-1).T.to(torch.complex64)


def pfb_channelize(iq, n_channels: int, taps_per_phase: int = 12,
                   stopband_db: float = 70.0,
                   device="cuda") -> torch.Tensor:
    """(n,) complex capture → (C, n//C − P + 1) critically sampled channels
    on ``device``; channel c sits at ((c + C/2) % C − C/2)·fs/C."""
    z = to_device(iq, device, torch.complex64)
    if z.dim() != 1:
        raise ValueError("pfb_channelize takes a 1-D capture")
    c = int(n_channels)
    if c < 2:
        raise ValueError("need at least 2 channels")
    if z.shape[0] < c * (taps_per_phase + 1):
        raise ValueError("capture shorter than one filter span")
    proto = pfb_prototype(c, taps_per_phase, stopband_db)
    return _pfb_run(z, proto, c)


def pfb_channel_freqs(n_channels: int, fs: float) -> np.ndarray:
    """Center frequency of each output row (fftfreq convention)."""
    return np.fft.fftfreq(int(n_channels), 1.0 / fs)
