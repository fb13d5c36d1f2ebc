"""Frequency translation by an exact phase ramp (counterpart of
``orion_sdr_tpu/dsp/osc.py::rotate`` and ``rotate_host``).

The phasor applied to sample i has phase ``phase0 + w·(i+1)`` (the
oscillator advances first), computed in float32 exactly as the JAX
package's ``_ramp`` does, so the two packages agree sample for sample.
"""

from __future__ import annotations

import numpy as np
import torch

TAU = 6.283185307179586


def _rotate(x: torch.Tensor, w, phase0: float):
    n = x.shape[-1]
    p0 = np.float32(phase0)
    k = torch.arange(1, n + 1, dtype=torch.float32, device=x.device)
    ph = float(p0) + float(np.float32(w)) * k
    y = (x * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)
    phase_out = float(np.remainder(p0 + np.float32(w * n), np.float32(TAU)))
    return y, phase_out


def rotate(x: torch.Tensor, freq_hz: float, fs: float, phase0: float = 0.0):
    """y = x · e^{j·phase}; returns ``(y, phase_out)`` so blocks chain."""
    return _rotate(x, TAU * float(freq_hz) / float(fs), phase0)


def rotate_host(x: torch.Tensor, freq_hz, fs: float, phase0: float = 0.0):
    """:func:`rotate` with the step ``w = 2π·freq_hz/fs`` formed in float32,
    as the JAX package's ``rotate_host`` forms it from a float32
    frequency."""
    w = np.float32(TAU) * np.float32(freq_hz) / np.float32(fs)
    return _rotate(x, w, phase0)
