"""Oscillators and frequency translation by an exact phase ramp
(counterpart of ``orion_sdr_tpu/dsp/osc.py``).

The phasor applied to sample i has phase ``phase0 + w·(i+1)`` (the
oscillator advances first), in float32, so the two packages agree sample
for sample. A scalar ``phase0`` is added to the rounded product, as the
JAX package's ``_ramp`` does run on its own; a carried per-row phase (a
tensor ``phase0``, shape (...,)) is added in one rounding, as the JAX
package's jitted callers fuse it into a multiply-add. ``freq_hz`` may be a
tensor of per-row frequencies (shape (..., 1) against (..., n) samples):
its step ``w = 2π·f/fs`` is formed in float32 as those jitted callers
form it. The phase carried out is a float for scalar arguments and a
tensor otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import on_device

TAU = 6.283185307179586


def _ramp(freq_hz, fs, n: int, phase0, device):
    """(phase (..., n) float32, phase_out): phase[k] = p0 + w·(k+1),
    phase_out = (p0 + w·n) mod 2π."""
    k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    if isinstance(freq_hz, torch.Tensor):
        # XLA folds 2π·f/fs·n into f·(2π·(1/fs)·n), constants in float32
        c = np.float32(TAU) * (np.float32(1) / np.float32(fs))
        w = freq_hz.to(torch.float32) * float(c)
        wn = freq_hz.to(torch.float32) * float(c * np.float32(n))
    else:
        w = TAU * float(freq_hz) / float(fs)
        wn = np.float32(w * n)        # the double product, rounded once
        w = float(np.float32(w))
    if isinstance(phase0, torch.Tensor):
        # a carried phase: the JAX package's jitted callers fuse p0 + w·k
        # into one multiply-add, so form it in float64 and round once
        p0 = phase0.to(device=device, dtype=torch.float32)
        w64 = w.double() if isinstance(w, torch.Tensor) else w
        ph = (p0.double()[..., None] + w64 * k.double()).to(torch.float32)
    else:
        p0 = np.float32(phase0)
        ph = float(p0) + w * k
    if isinstance(p0, torch.Tensor):
        return ph, torch.remainder(p0 + (wn if isinstance(wn, torch.Tensor)
                                         else float(wn)), TAU)
    if isinstance(wn, torch.Tensor):
        return ph, torch.remainder(wn + float(p0), TAU)
    return ph, float(np.remainder(p0 + wn, np.float32(TAU)))


def _phasor(ph: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(ph), ph)


def oscillator(freq_hz, fs: float, n: int, phase0=0.0, device="cuda"):
    """Complex phasor stream e^{j·phase[k]}; returns (phasor (..., n)
    complex64, phase_out)."""
    ph, phase_out = _ramp(freq_hz, fs, n, phase0, device)
    return _phasor(ph), phase_out


def rotate(x, freq_hz, fs: float, phase0=0.0, device=None):
    """Frequency-translate IQ by ``freq_hz``: y = x·e^{j·phase}
    (Rotator::rotate_block, dsp/rotator.rs:74). Returns ``(y, phase_out)``
    so blocks chain. Host data runs on ``device`` (None: the card)."""
    x = on_device(x, device)
    ph, phase_out = _ramp(freq_hz, fs, x.shape[-1], phase0, x.device)
    return (x * _phasor(ph)).to(torch.complex64), phase_out


def rotate_host(x, freq_hz, fs: float, phase0: float = 0.0, device=None):
    """:func:`rotate` with the step ``w = 2π·freq_hz/fs`` formed in float32,
    as the JAX package's ``rotate_host`` forms it from a float32
    frequency; its jitted program fuses p0 + w·k into one multiply-add, so
    the phase is formed in float64 and rounded once."""
    x = on_device(x, device)
    w = np.float32(TAU) * np.float32(freq_hz) / np.float32(fs)
    n = x.shape[-1]
    p0 = np.float32(phase0)
    k = torch.arange(1, n + 1, dtype=torch.float64, device=x.device)
    ph = (float(p0) + float(w) * k).to(torch.float32)
    y = (x * _phasor(ph)).to(torch.complex64)
    return y, float(np.remainder(p0 + np.float32(w * n), np.float32(TAU)))


def mix_usb(x, freq_hz, fs: float, phase0=0.0, device=None):
    """USB product detector: y = I·cos + Q·sin (Rotator::mix_usb_block,
    dsp/rotator.rs:88). Returns (y float32, phase_out)."""
    x = on_device(x, device)
    ph, phase_out = _ramp(freq_hz, fs, x.shape[-1], phase0, x.device)
    y = x.real * torch.cos(ph) + x.imag * torch.sin(ph)
    return y.to(torch.float32), phase_out


def mix_usb_host(x, freq_hz, fs: float, phase0=0.0, device=None):
    """:func:`mix_usb` with the step formed in float32 from a float32
    frequency, as the JAX package's ``mix_usb_host`` forms it when the
    frequency crosses as an array."""
    x = on_device(x, device)
    f = torch.tensor(np.float32(freq_hz), device=x.device)
    y, phase_out = mix_usb(x, f, fs, phase0)
    return y, (float(phase_out) if phase_out.dim() == 0 else phase_out)
