"""Single-carrier digital waveform stages (counterpart of
``orion_sdr_tpu/modulate/digital.py``; behavioral spec:
modulate/{bpsk,qpsk,qam}.rs).

bits → ``map_bits`` → symbols → ``psk_qam_mod`` → IQ: the waveform stage is
gain and an optional carrier rotation (``rf_hz == 0`` passes the symbols
through). The burst modem's transmitter zero-stuffs a preamble and the
mapped payload by ``sps`` and shapes them with a root-raised-cosine pulse
(``dsp/fir.py::fir_filter_aligned``). Every entry point takes host data or
a tensor and ``device`` (default ``"cuda"``), and returns tensors on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constellation import map_bits
from ..dsp.device import to_device
from ..dsp.fir import fir_filter_aligned
from ..dsp.osc import rotate


def psk_qam_mod(symbols, fs, rf_hz=0.0, gain=1.0, phase0=0.0,
                device="cuda"):
    """Symbols → IQ at ``rf_hz`` (BpskMod/QpskMod/QamMod). Returns
    (iq, phase_out)."""
    s = to_device(symbols, device, torch.complex64) * gain
    if rf_hz == 0.0:
        return s.to(torch.complex64), phase0
    return rotate(s, rf_hz, fs, phase0)


def digital_mod(bits, order, fs, rf_hz=0.0, gain=1.0, phase0=0.0,
                device="cuda"):
    """bits → symbols → IQ in one call. Returns (iq, phase_out)."""
    return psk_qam_mod(map_bits(to_device(bits, device), order), fs, rf_hz,
                       gain, phase0, device)


def rrc_taps(sps: int, beta: float = 0.35, span: int = 8) -> np.ndarray:
    """Root-raised-cosine pulse, unit energy, ``2·span·sps + 1`` taps."""
    n = span * sps
    t = (np.arange(-n, n + 1)) / sps
    taps = np.zeros_like(t)
    for i, ti in enumerate(t):
        if abs(ti) < 1e-9:
            taps[i] = 1.0 - beta + 4 * beta / np.pi
        elif abs(abs(4 * beta * ti) - 1.0) < 1e-9:
            taps[i] = (beta / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * beta))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * beta)))
        else:
            taps[i] = (np.sin(np.pi * ti * (1 - beta))
                       + 4 * beta * ti * np.cos(np.pi * ti * (1 + beta))) \
                / (np.pi * ti * (1 - (4 * beta * ti) ** 2))
    return (taps / np.sqrt(np.sum(taps ** 2))).astype(np.float32)


def burst_mod(bits, order: str, sps: int, beta: float = 0.35,
              span: int = 8, preamble_syms=None, device="cuda"):
    """Oversampled RRC-shaped single-carrier burst: the optional known
    preamble symbols, then the mapped payload, zero-stuffed ×``sps`` and
    pulse-shaped. ``bits`` (..., n_bits) → (..., n_syms·sps) complex64 IQ
    on ``device``."""
    syms = map_bits(to_device(bits, device), order)
    if preamble_syms is not None:
        pre = to_device(preamble_syms, device, torch.complex64)
        syms = torch.cat([pre.expand(syms.shape[:-1] + pre.shape[-1:]),
                          syms], dim=-1)
    up = torch.zeros(syms.shape[:-1] + (syms.shape[-1] * sps,),
                     dtype=torch.complex64, device=syms.device)
    up[..., ::sps] = syms
    taps = rrc_taps(sps, beta, span) * np.sqrt(sps)
    return fir_filter_aligned(up, taps).to(torch.complex64)


def burst_preamble(n: int = 32, seed: int = 7) -> np.ndarray:
    """A fixed QPSK preamble both ends share (resolves timing and the
    constellation's 90° rotational ambiguity at the receiver)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 4, n)
    return (np.exp(1j * (np.pi / 4 + np.pi / 2 * q))).astype(np.complex64)
