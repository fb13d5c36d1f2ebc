"""ADS-B 1090ES pulse-position-modulation transmitter (counterpart of
``orion_sdr_tpu/modulate/adsb.py``; host numpy, the port's own copy). A
Mode S frame is 8 µs of preamble (pulses at 0, 1, 3.5, 4.5 µs) + 112 µs of
PPM data (bit 1 = pulse in the first half-µs). Chips are 0.5 µs; ``fs``
must be an integer multiple of 2 MHz. Any number of frames compose into
one capture at arbitrary offsets and amplitudes (a synthetic busy sky)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

ADSB_CHIP_RATE = 2_000_000.0
PREAMBLE_CHIPS = np.array([1, 0, 1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0, 0, 0],
                          np.float32)
FRAME_CHIPS = 16 + 2 * 112


def adsb_frame_chips(bits) -> np.ndarray:
    """112 frame bits → 240-chip envelope (preamble + PPM data)."""
    b = np.asarray(bits, np.uint8) & 1
    if len(b) != 112:
        raise ValueError("a Mode S extended squitter is 112 bits")
    chips = np.zeros(FRAME_CHIPS, np.float32)
    chips[:16] = PREAMBLE_CHIPS
    idx = 16 + 2 * np.arange(112) + (1 - b)
    chips[idx] = 1.0
    return chips


def adsb_mod(frames, fs: float, offsets_s: Sequence[float] | None = None,
             amplitudes: Sequence[float] | None = None,
             total_s: float | None = None, device="cuda") -> torch.Tensor:
    """Frames (list of 112-bit arrays) → one complex64 baseband capture,
    composed on the host and returned on ``device``.

    ``offsets_s``: start time of each frame (default: spaced 200 µs);
    ``total_s``: capture length (default: covers the last frame + 100 µs).
    """
    m = fs / ADSB_CHIP_RATE
    if abs(m - round(m)) > 1e-9 or round(m) < 1:
        raise ValueError(f"fs must be an integer multiple of 2 MHz, got {fs}")
    m = int(round(m))
    frames = list(frames)
    if offsets_s is None:
        offsets_s = [200e-6 * i for i in range(len(frames))]
    if amplitudes is None:
        amplitudes = [1.0] * len(frames)
    frame_s = FRAME_CHIPS / ADSB_CHIP_RATE
    if total_s is None:
        total_s = (max(offsets_s, default=0.0) + frame_s + 100e-6)
    n = int(round(total_s * fs))
    env = np.zeros(n, np.float32)
    for bits, off, amp in zip(frames, offsets_s, amplitudes):
        chips = adsb_frame_chips(bits) * amp
        wave = np.repeat(chips, m)
        s = int(round(off * fs))
        e = min(s + len(wave), n)
        if s < 0 or s >= n:
            continue
        env[s:e] = np.maximum(env[s:e], wave[:e - s])
    return torch.as_tensor(env.astype(np.complex64), device=device)
