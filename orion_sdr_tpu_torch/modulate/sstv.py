"""SSTV transmitter, Martin M1 (counterpart of ``orion_sdr_tpu/modulate/
sstv.py``). An RGB image becomes a frequency track (1500–2300 Hz luminance
ramp, 1200 Hz syncs, VIS header) on the host, synthesised on ``device`` as
one continuous phase accumulator.

Martin M1 timing (per 256 lines): 4.862 ms sync @1200, 0.572 ms porch
@1500, then G, B, R scans of 146.432 ms each separated by 0.572 ms @1500.
VIS code 44 (0x2C) with even parity at 30 ms/bit, 1100/1300 Hz.

The reference sums the phase in float32, which reaches ~1.4e6 rad over a
picture (an ulp of 0.125 rad), so any two summation orders part visibly.
The port sums the float32 steps in float64 and takes the sine there, each
sample rounded once to float32: what it is held to against the reference
is what survives the phase, the instantaneous frequency and the decoded
image.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.osc import TAU
from ..util import _np

SSTV_BLACK_HZ = 1500.0
SSTV_WHITE_HZ = 2300.0
SSTV_SYNC_HZ = 1200.0
SSTV_PORCH_HZ = 1500.0

MARTIN_M1 = {
    "vis": 44,
    "lines": 256,
    "width": 320,
    "sync_s": 4.862e-3,
    "porch_s": 0.572e-3,
    "scan_s": 146.432e-3,
    "sep_s": 0.572e-3,
    "color_order": "GBR",
}


def _vis_track(vis: int):
    """VIS header → list of (freq_hz, duration_s)."""
    segs = [(1900.0, 0.300), (1200.0, 0.010), (1900.0, 0.300),
            (1200.0, 0.030)]                       # leader + start bit
    ones = 0
    for j in range(7):
        bit = (vis >> j) & 1
        ones += bit
        segs.append((1100.0 if bit else 1300.0, 0.030))
    segs.append((1100.0 if ones & 1 else 1300.0, 0.030))   # even parity
    segs.append((1200.0, 0.030))                   # stop bit
    return segs


def _freq_to_audio(freq: np.ndarray, fs: float, amplitude: float,
                   device) -> torch.Tensor:
    """Frequency track (Hz, float32) → amplitude·sin(Σ 2π·f/fs): float32
    steps summed in float64, each sample rounded once."""
    step = torch.as_tensor(np.float32(TAU / fs) * np.asarray(freq, np.float32),
                           device=device)
    phase = torch.cumsum(step.to(torch.float64), dim=-1)
    return (amplitude * torch.sin(phase)).to(torch.float32)


def _freq_track(image, fs: float, include_vis: bool = True) -> np.ndarray:
    """(H, W, 3) RGB → the float32 frequency track (Hz) of the VIS header
    and every line's sync, porch and G, B, R scans, on the host; images of
    any size nearest-neighbor resampled to 320×256."""
    m = MARTIN_M1
    img = _np(image)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("sstv_mod takes an (H, W, 3) RGB image")
    H, W = m["lines"], m["width"]
    yi = (np.arange(H) * img.shape[0] // H).clip(0, img.shape[0] - 1)
    xi = (np.arange(W) * img.shape[1] // W).clip(0, img.shape[1] - 1)
    img = img[yi][:, xi].astype(np.float32)

    segs = _vis_track(m["vis"]) if include_vis else []
    freq_parts = []
    for f_hz, dur in segs:
        freq_parts.append(np.full(int(round(dur * fs)), f_hz, np.float32))
    scan_n = int(round(m["scan_s"] * fs))
    sync_n = int(round(m["sync_s"] * fs))
    porch_n = int(round(m["porch_s"] * fs))
    sep_n = int(round(m["sep_s"] * fs))
    px = (np.arange(scan_n) * W // scan_n).clip(0, W - 1)
    chan_idx = {"R": 0, "G": 1, "B": 2}
    for row in img:
        freq_parts.append(np.full(sync_n, SSTV_SYNC_HZ, np.float32))
        freq_parts.append(np.full(porch_n, SSTV_PORCH_HZ, np.float32))
        for c in m["color_order"]:
            line = row[:, chan_idx[c]]
            freq_parts.append((SSTV_BLACK_HZ
                               + (SSTV_WHITE_HZ - SSTV_BLACK_HZ)
                               * line[px] / 255.0).astype(np.float32))
            freq_parts.append(np.full(sep_n, SSTV_PORCH_HZ, np.float32))
    return np.concatenate(freq_parts)


def sstv_mod(image, fs: float, amplitude: float = 0.8,
             include_vis: bool = True, device="cuda") -> torch.Tensor:
    """(H, W, 3) uint8 RGB (host data or a tensor) → Martin M1 audio at
    ``fs``, float32 on ``device``. Images of any size are nearest-neighbor
    resampled to 320×256."""
    return _freq_to_audio(_freq_track(image, fs, include_vis), float(fs),
                          float(amplitude), device)
