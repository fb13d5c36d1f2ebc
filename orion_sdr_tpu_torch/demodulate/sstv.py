"""SSTV receiver, Martin M1 (counterpart of ``orion_sdr_tpu/demodulate/
sstv.py``). The instantaneous frequency by analytic-signal discrimination
runs on ``device`` (a complex mix, a Kaiser lowpass, the atan2 of the lag
product); on the host, as in the reference, the line sync by 1200 Hz dwell
detection with per-line re-lock (tolerates sample-rate drift), the VIS
header and the pixel sampling on the scan grid.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.fir import kaiser_lowpass_taps, kaiser_num_taps, fir_filter_aligned
from ..dsp.osc import TAU
from ..modulate.sstv import (MARTIN_M1, SSTV_BLACK_HZ, SSTV_WHITE_HZ,
                             SSTV_SYNC_HZ)


class SstvImage(NamedTuple):
    image: np.ndarray            # (lines, width, 3) uint8 RGB
    vis: Optional[int]           # decoded VIS code (None if absent)


def _instantaneous_freq(x: torch.Tensor, fs: float) -> torch.Tensor:
    """Real (..., n) float32 audio → smoothed instantaneous frequency (Hz):
    analytic signal by a complex mix at the band center and a lowpass, then
    the phase difference of successive samples."""
    n = x.shape[-1]
    fc = 1900.0
    ph = float(np.float32(TAU * fc / fs)) * torch.arange(
        1, n + 1, dtype=torch.float32, device=x.device)
    e = torch.complex(torch.cos(ph), -torch.sin(ph))
    taps = kaiser_lowpass_taps(kaiser_num_taps(700.0 / fs, 50.0),
                               900.0 / fs, 50.0)
    bb = fir_filter_aligned(x * e, taps)
    prod = bb[..., 1:] * torch.conj(bb[..., :-1])
    df = torch.atan2(prod.imag, prod.real) * float(np.float32(fs / TAU))
    return torch.cat([df[..., :1], df], dim=-1) + fc


def _smooth(freq: np.ndarray, k: int) -> np.ndarray:
    k = max(int(k), 1)
    return np.convolve(freq, np.ones(k, np.float32) / k, mode="same")


def _find_syncs(freq: np.ndarray, fs: float, min_dwell_s: float):
    """Start indices of ≥min_dwell dwells at the 1200 Hz sync frequency
    (±80 Hz — tight enough to exclude the 1100/1300 Hz VIS data bits)."""
    low = np.abs(freq - SSTV_SYNC_HZ) < 80.0
    edges = np.diff(low.astype(np.int8))
    starts = np.flatnonzero(edges == 1) + 1
    ends = np.flatnonzero(edges == -1) + 1
    if low[0]:
        starts = np.concatenate([[0], starts])
    if low[-1]:
        ends = np.concatenate([ends, [len(low)]])
    keep = (ends - starts) >= int(min_dwell_s * fs)
    return starts[keep], ends[keep]


def _decode_vis(freq: np.ndarray, fs: float) -> Optional[int]:
    """Find the VIS start bit (a ~30 ms 1200 Hz dwell after the 1900 Hz
    leader) and read 8 bits at 1100/1300 Hz."""
    starts, ends = _find_syncs(freq, fs, 0.020)
    bit_n = int(0.030 * fs)
    for s, e in zip(starts, ends):
        if (e - s) > 0.045 * fs:
            continue                      # too long for a VIS start bit
        base = e                          # bits follow the start dwell
        bits = []
        ok = True
        for j in range(8):
            seg = freq[base + j * bit_n + bit_n // 4:
                       base + j * bit_n + 3 * bit_n // 4]
            if seg.size == 0:
                ok = False
                break
            f = float(np.median(seg))
            if abs(f - 1100.0) < 60.0:
                bits.append(1)
            elif abs(f - 1300.0) < 60.0:
                bits.append(0)
            else:
                ok = False
                break
        if ok and sum(bits) % 2 == 0:     # even parity incl. parity bit
            return sum(b << j for j, b in enumerate(bits[:7]))
    return None


def sstv_demod(audio, fs: float, device="cuda") -> SstvImage:
    """Martin M1 audio (host data or a tensor) → SstvImage, the
    discriminator on ``device``. Per-line sync re-lock; lines without a
    detected sync fall back to the nominal grid."""
    m = MARTIN_M1
    raw = _instantaneous_freq(to_device(audio, device, torch.float32),
                              float(fs)).cpu().numpy()
    k_pix = max(int(fs * m["scan_s"] / m["width"] * 0.9), 1)
    freq = _smooth(raw, k_pix)            # pixel reads: one-pixel boxcar
    fsync = _smooth(raw, 3 * k_pix)       # sync/VIS: heavier smoothing
    vis = _decode_vis(fsync, fs)
    syncs, ends = _find_syncs(fsync, fs, m["sync_s"] * 0.6)
    line_period = (m["sync_s"] + m["porch_s"]
                   + 3 * (m["scan_s"] + m["sep_s"])) * fs
    if syncs.size == 0:
        raise ValueError("no SSTV line sync found")
    H, W = m["lines"], m["width"]
    img = np.zeros((H, W, 3), np.uint8)
    scan_n = m["scan_s"] * fs
    sync_n = int(m["sync_s"] * fs)
    chan_of = {"R": 0, "G": 1, "B": 2}
    # the first isolated line sync (the VIS stop bit can swallow line 0's
    # sync into one long dwell)…
    t0 = None
    for s, e in zip(syncs, ends):
        if (e - s) <= m["sync_s"] * fs * 1.6:
            t0 = float(s)
            break
    if t0 is None:
        raise ValueError("no SSTV line sync found")
    # …then step BACK to any merged earlier lines still holding 1200 Hz
    while t0 - line_period >= 0:
        back = int(t0 - line_period)
        if abs(float(np.median(fsync[back:back + sync_n]))
               - SSTV_SYNC_HZ) < 80.0:
            t0 -= line_period
        else:
            break
    expect = t0
    for row in range(H):
        # re-lock on the nearest detected sync; track cumulatively so the
        # float-vs-rounded line period (≈2 samples/line) never walks out
        # of the window
        near = syncs[np.abs(syncs - expect) < 0.020 * fs]
        base = float(near[0]) if near.size else expect
        expect = base + line_period
        base += (m["sync_s"] + m["porch_s"]) * fs
        for c in m["color_order"]:
            idx = (base + (np.arange(W) + 0.5) / W * scan_n).astype(np.int64)
            idx = np.clip(idx, 0, len(freq) - 1)
            vals = (freq[idx] - SSTV_BLACK_HZ) \
                / (SSTV_WHITE_HZ - SSTV_BLACK_HZ) * 255.0
            img[row, :, chan_of[c]] = np.clip(vals, 0, 255).astype(np.uint8)
            base += (m["scan_s"] + m["sep_s"]) * fs
    return SstvImage(image=img, vis=vis)
