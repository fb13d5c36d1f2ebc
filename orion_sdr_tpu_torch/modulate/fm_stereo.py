"""FM broadcast stereo multiplex TX (pilot-tone system, ITU-R BS.450) with
an optional RDS subcarrier (counterpart of
``orion_sdr_tpu/modulate/fm_stereo.py``).

Composite (MPX) layout, θ = 2π·19 kHz·t:
  mpx = a·[(L+R)/2 + (L−R)/2 · cos 2θ] + p·cos θ + r·rds(t)·cos 3θ
with audio level a = 0.9, pilot p = 0.09, RDS r = 0.05 by default. The
38/57 kHz subcarriers are the square and cube of the same 19 kHz phasor,
so TX and RX phase references cancel exactly (the RX derives its
references from the received pilot the same way). The composite is one
batched elementwise program on the audio's device; the RDS Manchester
waveform indexes its differential bit stream by a time-derived gather.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.rds import RDS_SYMBOL_RATE
from ..dsp.device import to_device
from ..dsp.fir import fir_filter_aligned, kaiser_lowpass_taps, kaiser_num_taps
from ..dsp.osc import TAU
from .analog import FmState, fm_mod

FM_STEREO_PILOT_HZ = 19_000.0
RDS_CARRIER_HZ = 57_000.0
FM_STEREO_MIN_FS = 2 * 60_000.0    # composite extends to 57k + ~2.4k


def rds_taps(fs: float) -> np.ndarray:
    """The ~2.4 kHz Kaiser lowpass that shapes the RDS baseband (TX) and
    isolates it (RX)."""
    return kaiser_lowpass_taps(kaiser_num_taps(2400.0 / fs, 50.0),
                               2100.0 / fs, 50.0)


def rds_manchester(bits, fs, n: int, level: float = 1.0,
                   device="cuda") -> torch.Tensor:
    """Differentially encoded biphase (Manchester) RDS baseband at 1187.5
    baud, shaped by a ~2.4 kHz lowpass → (n,) float32 on ``device``.
    ``bits`` repeat cyclically so a short message fills any length."""
    b = np.asarray(bits, np.uint8) & 1
    if len(b) == 0:
        return torch.zeros(n, dtype=torch.float32, device=device)
    d = np.bitwise_xor.accumulate(b)          # d[i] = b[i] ^ d[i-1], d[-1]=0
    parity = int(d[-1])
    rate = np.float32(RDS_SYMBOL_RATE)
    # a true float32 division on every device (torch's CUDA division by a
    # host scalar multiplies by its reciprocal, which moves bit edges)
    t = torch.arange(n, dtype=torch.float32, device=device) / torch.tensor(
        np.float32(fs), device=device)
    tr = t * float(rate)
    k = torch.floor(tr).to(torch.int64)
    dd = torch.as_tensor(d.astype(np.int64), device=device)
    # the differential state continues across message repeats: repeat r
    # starts from the accumulated parity r·P, not from 0
    sym = (dd[torch.remainder(k, len(d))]
           ^ ((k // len(d)) * parity % 2)).to(torch.float32)
    half = (tr - k.to(torch.float32)) >= 0.5
    raw = (1.0 - 2.0 * sym) * torch.where(half, -1.0, 1.0)
    return (level * fir_filter_aligned(raw, rds_taps(fs))).to(torch.float32)


def stereo_mpx(left, right, fs, pilot_level: float = 0.09,
               audio_level: float = 0.9, rds=None,
               pilot_phase0: float = 0.0, device="cuda") -> torch.Tensor:
    """(…, n) left/right audio → (…, n) stereo composite on ``device``.
    ``rds`` is an optional pre-shaped baseband already at its injection
    level (see :func:`rds_manchester`'s ``level``)."""
    L = to_device(left, device, torch.float32)
    R = to_device(right, device, torch.float32)
    n = L.shape[-1]
    w = float(np.float32(TAU * FM_STEREO_PILOT_HZ / fs))
    k = torch.arange(1, n + 1, dtype=torch.float64, device=L.device)
    # float32(p0) + w·k, fused into one rounding as the JAX program does
    th = (float(np.float32(pilot_phase0)) + w * k).to(torch.float32)
    c1 = torch.polar(torch.ones_like(th), th)        # pilot phasor
    c2 = c1 * c1                                     # 38 kHz, coherent
    mono = 0.5 * (L + R)
    sub = 0.5 * (L - R)
    mpx = audio_level * (mono + sub * c2.real) + pilot_level * c1.real
    if rds is not None:
        c3 = c2 * c1                                 # 57 kHz
        mpx = mpx + to_device(rds, L.device, torch.float32) * c3.real
    return mpx.to(torch.float32)


def fm_stereo_mod(left, right, fs, deviation_hz: float = 75e3,
                  rds_bits=None, rds_level: float = 0.05, rf_hz: float = 0.0,
                  state: FmState | None = None, device="cuda"):
    """Broadcast-FM stereo transmitter: composite → FM phase accumulator →
    IQ. ``fs`` is both the audio/MPX and the IQ rate (≥ 120 kHz);
    ``rds_bits`` (e.g. from codec.rds.rds_encode_groups) ride at 57 kHz.
    Returns (iq, FmState)."""
    if fs < FM_STEREO_MIN_FS:
        raise ValueError(f"fm_stereo_mod needs fs ≥ {FM_STEREO_MIN_FS:.0f}"
                         f" for the 57 kHz composite, got {fs}")
    L = to_device(left, device, torch.float32)
    rds = None
    if rds_bits is not None and len(np.asarray(rds_bits)):
        rds = rds_manchester(rds_bits, fs, L.shape[-1], rds_level,
                             device=L.device)
    mpx = stereo_mpx(L, right, fs, rds=rds, device=L.device)
    return fm_mod(mpx, fs, deviation_hz, rf_hz=rf_hz, state=state,
                  device=L.device)
