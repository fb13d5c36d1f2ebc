"""FM broadcast stereo receiver (pilot-tone system) with RDS (counterpart
of ``orion_sdr_tpu/demodulate/fm_stereo.py``).

RX chain: quadrature discriminator (exact ``atan2``) → MPX; the 19 kHz
pilot is lowpass-isolated at complex baseband and its unit phasor u = p/|p|
regenerates the 38 kHz (u²) and 57 kHz (u³) references, the same
power-of-one-phasor construction the TX uses, so ramp rounding cancels and
the difference channel demodulates coherently. Everything through the RDS
baseband runs on the IQ's device, the four long FIRs as one overlap-save
bank; RDS bit timing and group decode run on the host (text-rate work, in
numpy as the JAX package runs them).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..codec.rds import RDS_SYMBOL_RATE, rds_decode_bits
from ..dsp.device import to_device
from ..dsp.fir import (fir_filter_aligned_bank, kaiser_lowpass_taps,
                       kaiser_num_taps)
from ..dsp.osc import TAU
from ..dsp.recurrence import first_order
from ..modulate.fm_stereo import FM_STEREO_MIN_FS, FM_STEREO_PILOT_HZ, \
    rds_taps
from ..util import spectrum_scan
from .analog import channelize_all, delay_conj_product, wideband_capture


class FmStereoAudio(NamedTuple):
    """Stereo receive result. ``pilot_level`` is the recovered 19 kHz pilot
    amplitude relative to full-scale MPX (TX default 0.09; ≈ 0 on a mono
    signal). ``rds`` is a codec.rds.RdsData when ``decode_rds=True``."""
    left: torch.Tensor
    right: torch.Tensor
    mono: torch.Tensor
    pilot_level: object
    rds: Optional[object]
    rds_bits: Optional[object]


def _stereo_device(re: torch.Tensor, im: torch.Tensor, fs: float,
                   deviation_hz: float, audio_bw_hz: float,
                   audio_level: float, want_rds: bool):
    """Discriminator → pilot phasor → coherent mono/difference (and the
    RDS baseband, already real). Returns (mono, sub, pilot_mag, rds_bb)."""
    z = torch.complex(re, im)
    prod = delay_conj_product(z, torch.ones_like(z[..., 0]))
    mpx = (torch.atan2(prod.imag, prod.real)
           * float(np.float32(fs / (TAU * deviation_hz)))).to(torch.float32)
    n = mpx.shape[-1]
    w = float(np.float32(TAU * FM_STEREO_PILOT_HZ / fs))
    k = torch.arange(1, n + 1, dtype=torch.float32, device=z.device)
    ph = -(w * k)
    e1 = torch.polar(torch.ones_like(ph), ph)
    pil_taps = kaiser_lowpass_taps(kaiser_num_taps(900.0 / fs, 60.0),
                                   500.0 / fs, 60.0)
    aud_taps = kaiser_lowpass_taps(kaiser_num_taps(5000.0 / fs, 60.0),
                                   (audio_bw_hz + 1000.0) / fs, 60.0)
    e2 = e1 * e1
    pairs = [(mpx * e1, pil_taps), (mpx, aud_taps), (mpx * e2, aud_taps)]
    if want_rds:
        pairs.append((mpx * (e2 * e1), rds_taps(fs)))
    outs = fir_filter_aligned_bank(pairs)
    p, mono, v = outs[0], outs[1] / audio_level, outs[2]
    u = p / torch.clamp(p.abs(), min=1e-12)
    pilot_mag = 2.0 * p.abs().mean(dim=-1)
    sub = 2.0 * (v * (u * u).conj()).real / audio_level
    if want_rds:
        rbb = 2.0 * (outs[3] * (u * u * u).conj()).real
    else:
        rbb = torch.zeros_like(mono)
    return (mono.to(torch.float32), sub.to(torch.float32),
            pilot_mag.to(torch.float32), rbb.to(torch.float32))


def _rds_bits_from_baseband(rbb: np.ndarray, fs: float) -> np.ndarray:
    """Manchester baseband → bits: half-bit integrate-and-dump with a
    timing-offset search (the aligned offset maximizes |first − second|
    half energy), then differential decode (host numpy)."""
    sps = fs / RDS_SYMBOL_RATE
    n_bits = int(len(rbb) / sps) - 2
    if n_bits < 8:
        return np.zeros(0, np.uint8)
    t_idx = np.arange(len(rbb))
    best = None
    for off in np.arange(0.0, sps, sps / 16.0):
        # floor, not truncation: pre-offset samples land at k = −1 and
        # fail the valid gate instead of pouring into bit 0
        k = np.floor((t_idx - off) / sps).astype(np.int64)
        half = ((t_idx - off) / sps - k) >= 0.5
        valid = (k >= 0) & (k < n_bits)
        first = np.bincount(k[valid & ~half], rbb[valid & ~half],
                            minlength=n_bits)
        second = np.bincount(k[valid & half], rbb[valid & half],
                             minlength=n_bits)
        diff = first - second
        score = float(np.mean(np.abs(diff)))
        if best is None or score > best[0]:
            best = (score, diff)
    d = (best[1] < 0).astype(np.uint8)        # symbol = differential bit d_i
    return d[1:] ^ d[:-1]                     # b_i = d_i ^ d_{i-1}


def _de_emphasis(x: torch.Tensor, a: float) -> torch.Tensor:
    return first_order(a, (1.0 - a) * x)[0]


def fm_stereo_demod(iq, fs, deviation_hz: float = 75e3,
                    audio_bw_hz: float = 15e3, de_emphasis_us: float = 0.0,
                    audio_level: float = 0.9, decode_rds: bool = False,
                    device="cuda") -> FmStereoAudio:
    """Broadcast-FM stereo receive: (…, n) IQ at ``fs`` (≥ 120 kHz, the
    composite rate) → left/right audio at the same rate on ``device``,
    the pilot level, optional RDS text. Batched leading dims demodulate
    together; RDS group decode runs per channel on the host."""
    if fs < FM_STEREO_MIN_FS:
        raise ValueError(f"fm_stereo_demod needs fs ≥ {FM_STEREO_MIN_FS:.0f},"
                         f" got {fs}")
    z = to_device(iq, device, torch.complex64)
    mono, sub, pilot_mag, rbb = _stereo_device(
        z.real.contiguous(), z.imag.contiguous(), float(fs),
        float(deviation_hz), float(audio_bw_hz), float(audio_level),
        bool(decode_rds))
    left = mono + sub
    right = mono - sub
    if de_emphasis_us > 0.0:
        a = float(np.exp(-1.0 / (fs * de_emphasis_us * 1e-6)))
        left, right, mono = (_de_emphasis(x, a) for x in (left, right, mono))
    rds_data, rds_bits = None, None
    if decode_rds:
        rows = rbb.reshape(-1, rbb.shape[-1]).cpu().numpy()
        rds_bits = [_rds_bits_from_baseband(r, fs) for r in rows]
        rds_data = [rds_decode_bits(b) for b in rds_bits]
        if z.dim() == 1:
            rds_bits, rds_data = rds_bits[0], rds_data[0]
    return FmStereoAudio(left=left, right=right, mono=mono,
                         pilot_level=(float(pilot_mag) if z.dim() == 1
                                      else pilot_mag),
                         rds=rds_data, rds_bits=rds_bits)


class FmStation(NamedTuple):
    """One broadcast station recovered by :func:`fm_band_demod`."""
    center_hz: float
    audio: FmStereoAudio


def fm_band_demod(iq, fs, stations_hz=None, deviation_hz: float = 75e3,
                  de_emphasis_us: float = 0.0, decode_rds: bool = False,
                  scan_threshold_db: float = 10.0,
                  min_station_bw_hz: float = 100e3, device="cuda") -> list:
    """Whole-band FM broadcast receive: scan (or take) station centers,
    channelize every station out of the wideband capture as one batch,
    stereo-demodulate them together. ``stations_hz``: offsets from the
    capture center; None = a blind ``spectrum_scan`` keeping segments
    wider than ``min_station_bw_hz`` (strongest first). Audio comes back
    at the channel rate fs/m (m chosen so it lands in [240k, 480k))."""
    z = wideband_capture(iq, device, "fm_band_demod")
    if stations_hz is None:
        segs = spectrum_scan(z, fs, threshold_db=scan_threshold_db,
                             min_bw_hz=min_station_bw_hz, device=z.device)
        stations_hz = [s.center_hz for s in segs]
    stations_hz = list(stations_hz)
    if not stations_hz:
        return []
    m = max(1, int(fs // 240_000.0))
    ch_fs = fs / m
    if ch_fs < FM_STEREO_MIN_FS:
        raise ValueError(f"capture rate {fs} too low for the 57 kHz "
                         f"composite (channel rate {ch_fs:.0f})")
    chans = channelize_all(z, fs, ch_fs, stations_hz, 60_000.0)
    out = fm_stereo_demod(chans, ch_fs, deviation_hz=deviation_hz,
                          de_emphasis_us=de_emphasis_us,
                          decode_rds=decode_rds, device=z.device)
    levels = out.pilot_level.cpu().numpy()
    return [FmStation(center_hz=float(c_hz), audio=FmStereoAudio(
        left=out.left[i], right=out.right[i], mono=out.mono[i],
        pilot_level=float(levels[i]),
        rds=(out.rds[i] if decode_rds else None),
        rds_bits=(out.rds_bits[i] if decode_rds else None)))
        for i, c_hz in enumerate(stations_hz)]
