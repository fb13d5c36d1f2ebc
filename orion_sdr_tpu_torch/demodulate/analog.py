"""Analog demodulators: CW / AM / SSB / FM / PM (counterpart of
``orion_sdr_tpu/demodulate/analog.py``; behavioral spec:
demodulate/{cw,am,ssb,fm,pm}.rs).

Every per-sample IIR loop is a parallel scan or a chunked matmul
(``dsp/iir.py``); the quadrature discriminators are one elementwise pass
(delay-conjugate product, then :func:`~orion_sdr_tpu_torch.util.atan2_approx`).
Every entry point takes host data or a tensor and ``device`` (default
``"cuda"``), and returns tensors on it. The band receivers
(``am_band_demod``, ``ssb_band_demod``) channelize every station out of
one wideband capture (``dsp/channelizer.py``) and demodulate the channel
batch together.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dsp.channelizer import Channelizer
from ..dsp.device import to_device
from ..dsp.fir import convolve, kaiser_lowpass_taps, kaiser_num_taps
from ..dsp.iir import (LpDcState, biquad_init, dc_pole, design_butter_lp,
                       lp_cascade, lp_dc_cascade)
from ..dsp.osc import mix_usb, rotate
from ..dsp.recurrence import first_order
from ..util import atan2_approx, spectrum_scan


def cw_demod(iq, fs, env_bw_hz=300.0, gain=1.0, y0=0.0, device="cuda"):
    """Envelope detector: |z| through a one-pole lowpass
    (demodulate/cw.rs:8-50). Returns (audio, lp_state)."""
    z = to_device(iq, device)
    mag = z.abs().to(torch.float32)
    a = float(np.exp(-2.0 * np.pi * max(env_bw_hz, 1.0) / fs))
    y, y_last = first_order(a, (1.0 - a) * mag, y0=y0)
    return gain * y, y_last


def cw_envelope_multi(iq, fs, carriers_hz, env_bw_hz=100.0,
                      env_rate_hz=1000.0, device="cuda"):
    """K keying envelopes from one capture: rotate it to every carrier at
    once, lowpass the complex rows (Kaiser, 60 dB one env_bw out) before
    the magnitude, box-average down to ``env_rate_hz``. Returns (K, n_env)
    float32 envelopes."""
    z = to_device(iq, device)
    f = to_device(carriers_hz, z.device, torch.float32).reshape(-1)
    m = max(int(round(fs / max(env_rate_hz, 1.0))), 1)
    k = f.shape[0]
    if z.shape[-1] < m or k == 0:
        return torch.zeros((k, 0), dtype=torch.float32, device=z.device)
    zb, _ = rotate(z[None, :], -f[:, None], fs)              # (K, n)
    nt = kaiser_num_taps(env_bw_hz / fs, 60.0)
    taps = kaiser_lowpass_taps(nt, env_bw_hz / fs, 60.0)
    mag = convolve(zb, taps, "same").abs().to(torch.float32)
    n_env = mag.shape[-1] // m
    return mag[:, :n_env * m].reshape(k, n_env, m).mean(dim=-1)


def am_demod(iq, fs, audio_bw_hz, method="power_sqrt",
             abs_k=(0.947543636291, 0.392485425092),
             state: LpDcState | None = None, device="cuda"):
    """AM envelope demod (demodulate/am.rs:9-46). ``power_sqrt``: LP4(|z|²)
    → sqrt → DC block; ``abs_approx``: k1·|I| + k2·|Q| → LP4 → DC block."""
    z = to_device(iq, device)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    r = dc_pole(fs, 2.0)
    if method == "power_sqrt":
        p = (z.real * z.real + z.imag * z.imag).to(torch.float32)
        return lp_dc_cascade(p, c, r, state=state,
                             map_fn=lambda v: torch.sqrt(torch.clamp(v,
                                                                     min=0.0)))
    k1, k2 = abs_k
    e = (k1 * z.real.abs() + k2 * z.imag.abs()).to(torch.float32)
    return lp_dc_cascade(e, c, r, state=state)


class AmStation(NamedTuple):
    """One AM transmission recovered by :func:`am_band_demod`."""
    center_hz: float
    audio: torch.Tensor
    carrier_level: float
    fs_audio: float


def channelize_all(iq: torch.Tensor, fs: float, ch_fs: float, centers_hz,
                   passband_hz: float) -> torch.Tensor:
    """Every center of ``centers_hz`` out of one capture (push and flush of
    a :class:`Channelizer` on the capture's device) → (C, n) channels."""
    chan = Channelizer(fs, ch_fs, centers_hz, passband_hz=passband_hz,
                       device=iq.device)
    parts = [p for p in (chan.push(iq), chan.flush()) if p.shape[-1]]
    return torch.cat(parts, dim=-1)


def wideband_capture(iq, device, what: str) -> torch.Tensor:
    """A band receiver's input: one 1-D complex64 capture on ``device``."""
    z = to_device(iq, device, torch.complex64)
    if z.dim() != 1:
        raise ValueError(f"{what} takes a 1-D wideband capture")
    return z


def am_band_demod(iq, fs, stations_hz=None, audio_bw_hz: float = 5000.0,
                  method: str = "power_sqrt",
                  scan_threshold_db: float = 10.0,
                  min_station_bw_hz: float = 2000.0, device="cuda") -> list:
    """Whole-band AM receive: scan (or take) carrier centers, channelize
    every station out of the wideband capture in one batch, envelope-
    demodulate them together. Returns [AmStation] with audio at fs/m (m
    chosen so the channel rate lands just above 4·audio_bw); stations
    whose mean channel magnitude is under 3 % of the strongest (leakage
    skirts a blind scan can surface) are dropped."""
    z = wideband_capture(iq, device, "am_band_demod")
    if stations_hz is None:
        segs = spectrum_scan(z, fs, threshold_db=scan_threshold_db,
                             min_bw_hz=min_station_bw_hz, device=z.device)
        stations_hz = [s.center_hz for s in segs]
    stations_hz = list(stations_hz)
    if not stations_hz:
        return []
    m = max(1, int(fs // (4.0 * audio_bw_hz)))
    ch_fs = fs / m
    chans = channelize_all(z, fs, ch_fs, stations_hz, audio_bw_hz * 1.2)
    audio, _ = am_demod(chans, ch_fs, audio_bw_hz, method=method,
                        device=z.device)
    levels = chans.abs().mean(dim=-1).cpu().numpy()
    gate = 0.03 * float(levels.max())
    return [AmStation(center_hz=float(c), audio=audio[i],
                      carrier_level=float(levels[i]), fs_audio=ch_fs)
            for i, c in enumerate(stations_hz) if levels[i] >= gate]


class SsbStation(NamedTuple):
    """One SSB transmission recovered by :func:`ssb_band_demod`."""
    center_hz: float
    audio: torch.Tensor
    fs_audio: float


def ssb_band_demod(iq, fs, stations_hz, audio_bw_hz: float = 2700.0,
                   audio_if_hz: float = 1500.0, usb: bool = True,
                   device="cuda") -> list:
    """Whole-band SSB receive of the dial (suppressed-carrier) frequencies
    ``stations_hz``: channelize each sideband's middle in one batch, then
    product-detect the channels together (an LSB channel conjugates into
    USB). ``audio_if_hz``/``usb`` follow ``ssb_mod``'s conventions. Audio
    at fs/m (m near 4·audio_bw)."""
    z = wideband_capture(iq, device, "ssb_band_demod")
    stations_hz = list(stations_hz)
    if not stations_hz:
        return []
    m = max(1, int(fs // (4.0 * audio_bw_hz)))
    ch_fs = fs / m
    # a USB signal occupies [dial+if, dial+if+bw]: center the channel on
    # the middle of that sideband (mirrored for LSB)
    half = audio_if_hz + audio_bw_hz / 2.0
    offs = half if usb else -half
    chans = channelize_all(z, fs, ch_fs, [c + offs for c in stations_hz],
                           audio_bw_hz * 0.7)
    if not usb:
        chans = chans.conj()
    # in-channel the audio tone f sits at if + f − offs ⇒ BFO = if − offs
    audio, _ = ssb_demod(chans, ch_fs, bfo_hz=audio_if_hz - abs(offs),
                         audio_bw_hz=audio_bw_hz, device=z.device)
    return [SsbStation(center_hz=float(c), audio=audio[i], fs_audio=ch_fs)
            for i, c in enumerate(stations_hz)]


class SsbDemodState(NamedTuple):
    filt: LpDcState
    bfo_phase: torch.Tensor


def ssb_demod(iq, fs, bfo_hz, audio_bw_hz, state: SsbDemodState | None = None,
              device="cuda"):
    """Product detector I·cos + Q·sin with a BFO, then LP + DC
    (demodulate/ssb.rs:9-70)."""
    z = to_device(iq, device)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    r = dc_pole(fs, 2.0)
    phase0 = state.bfo_phase if state is not None else 0.0
    y, bfo_phase = mix_usb(z, bfo_hz, fs, phase0)
    audio, filt = lp_dc_cascade(y, c, r, state=state.filt
                                if state is not None else None)
    return audio, SsbDemodState(filt=filt, bfo_phase=bfo_phase)


class QuadDemodState(NamedTuple):
    prev: torch.Tensor      # previous complex sample
    lp: tuple               # (BiquadState, BiquadState) LP cascade state
    xlate_phase: torch.Tensor


def _quad_init(lead, device) -> QuadDemodState:
    lead = tuple(lead)
    return QuadDemodState(
        prev=torch.ones(lead, dtype=torch.complex64, device=device),
        lp=(biquad_init(lead, device=device), biquad_init(lead, device=device)),
        xlate_phase=torch.zeros(lead, dtype=torch.float32, device=device))


def delay_conj_product(z: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """z[i]·conj(z[i−1]) with z[−1] = ``prev``."""
    zprev = torch.cat([prev[..., None].to(z.dtype), z[..., :-1]], dim=-1)
    return z * zprev.conj()


def fm_demod(iq, fs, deviation_hz, audio_bw_hz, translate_hz=None,
             state: QuadDemodState | None = None, device="cuda"):
    """Quadrature discriminator: angle(z·conj(z₋₁))/dev → LP4
    (demodulate/fm.rs:12-90). Returns (audio, state)."""
    z = to_device(iq, device, torch.complex64)
    if state is None:
        state = _quad_init(z.shape[:-1], z.device)
    if z.shape[-1] == 0:
        return torch.zeros(z.shape[:-1] + (0,), dtype=torch.float32,
                           device=z.device), state
    xlate_phase = state.xlate_phase
    if translate_hz is not None:
        z, xlate_phase = rotate(z, -translate_hz, fs, xlate_phase)
    k = 1.0 / max(deviation_hz, 1.0)
    prod = delay_conj_product(z, state.prev)
    disc = atan2_approx(prod.imag, prod.real) * k
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    audio, lp = lp_cascade(disc, c, state.lp)
    return audio, QuadDemodState(prev=z[..., -1], lp=lp,
                                 xlate_phase=xlate_phase)


def pm_demod(iq, fs, k, audio_bw_hz, state: QuadDemodState | None = None,
             device="cuda"):
    """PM by phase difference (demodulate/pm.rs:12-80). Returns (audio,
    state)."""
    z = to_device(iq, device, torch.complex64)
    if state is None:
        state = _quad_init(z.shape[:-1], z.device)
    if z.shape[-1] == 0:
        return torch.zeros(z.shape[:-1] + (0,), dtype=torch.float32,
                           device=z.device), state
    prod = delay_conj_product(z, state.prev)
    disc = k * atan2_approx(prod.imag, prod.real)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    audio, lp = lp_cascade(disc, c, state.lp)
    return audio, QuadDemodState(prev=z[..., -1], lp=lp,
                                 xlate_phase=state.xlate_phase)
