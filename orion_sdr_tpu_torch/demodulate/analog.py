"""Analog demodulators: CW / AM / SSB / FM / PM (counterpart of
``orion_sdr_tpu/demodulate/analog.py``; behavioral spec:
demodulate/{cw,am,ssb,fm,pm}.rs).

Every per-sample IIR loop is a parallel scan or a chunked matmul
(``dsp/iir.py``); the quadrature discriminators are one elementwise pass
(delay-conjugate product, then :func:`~orion_sdr_tpu_torch.util.atan2_approx`).
Every entry point takes host data or a tensor and ``device`` (default
``"cuda"``), and returns tensors on it. The band receivers
(``am_band_demod``, ``ssb_band_demod``) need the channelizer and raise
until it is ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.fir import convolve, kaiser_lowpass_taps, kaiser_num_taps
from ..dsp.iir import (LpDcState, biquad_init, dc_pole, design_butter_lp,
                       lp_cascade, lp_dc_cascade)
from ..dsp.osc import mix_usb, rotate
from ..dsp.recurrence import first_order
from ..unported import CHANNELIZER, not_ported
from ..util import atan2_approx


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


def am_band_demod(*args, **kwargs):
    """Whole-band AM receive; needs the channelizer (not in the port yet)."""
    raise not_ported("am_band_demod", CHANNELIZER)


def ssb_band_demod(*args, **kwargs):
    """Whole-band SSB receive; needs the channelizer (not in the port yet)."""
    raise not_ported("ssb_band_demod", CHANNELIZER)


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
