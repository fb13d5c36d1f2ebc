"""Analog modulators: CW / AM / SSB / FM / PM (counterpart of
``orion_sdr_tpu/modulate/analog.py``; behavioral spec:
modulate/{cw,am,ssb,fm,pm}.rs).

Each modulator is a whole-capture function on torch tensors: phase
accumulators are cumulative sums, phasor recurrences exact phase ramps,
the SSB phasing filters parallel-scan biquad cascades, and the CW
envelope's two-rate one-pole runs through the hand-written kernel
(``ops/onepole_two_rate.py``). State is explicit and optional. Every entry
point takes host data or a tensor and ``device`` (default ``"cuda"``), and
returns tensors on it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.iir import biquad_init, design_butter_lp, lp_cascade
from ..dsp.osc import TAU, oscillator, rotate
from ..ops.onepole_two_rate import onepole_two_rate


class CwState(NamedTuple):
    env: torch.Tensor
    phase: torch.Tensor


def _zeros(lead, device):
    return torch.zeros(tuple(lead), dtype=torch.float32, device=device)


def cw_mod(key_env, fs, tone_hz, rise_ms=3.0, fall_ms=3.0, gain=1.0,
           state: CwState | None = None, device="cuda"):
    """Keyed carrier with rise/fall envelope shaping (modulate/cw.rs:10-44).
    ``key_env``: keying envelope in [0, 1]; the envelope one-pole takes the
    rise pole where the target is at or above it, else the fall pole."""
    x = torch.clamp(to_device(key_env, device, torch.float32), 0.0, 1.0)
    a_r = float(np.exp(-1.0 / (max(rise_ms, 0.1) * 1e-3 * fs)))
    a_f = float(np.exp(-1.0 / (max(fall_ms, 0.1) * 1e-3 * fs)))
    if state is None:
        state = CwState(env=_zeros(x.shape[:-1], x.device),
                        phase=_zeros(x.shape[:-1], x.device))
    env, env_last = onepole_two_rate(
        x, state.env.to(x.device, torch.float32).contiguous(), a_r, a_f,
        ge=True)
    iq, phase_out = rotate((env * gain).to(torch.complex64), tone_hz, fs,
                           state.phase.to(x.device))
    return iq, CwState(env=env_last, phase=phase_out)


def am_mod(audio, fs, rf_hz=0.0, carrier_level=1.0, modulation_index=1.0,
           gain=1.0, clamp=False, phase0=0.0, device="cuda"):
    """AM DSB: m = carrier_level + mi·x (clamped to [−1, 1] on request),
    mixed to rf_hz (modulate/am.rs:11-140). Returns (iq, rf_phase_out)."""
    x = to_device(audio, device, torch.float32)
    m = carrier_level + modulation_index * x
    if clamp:
        m = torch.clamp(m, -1.0, 1.0)
    return rotate((m * gain).to(torch.complex64), rf_hz, fs, phase0)


class SsbState(NamedTuple):
    lp_i: tuple  # (BiquadState, BiquadState)
    lp_q: tuple
    aud_phase: torch.Tensor
    rf_phase: torch.Tensor


def ssb_mod(audio, fs, audio_bw_hz, audio_if_hz, rf_hz=0.0, usb=True,
            state: SsbState | None = None, device="cuda"):
    """Phasing-method SSB (modulate/ssb.rs:10-140): audio mixed with an IF
    quadrature pair, each arm lowpassed at 0.9·BW by an LR4 cascade,
    recombined as I + j·(±Q), then translated to RF."""
    x = to_device(audio, device, torch.float32)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    lead = x.shape[:-1]
    if state is None:
        mk = lambda: (biquad_init(lead, device=x.device),
                      biquad_init(lead, device=x.device))
        state = SsbState(lp_i=mk(), lp_q=mk(),
                         aud_phase=_zeros(lead, x.device),
                         rf_phase=_zeros(lead, x.device))
    p, aud_phase = oscillator(audio_if_hz, fs, x.shape[-1], state.aud_phase,
                              device=x.device)
    side = 1.0 if usb else -1.0
    yi, lp_i = lp_cascade(x * p.real, c, state.lp_i)
    yq, lp_q = lp_cascade(x * p.imag, c, state.lp_q)
    iq, rf_phase = rotate(torch.complex(yi, side * yq), rf_hz, fs,
                          state.rf_phase)
    return iq, SsbState(lp_i=lp_i, lp_q=lp_q, aud_phase=aud_phase,
                        rf_phase=rf_phase)


class FmState(NamedTuple):
    phase: torch.Tensor
    rf_phase: torch.Tensor


def fm_mod(audio, fs, deviation_hz, rf_hz=0.0, gain=1.0,
           state: FmState | None = None, device="cuda"):
    """FM phase accumulator φ[n] = φ[n−1] + 2π·kf·x[n]/fs
    (modulate/fm.rs:12-90), as a cumulative sum."""
    x = to_device(audio, device, torch.float32)
    if state is None:
        state = FmState(phase=_zeros(x.shape[:-1], x.device),
                        rf_phase=_zeros(x.shape[:-1], x.device))
    kf = TAU * deviation_hz / fs
    phase = state.phase.to(x.device)[..., None] + torch.cumsum(kf * x, dim=-1)
    base = (gain * torch.polar(torch.ones_like(phase), phase)
            ).to(torch.complex64)
    iq, rf_phase = rotate(base, rf_hz, fs, state.rf_phase)
    return iq, FmState(phase=torch.remainder(phase[..., -1], TAU),
                       rf_phase=rf_phase)


def pm_mod(audio, fs, kp_rad_per_unit, rf_hz=0.0, gain=1.0, rf_phase0=0.0,
           device="cuda"):
    """PM: instantaneous phase φ = kp·x (modulate/pm.rs:10-60)."""
    x = to_device(audio, device, torch.float32)
    ph = kp_rad_per_unit * x
    base = (gain * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)
    return rotate(base, rf_hz, fs, rf_phase0)
