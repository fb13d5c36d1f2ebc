"""RMS-tracking AGC (counterpart of ``orion_sdr_tpu/dsp/agc.py``; behavioral
spec: dsp/agc.rs).

The envelope one-pole switches its pole on x² > env (attack against
release): a recurrence whose coefficient depends on its state, so it has
no parallel prefix. With attack ≠ release it runs through the two-rate
one-pole kernel (``ops/onepole_two_rate.py``, one row a thread); with
attack == release it is linear and takes
:func:`~orion_sdr_tpu_torch.dsp.recurrence.first_order`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.onepole_two_rate import onepole_two_rate
from .device import on_device
from .recurrence import first_order


class AgcParams(NamedTuple):
    attack_a: float
    release_a: float
    target_rms: float
    min_gain: float = 0.05
    max_gain: float = 20.0


def design_agc(fs: float, attack_ms: float, release_ms: float,
               target_rms: float) -> AgcParams:
    a = lambda ms: float(np.exp(-1.0 / (fs * (max(ms, 1e-3) / 1000.0))))
    return AgcParams(a(attack_ms), a(release_ms), max(target_rms, 1e-6))


def _gain(env: torch.Tensor, p: AgcParams) -> torch.Tensor:
    rms = torch.clamp(torch.sqrt(env), min=1e-6)
    return torch.clamp(p.target_rms / rms, p.min_gain, p.max_gain)


def agc_rms(x, p: AgcParams, env0=None, device=None):
    """AGC over real audio or complex IQ (one real gain on I and Q).
    Returns (y, env_out). ``env0=None`` seeds the envelope from the first
    sample's power (agc.rs:57-62). Host data runs on ``device`` (None: the
    card)."""
    x = on_device(x, device)
    x2 = (x.abs() ** 2).to(torch.float32)
    if env0 is None:
        env0 = torch.clamp(x2[..., 0], min=1e-12)
    env0 = torch.as_tensor(env0, dtype=torch.float32, device=x.device)
    if p.attack_a == p.release_a:
        env, env_last = first_order(p.attack_a, (1.0 - p.attack_a) * x2,
                                    y0=env0)
    else:
        env, env_last = onepole_two_rate(
            x2, torch.broadcast_to(env0, x2.shape[:-1]).contiguous(),
            p.attack_a, p.release_a, ge=False)
    return x * _gain(env, p), env_last
