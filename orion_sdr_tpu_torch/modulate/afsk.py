"""AFSK-1200 (Bell 202) and RTTY transmitters over one 2-FSK tone engine
(counterpart of ``orion_sdr_tpu/modulate/afsk.py``): NRZI-encoded HDLC
bits select 1200 Hz (mark) / 2200 Hz (space) at 1200 baud, RTTY's async
line states the 2125/2295 Hz pair at 45.45 baud. The whole burst is one
phase accumulator (a cumulative sum of float32 steps, summed in float64
and rounded once), continuous across tone switches. Every entry point
takes host data or a tensor and ``device`` (default ``"cuda"``), and
returns tensors on it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.device import to_device
from ..dsp.osc import TAU

AFSK_BAUD = 1200.0
AFSK_MARK_HZ = 1200.0
AFSK_SPACE_HZ = 2200.0


def nrzi_encode(bits) -> np.ndarray:
    """HDLC NRZI: a 0 toggles the line state, a 1 holds it. Returns the
    per-bit line state (starting from state 1)."""
    b = np.asarray(bits, np.uint8) & 1
    toggles = np.cumsum(1 - b) % 2
    return (1 ^ toggles).astype(np.uint8)


def nrzi_decode(states) -> np.ndarray:
    """Per-bit line states → bits (1 = no transition). The first bit
    assumes a preceding state of ``states[0]`` (flag hunting absorbs it)."""
    s = np.asarray(states, np.uint8) & 1
    prev = np.concatenate([s[:1], s[:-1]])
    return (s == prev).astype(np.uint8)


def bit_index(n: int, sps: float, n_bits: int, device) -> torch.Tensor:
    """The symbol each of ``n`` samples belongs to: min(floor(i / sps),
    n_bits − 1), with i / sps a float32 division."""
    t = torch.arange(n, dtype=torch.float32, device=device)
    k = torch.floor(t / torch.tensor(np.float32(sps), device=device))
    return torch.clamp(k.to(torch.int64), max=n_bits - 1)


def phase_accumulate(step: torch.Tensor) -> torch.Tensor:
    """The running phase of float32 steps: summed in float64, rounded to
    float32 once."""
    return torch.cumsum(step.double(), dim=-1).to(torch.float32)


def fsk2_tones(line, fs: float, sps: float, amplitude: float, n: int,
               mark_hz: float = AFSK_MARK_HZ,
               space_hz: float = AFSK_SPACE_HZ, device="cuda"):
    """Per-bit line states (1 = mark) → continuous-phase 2-FSK audio of
    ``n`` float32 samples: the tone engine AFSK-1200 and RTTY share."""
    line = to_device(line, device)
    sel = line[..., bit_index(n, sps, line.shape[-1], line.device)]
    freq = torch.where(sel == 1, float(np.float32(mark_hz)),
                       float(np.float32(space_hz))).to(torch.float32)
    phase = phase_accumulate(float(np.float32(TAU / fs)) * freq)
    return (amplitude * torch.sin(phase)).to(torch.float32)


def afsk1200_mod(bits, fs: float, amplitude: float = 0.8, device="cuda"):
    """HDLC bit stream (pre-NRZI, e.g. from codec.ax25.hdlc_encode) →
    AFSK-1200 audio at ``fs``, continuous phase across tone switches."""
    if fs < 2.5 * AFSK_SPACE_HZ:
        raise ValueError(f"fs must exceed {2.5 * AFSK_SPACE_HZ:.0f} Hz")
    line = nrzi_encode(bits)
    sps = fs / AFSK_BAUD
    n = int(round(len(line) * sps))
    return fsk2_tones(line, float(fs), float(sps), float(amplitude), n,
                      device=device)


def ax25_beacon(frames, fs: float, amplitude: float = 0.8, device="cuda"):
    """AX.25 frames → one AFSK-1200 audio burst (the TNC transmit path)."""
    from ..codec.ax25 import hdlc_encode
    encoded = [f.encode() if hasattr(f, "encode") else bytes(f)
               for f in frames]
    return afsk1200_mod(hdlc_encode(encoded), fs, amplitude, device)


def rtty_mod(text: str, fs: float, baud: float = 45.45,
             mark_hz: float = 2125.0, space_hz: float = 2295.0,
             amplitude: float = 0.8, device="cuda"):
    """RTTY transmit: text → Baudot/ITA2 → async start/stop framing →
    45.45-baud 2-FSK audio at the 2125/2295 Hz pair."""
    from ..codec.rtty import baudot_encode, rtty_frame_bits
    if fs < 2.5 * max(mark_hz, space_hz):
        raise ValueError(f"fs too low for the {mark_hz}/{space_hz} Hz pair")
    line = rtty_frame_bits(baudot_encode(text))
    sps = fs / baud
    n = int(round(len(line) * sps))
    return fsk2_tones(line, float(fs), float(sps), float(amplitude), n,
                      float(mark_hz), float(space_hz), device)
