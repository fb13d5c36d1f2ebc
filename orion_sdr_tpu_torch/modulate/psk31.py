"""PSK31 modulators: BPSK31 / QPSK31 (counterpart of
``orion_sdr_tpu/modulate/psk31.py``; behavioral spec: modulate/psk31.rs).

31.25 baud, raised-cosine (α=1) pulse shaping by a Hann crossfade between
the previous and the current phasor, differential phase encoding (bit 0 =
phase change, bit 1 = no change); QPSK31 adds the rate-1/2 K=5 code. The
phasor sequence is a cumulative product over symbols on the host (exact
for the ±1/±j alphabet) and the crossfade one broadcast on the device:
    samples[k, n] = p[k−1]·(1 − h[n]) + p[k]·h[n].
:func:`crossfade_batch` takes a batch of phasor rows at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..codec.psk31 import DQPSK_EXP, conv_encode
from ..codec.varicode import encode_text
from ..dsp.device import to_device
from ..dsp.osc import rotate

PSK31_BAUD = 31.25
PSK31_SPS_8000 = 256
PSK31_SPS_12000 = 384
PSK31_PREAMBLE_BITS = 32
PSK31_POSTAMBLE_BITS = 32


def psk31_sps(fs: float) -> int:
    """Samples per PSK31 symbol at sample rate fs."""
    return int(round(fs / PSK31_BAUD))


def psk31_hann(sps: int) -> np.ndarray:
    """Half-cosine crossfade window h[n] = 0.5 − 0.5·cos(π·n/(sps−1))."""
    if sps == 0:
        return np.zeros(0, np.float32)
    if sps == 1:
        return np.ones(1, np.float32)
    n = np.arange(sps, dtype=np.float32)
    return (0.5 - 0.5 * np.cos(np.pi * n / (sps - 1))).astype(np.float32)


def crossfade_batch(phasors: torch.Tensor, phase0, sps: int,
                    gain: float = 1.0) -> torch.Tensor:
    """Pulse-shape (..., n_syms) complex64 phasor rows:
    out[..., k·sps + n] = g·(p[k−1]·(1 − h[n]) + p[k]·h[n]), p[−1] =
    ``phase0`` (a complex or a (...,) tensor)."""
    h = torch.as_tensor(psk31_hann(sps), device=phasors.device)
    p = phasors.to(torch.complex64)
    first = torch.broadcast_to(torch.as_tensor(
        phase0, dtype=torch.complex64, device=p.device), p.shape[:-1])
    prev = torch.cat([first[..., None], p[..., :-1]], dim=-1)
    seg = prev[..., None] * (1.0 - h) + p[..., None] * h
    return (gain * seg.reshape(p.shape[:-1] + (-1,))).to(torch.complex64)


def _crossfade(phasors, phase0, sps: int, gain: float, rf_hz: float = 0.0,
               fs: float = 0.0, device="cuda"):
    out = crossfade_batch(to_device(phasors, device, torch.complex64),
                          complex(phase0), sps, gain)
    if rf_hz != 0.0:
        out, _ = rotate(out, rf_hz, fs)
    return out


def bpsk31_mod_bits(bits, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    phase0: complex = 1.0 + 0.0j, device="cuda"):
    """Differential bits (0 = flip, 1 = hold) → IQ (n_bits·sps samples on
    ``device``). Returns (iq, final_phase) so streams continue."""
    b = np.asarray(bits, dtype=np.uint8) & 1
    sps = psk31_sps(fs)
    flips = np.cumsum(1 - b).astype(np.int64)
    phasors = (np.real(phase0) * np.where(flips % 2 == 1, -1.0, 1.0)
               ).astype(np.complex64)
    iq = _crossfade(phasors, complex(phase0), sps, gain, rf_hz, fs, device)
    final = complex(phasors[-1]) if len(b) else phase0
    return iq, final


def qpsk31_mod_bits(bits, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    phase0: complex = 1.0 + 0.0j, enc_sr: int = 0,
                    device="cuda"):
    """Info bits → conv encode → DQPSK crossfade IQ (n_bits·sps samples).
    Returns (iq, final_phase); ``enc_sr`` continues the encoder state."""
    coded = conv_encode(bits, enc_sr)
    dibits = (coded[0::2] * 2 + coded[1::2]).astype(np.int64)
    steps = DQPSK_EXP[dibits]
    phasors = ((phase0 * np.cumprod(steps)).astype(np.complex64)
               if len(dibits) else np.zeros(0, np.complex64))
    sps = psk31_sps(fs)
    iq = _crossfade(phasors, complex(phase0), sps, gain, rf_hz, fs, device)
    final = complex(phasors[-1]) if len(dibits) else phase0
    return iq, final


def bpsk31_mod_text(text, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    preamble_bits: int = PSK31_PREAMBLE_BITS,
                    postamble_bits: int = PSK31_POSTAMBLE_BITS,
                    device="cuda"):
    """Text → varicode → BPSK31 IQ (Bpsk31Mod::modulate_text)."""
    bits = encode_text(text, preamble_bits, postamble_bits)
    iq, _ = bpsk31_mod_bits(bits, fs, rf_hz, gain, device=device)
    return iq


def qpsk31_mod_text(text, fs: float, rf_hz: float = 0.0, gain: float = 1.0,
                    preamble_bits: int = PSK31_PREAMBLE_BITS,
                    postamble_bits: int = PSK31_POSTAMBLE_BITS,
                    device="cuda"):
    """Text → varicode → conv → QPSK31 IQ (Qpsk31Mod::modulate_text)."""
    bits = encode_text(text, preamble_bits, postamble_bits)
    iq, _ = qpsk31_mod_bits(bits, fs, rf_hz, gain, device=device)
    return iq


def bpsk31_mod_bits_batch(bits: torch.Tensor, fs: float,
                          gain: float = 1.0) -> torch.Tensor:
    """(..., n_bits) differential bits on a device → (..., n_bits·sps) IQ
    there, every row starting from phase 1: the batched DBPSK crossfade of
    the JAX bench's PSK31 roundtrip (bench.py:194-233)."""
    flips = torch.cumsum(1 - (bits.to(torch.int64) & 1), dim=-1)
    phasors = torch.where(flips % 2 == 1, -1.0, 1.0).to(torch.complex64)
    return crossfade_batch(phasors, 1.0, psk31_sps(fs), gain)
